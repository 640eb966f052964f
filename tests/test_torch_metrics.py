"""The port's metric stack against the JAX package's, on the CPU.

  * The copies equal their originals: FeatureStats (appends, truncation,
    merge, replica_max_items), frechet_distance (both methods and the
    non-finite guard), _cache_tag, the stub detector, MetricOptions' fields
    (the port's G is a torch Generator on `device`, which replaces
    G_variables and mesh), the registry's names and report_metric's rows.
  * Dataset stats with the stub detector equal JAX's to the bit, through one
    reader thread (the dataset's RNG is shared with the reader threads), and
    land in the same cache file.
  * Generator stats replay JAX's draws (`JaxGenDraws`: its split / fold_in
    keys) through a small G carried by the bridge: the uint8 frames agree but
    for rounding at a quantisation edge.
  * compute_fvd in the fvd2048_16f and fvd2048_128f_subsample8f shapes at
    tiny counts, with a random I3D at native resolution carried by the bridge,
    and compute_kid and compute_is with np.random seeded, agree with JAX to
    REL.
  * A reference file under a canonical name loads into the port's module;
    any other runs as TorchScript.
  * More than one replica raises, and so does a metric without a card that
    was not asked to run on the CPU.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylegan_v_tpu.metrics import metric_main as jmm
from stylegan_v_tpu.metrics import metric_utils as jmu
from stylegan_v_tpu.metrics.detectors_flax import i3d as ji3d
from stylegan_v_tpu.metrics.frechet_inception_distance import frechet_distance as jfd
from stylegan_v_tpu.metrics.frechet_video_distance import compute_fvd as jcompute_fvd
from stylegan_v_tpu.metrics.inception_score import compute_is as jcompute_is
from stylegan_v_tpu.metrics.kernel_inception_distance import compute_kid as jcompute_kid
from stylegan_v_tpu.models import Generator as JGenerator
from stylegan_v_tpu.models.motion import MotionMappingNetwork as JMotion
from stylegan_v_tpu_torch.io import jax_to_torch_generator, jax_to_torch_i3d
from stylegan_v_tpu_torch.metrics import metric_main as tmm
from stylegan_v_tpu_torch.metrics import metric_utils as tmu
from stylegan_v_tpu_torch.metrics.detectors import i3d as ti3d
from stylegan_v_tpu_torch.metrics.frechet_inception_distance import frechet_distance as tfd
from stylegan_v_tpu_torch.metrics.frechet_video_distance import compute_fvd as tcompute_fvd
from stylegan_v_tpu_torch.metrics.inception_score import compute_is as tcompute_is
from stylegan_v_tpu_torch.metrics.kernel_inception_distance import compute_kid as tcompute_kid
from stylegan_v_tpu_torch.models import Generator
from test_data import SAMPLING, build_video_dataset_dir
from test_torch_detectors import random_variables
from test_torch_models import port_cfg, small_gen_cfg

REL = 1e-3      # metric values: float32 features through float64 moments
CANONICAL = {"fid50k_full", "kid50k_full", "is50k", "fvd2048_16f", "fvd2048_128f",
             "fvd2048_128f_subsample8f", "isv2048_ucf", "fid50k", "kid50k"}


# ------------------------------------------------------------------ copies

def stats_pair(**kw):
    return jmu.FeatureStats(**kw), tmu.FeatureStats(**kw)


def assert_stats_equal(got, want):
    for k in ("capture_all", "capture_mean_cov", "max_items", "num_items", "num_features"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("raw_mean", "raw_cov"):
        if getattr(want, k) is not None:
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    if want.capture_all and want.num_items:
        np.testing.assert_array_equal(got.get_all(), want.get_all())


@pytest.mark.parametrize("max_items", [None, 10, 7])
def test_feature_stats_equal_the_jax_package(max_items):
    x = np.random.RandomState(0).randn(23, 5) * 3
    want, got = stats_pair(capture_all=True, capture_mean_cov=True, max_items=max_items)
    for chunk in np.array_split(x, 5):
        want.append(chunk)
        got.append(chunk)
        assert got.is_full() == want.is_full()
    assert_stats_equal(got, want)
    for a, b in zip(got.get_mean_cov(), want.get_mean_cov()):
        np.testing.assert_array_equal(a, b)


def test_feature_stats_merge_and_replica_max_items_equal_the_jax_package():
    for total in (0, 1, 7, 12):
        for R in (1, 3, 4):
            assert [tmu.FeatureStats.replica_max_items(total, R, r) for r in range(R)] == \
                [jmu.FeatureStats.replica_max_items(total, R, r) for r in range(R)]
    x = np.random.RandomState(1).randn(11, 4)
    parts = []
    for mod in (jmu, tmu):
        stats = [mod.FeatureStats(capture_all=True, capture_mean_cov=True) for _ in range(3)]
        for r, s in enumerate(stats):
            s.append(x[r::3])
        parts.append(mod.FeatureStats.merge(stats))
    assert_stats_equal(parts[1], parts[0])
    np.testing.assert_array_equal(parts[1].get_all(), x.astype(np.float32))


def test_frechet_distance_equals_the_jax_package():
    rng = np.random.RandomState(3)
    for n_items in (300, 40):                    # full rank / rank-deficient
        X, Y = rng.randn(n_items, 64), rng.randn(n_items, 64) * 1.3 + 0.2
        args = (X.mean(0), np.cov(X, rowvar=False, bias=True),
                Y.mean(0), np.cov(Y, rowvar=False, bias=True))
        for method in ("eigh", "sqrtm"):
            assert tfd(*args, method=method) == jfd(*args, method=method)
    mu, sigma = np.zeros(8), np.eye(8)
    bad = sigma.copy()
    bad[0, 0] = np.nan
    for args in ((mu, bad, mu, sigma), (mu + np.inf, sigma, mu, sigma)):
        assert tfd(*args) == jfd(*args) == float("inf")


def test_cache_tag_stub_and_options_equal_the_jax_package():
    cases = [({"path": "/d/ffs.zip", "sampling": SAMPLING, "xflip": True}, "i3d", {},
              {"max_items": 5, "backend": "real"}),
             ({"path": "x"}, "inception", {"capture_all": True}, {})]
    for args in cases:
        assert tmu._cache_tag(tmu.MetricOptions(), *args) == \
            jmu._cache_tag(jmu.MetricOptions(), *args)
    videos = np.random.RandomState(4).randint(0, 256, (2, 3, 16, 12, 3)).astype(np.uint8)
    for x in (videos, videos[:, 0]):
        np.testing.assert_array_equal(tmu._stub_detector("i3d")(x), jmu._stub_detector("i3d")(x))
    want = {f.name: f.default for f in dataclasses.fields(jmu.MetricOptions)
            if f.name not in ("G_variables", "mesh")}
    got = {f.name: f.default for f in dataclasses.fields(tmu.MetricOptions)}
    assert got.pop("device") is None and got == want
    assert tmu.DETECTOR_FILES == jmu.DETECTOR_FILES


def test_registry_and_report_rows_equal_the_jax_package(tmp_path):
    assert set(tmm.list_valid_metrics()) == CANONICAL <= set(jmm.list_valid_metrics())
    result = dict(metric="fvd2048_16f", results={"fvd2048_16f": 12.5}, total_time=1.0,
                  num_runs=1)
    for mm, sub in ((jmm, "jax"), (tmm, "torch")):
        mm.report_metric(result, run_dir=str(tmp_path / sub), snapshot_nimg=5000)
    rows = [json.loads(open(tmp_path / sub / "metric-fvd2048_16f.jsonl").read())
            for sub in ("jax", "torch")]
    assert all(isinstance(r.pop("timestamp"), float) for r in rows)
    assert rows[1] == rows[0] and rows[1]["snapshot"] == "network-snapshot-000005"


# ------------------------------------------------------------------ stats

@pytest.fixture(scope="module")
def ds_path(tmp_path_factory):
    """4 videos of 128 frames at 16^2: enough for fvd2048_128f_subsample8f."""
    return build_video_dataset_dir(str(tmp_path_factory.mktemp("metrics")), num_videos=4,
                                   frames_per_video=128, res=16)


def dataset_kwargs(path):
    return dict(path=path, sampling=SAMPLING, max_num_frames=128)


@pytest.fixture
def one_reader(monkeypatch):
    """One reader thread in both packages: the dataset's RNG (random
    consecutive offsets) is shared with the threads."""
    for mod in (jmu, tmu):
        monkeypatch.setattr(mod, "_iter_items_threaded",
                            functools.partial(mod._iter_items_threaded, num_workers=1))


@pytest.mark.parametrize("kind", ["video", "image"])
def test_dataset_stats_with_the_stub_equal_the_jax_package(ds_path, tmp_path, monkeypatch,
                                                           one_reader, kind):
    monkeypatch.setenv("SGV_STUB_DETECTORS", "1")
    kw = (dict(temporal_detector=True, batch_size=3) if kind == "video"
          else dict(use_image_dataset=True, batch_size=2))
    dkw = dict(dataset_kwargs(ds_path), load_n_consecutive=8, subsample_factor=2)
    out = []
    for mod in (jmu, tmu):
        opts = mod.MetricOptions(dataset_kwargs=dkw, cache_dir=str(tmp_path / mod.__name__))
        out.append(mod.compute_feature_stats_for_dataset(
            opts, "i3d", {"rescale": True}, capture_mean_cov=True, capture_all=True,
            max_items=3, **kw))
    assert_stats_equal(out[1], out[0])
    assert out[1].num_items == 3
    # the same cache file; a second call reads it
    files = [os.listdir(tmp_path / mod.__name__) for mod in (jmu, tmu)]
    assert files[0] == files[1] and len(files[1]) == 1
    again = tmu.compute_feature_stats_for_dataset(
        tmu.MetricOptions(dataset_kwargs=dkw, cache_dir=str(tmp_path / tmu.__name__)),
        "i3d", {"rescale": True}, capture_mean_cov=True, capture_all=True, max_items=3, **kw)
    assert_stats_equal(again, out[1])


class JaxGenDraws:
    """The JAX generator loop's draws (metric_utils.py:674-684) as a draw
    source: per batch, z from split(key) and motion_z from fold_in(key, 1)."""

    def __init__(self, seed=0, replica=0):
        self.key = jax.random.PRNGKey(seed * 1000 + replica)

    def randn(self, shape):
        if len(shape) == 2:
            self.key, sub = jax.random.split(self.key)
            return torch.from_numpy(np.array(jax.random.normal(sub, shape)))
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(self.key, 1),
                                                           shape)))


@pytest.fixture(scope="module")
def gens():
    """A small G at 16^2 in both packages, random weights carried by the bridge."""
    jcfg = small_gen_cfg(img_resolution=16)
    JG = JGenerator(jcfg)
    z = np.zeros((1, jcfg.z_dim), np.float32)
    ts = np.zeros((1, 3), np.float32)
    mz = np.zeros((1, JMotion.required_traj_len(jcfg), jcfg.motion.z_dim), np.float32)
    shapes = jax.eval_shape(lambda: JG.init(jax.random.PRNGKey(1), z, None, ts, motion_z=mz,
                                            noise_mode="const"))
    r = np.random.RandomState(5)

    def draw(path, s):
        # the mapping networks' lr_multiplier of 0.01 scales their weights down:
        # drawn 100 times larger, z moves the frames past uint8 rounding
        keys = [p.key for p in path]
        std = 100.0 if "mapping" in keys and keys[-1] == "weight" else 0.4
        return (r.randn(*s.shape) * std).astype(s.dtype)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    G = Generator(port_cfg(jcfg))
    G.load_state_dict(jax_to_torch_generator(variables))
    return JG, variables, G


def replaying(monkeypatch):
    """The port's generator loop draws JAX's z and motion codes."""
    orig = tmu.compute_feature_stats_for_generator

    def run(*args, seed=0, **kw):
        return orig(*args, seed=seed, draws=JaxGenDraws(seed), **kw)
    monkeypatch.setattr(tmu, "compute_feature_stats_for_generator", run)


def pixels(**_):
    """A detector whose features are the frames' uint8 values."""
    return lambda x: np.asarray(x, np.float32).reshape(len(x), -1)


def assert_frames_agree(got, want):
    """uint8 frames from two float32 syntheses: equal but where a value sat on a
    rounding edge (at most one level, and rarely)."""
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())


def test_generator_stats_replay_the_jax_draws(ds_path, gens, monkeypatch):
    JG, variables, G = gens
    for mod in (jmu, tmu):
        monkeypatch.setitem(mod._custom_detectors, "pixels", pixels)
    kw = dict(capture_all=True, max_items=3, temporal_detector=True, num_video_frames=4,
              subsample_factor=2, batch_size=8, seed=2)
    want = jmu.compute_feature_stats_for_generator(
        jmu.MetricOptions(G=JG, G_variables=variables, dataset_kwargs=dataset_kwargs(ds_path)),
        "pixels", {}, **kw).get_all()
    got = tmu.compute_feature_stats_for_generator(
        tmu.MetricOptions(G=G, dataset_kwargs=dataset_kwargs(ds_path), device="cpu"),
        "pixels", {}, draws=JaxGenDraws(seed=2), **kw).get_all()
    assert got.shape == want.shape == (3, 4 * 16 * 16 * 3)
    assert_frames_agree(got, want)
    assert len(np.unique(got, axis=0)) == 3                            # three videos
    # by default the port draws from a torch.Generator: other z, other frames
    other = tmu.compute_feature_stats_for_generator(
        tmu.MetricOptions(G=G, dataset_kwargs=dataset_kwargs(ds_path), device="cpu"),
        "pixels", {}, **kw).get_all()
    assert np.abs(other - got).mean() > 5


# ----------------------------------------------------------------- metrics

@pytest.fixture(scope="module")
def small_i3d():
    """A random I3D in both packages, run at native resolution (16^2 frames)."""
    variables = random_variables(ji3d.InceptionI3d(), jnp.zeros((1, 16, 16, 16, 3)), seed=11)
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    model = ti3d.InceptionI3d()
    model.load_state_dict(jax_to_torch_i3d(variables), strict=False)        # no logits
    jfeat = ji3d.i3d_features_fn(variables, resize=False)
    tfeat = ti3d.i3d_features_fn(model, device="cpu", resize=False)
    return (lambda **_: jfeat), (lambda **_: tfeat)


def assert_rel(got, want, what):
    assert np.isfinite(got) and abs(got - want) <= REL * abs(want), (what, got, want)


@pytest.mark.parametrize("metric,kw", [
    ("fvd2048_16f", dict(num_frames=16)),
    ("fvd2048_128f_subsample8f", dict(num_frames=16, subsample_factor=8)),
])
def test_fvd_equals_the_jax_package(ds_path, gens, small_i3d, monkeypatch, one_reader,
                                    tmp_path, metric, kw):
    JG, variables, G = gens
    for mod, builder in zip((jmu, tmu), small_i3d):
        monkeypatch.setitem(mod._custom_detectors, "i3d", builder)
    replaying(monkeypatch)
    common = dict(dataset_kwargs=dataset_kwargs(ds_path), max_real_override=4,
                  num_gen_override=4, cache=False)
    want = jcompute_fvd(jmu.MetricOptions(G=JG, G_variables=variables, **common),
                        max_real=2048, num_gen=2048, **kw)
    got = tcompute_fvd(tmu.MetricOptions(G=G, device="cpu", **common),
                       max_real=2048, num_gen=2048, **kw)
    assert_rel(got, want, metric)
    # through the registry, as calc_metric runs it in the loop
    r = tmm.calc_metric(metric, G=G, device="cpu", **common)
    assert r.metric == metric and r.results[metric] == got


def stub_inception(return_features=False, no_output_bias=False, **_):
    """A cheap stand-in for the Inception: pooled pixels as features, and a
    softmax of them as class probabilities (the IS path)."""
    stub = jmu._stub_detector("inception")

    def features(x):
        f = stub(x)
        if return_features:
            return f
        e = np.exp(10 * (f - f.max(axis=1, keepdims=True)))
        return e / e.sum(axis=1, keepdims=True)
    return features


def test_kid_and_is_equal_the_jax_package(ds_path, gens, monkeypatch, one_reader):
    JG, variables, G = gens
    for mod in (jmu, tmu):
        monkeypatch.setitem(mod._custom_detectors, "inception", stub_inception)
    replaying(monkeypatch)
    common = dict(dataset_kwargs=dataset_kwargs(ds_path), cache=False)
    jopts = jmu.MetricOptions(G=JG, G_variables=variables, **common)
    topts = tmu.MetricOptions(G=G, device="cpu", **common)
    kid = []
    for compute, opts in ((jcompute_kid, jopts), (tcompute_kid, topts)):
        np.random.seed(7)                      # the subsets come from the global np.random
        kid.append(compute(opts, max_real=6, num_gen=6, num_subsets=5))
    assert_rel(kid[1], kid[0], "kid")
    is_ = [compute(opts, num_gen=6, num_splits=2)
           for compute, opts in ((jcompute_is, jopts), (tcompute_is, topts))]
    for got, want, what in zip(is_[1], is_[0], ("is mean", "is std")):
        assert_rel(got, want, what)


# ------------------------------------------------------------------ limits

def test_more_than_one_replica_raises(ds_path, gens):
    _, _, G = gens
    kw = dict(G=G, dataset_kwargs=dataset_kwargs(ds_path), device="cpu", num_replicas=2,
              replica=1)
    opts = tmu.MetricOptions(**kw)
    with pytest.raises(NotImplementedError, match="ROADMAP P8"):
        tmm.calc_metric("fvd2048_16f", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP P8"):
        tmu.compute_feature_stats_for_dataset(opts, "i3d", {}, max_items=1)
    with pytest.raises(NotImplementedError, match="ROADMAP P8"):
        tmu.compute_feature_stats_for_generator(opts, "i3d", {}, max_items=1)


def test_metrics_raise_without_a_card_unless_asked_for_the_cpu(ds_path, gens, monkeypatch):
    _, _, G = gens
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(tmu._custom_detectors, "pixels", pixels)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmm.calc_metric("fvd2048_16f", G=G, dataset_kwargs=dataset_kwargs(ds_path),
                            device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmu.compute_feature_stats_for_generator(
                tmu.MetricOptions(G=G, dataset_kwargs=dataset_kwargs(ds_path), device=device),
                "pixels", {}, max_items=1)


def test_metric_device_names_the_card(monkeypatch):
    """"cuda" is the current card, so a G that the loop put on "cuda" is on the
    metric's device (G's parameters say cuda:0)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for device in (None, "cuda", "cuda:0", torch.device("cuda")):
        assert tmu.metric_device(tmu.MetricOptions(device=device)) == torch.device("cuda", 0)
    assert tmu.metric_device(tmu.MetricOptions(device="cpu")) == torch.device("cpu")


def test_detector_files_load_into_the_port_or_run_as_torchscript(tmp_path):
    """A reference file found under a canonical name loads its state_dict into
    the port's module (here a TorchScript trace of the port's I3D); any other
    file runs as TorchScript on the uint8 batch, channels first."""
    class Wrapped(torch.nn.Module):               # a file's state_dict under a prefix
        def __init__(self, module):
            super().__init__()
            self.module = module

        def forward(self, x):
            return x

    model = ti3d.InceptionI3d().eval()
    torch.jit.trace(Wrapped(model), torch.zeros(1)).save(str(tmp_path / tmu.DETECTOR_FILES["i3d"]))
    opts = tmu.MetricOptions(detector_dir=str(tmp_path), device="cpu")
    videos = np.random.RandomState(12).randint(0, 256, (2, 8, 32, 32, 3)).astype(np.uint8)
    kw = dict(rescale=True, resize=False, return_features=True)
    got = tmu.get_detector("i3d", opts, **kw)(videos)
    np.testing.assert_array_equal(got, ti3d.i3d_features_fn(model, device="cpu", **kw)(videos))

    class MeanOverTime(torch.nn.Module):
        def forward(self, x, scale: float = 1.0):                 # [N, C, T, H, W] uint8
            return x.float().mean(dim=(2, 3, 4)) * scale

    torch.jit.script(MeanOverTime()).save(str(tmp_path / "mean.pt"))
    got = tmu.get_detector("mean.pt", opts, scale=2.0)(torch.from_numpy(videos))
    np.testing.assert_allclose(got, videos.astype(np.float64).mean(axis=(1, 2, 3)) * 2.0,
                               rtol=1e-6)
