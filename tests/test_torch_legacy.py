"""The port's reference .pkl import (stylegan_v_tpu_torch/io/legacy.py,
legacy_tf.py) and resume from a .pkl, held to the JAX package on the CPU.

  * Each copied function (the unpickler, flatten_module_state,
    infer_generator_config, the TF renamers, is_tf_pickle) gives what its
    JAX original gives on the same pickles and inputs: the same keys, arrays
    equal to the bit, the same config fields.
  * A reference pickle written from seeded weights
    (stylegan_v_tpu_torch/tools/ref_pickle.py) imports into the same
    state_dicts, to the bit, as the JAX package's import_reference_snapshot
    followed by io/bridge.py; G's frames (noise 'const' and 'none') and D's
    logits then agree with the JAX modules within FP32_TOL of scale, as in
    tests/test_torch_models.py. The same for tests/test_legacy_tf.py's TF-era
    pickle, and for its partial copy into a template whose motion encoder
    stays fresh.
  * The loop resumed from a .pkl starts from its weights, at step 0 and
    cur_nimg 0; a shape that differs from the template and an LSTM (`rnn.*`)
    raise.

No real reference pickle is needed: every pickle is built here.
"""
import io

import numpy as np
import pytest
import torch

from stylegan_v_tpu.io import legacy as jleg
from stylegan_v_tpu.io import legacy_tf as jtf
from stylegan_v_tpu.models import Discriminator as JDiscriminator
from stylegan_v_tpu.models import Generator as JGenerator
from stylegan_v_tpu.models import config as jconfig
from stylegan_v_tpu_torch.io import jax_to_torch_discriminator, jax_to_torch_generator
from stylegan_v_tpu_torch.io import legacy as tleg
from stylegan_v_tpu_torch.io import legacy_tf as ttf
from stylegan_v_tpu_torch.models import Discriminator, Generator
from stylegan_v_tpu_torch.tools import ref_pickle
from stylegan_v_tpu_torch.training import loop as tloop

import test_legacy_tf as jtf_tests
from test_data import build_video_dataset_dir
from test_torch_loop import lstm_pickle, tiny_setup
from test_torch_models import (FP32_TOL, assert_close, inputs, nchw, port_cfg, small_disc_cfg,
                               small_gen_cfg)
from test_torch_train import one_torch_thread

__all__ = ["one_torch_thread"]        # the fixture, from test_torch_train.py

GEN_KW = dict(use_noise=True)         # noise_const and noise_strength in the pickle


def seeded(cls, cfg, seed):
    """A port module from a seeded torch.Generator; G with nonzero noise
    strengths and w_avg, so that both reach the frames."""
    gen = torch.Generator().manual_seed(seed)
    m = cls(port_cfg(cfg), generator=gen)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("noise_strength"):
                p.uniform_(0.2, 1.0, generator=gen)
        if isinstance(m, Generator):
            m.mapping.w_avg.normal_(generator=gen)
    return m.eval()


def port_module(cls, cfg, state):
    m = cls(port_cfg(cfg))
    m.load_state_dict(state)
    return m.eval()


@pytest.fixture(scope="module")
def ref_pkl(tmp_path_factory):
    """A reference pickle of seeded G, G_ema (other weights) and D; returns
    its path and the modules."""
    gcfg, dcfg = small_gen_cfg(**GEN_KW), small_disc_cfg()
    source = {"G": seeded(Generator, gcfg, 1), "G_ema": seeded(Generator, gcfg, 2),
              "D": seeded(Discriminator, dcfg, 3)}
    path = tmp_path_factory.mktemp("pkl") / "network-snapshot-000000.pkl"
    ref_pickle.write_reference_pickle(str(path), cur_nimg=4000, **source)
    return str(path), source


@pytest.fixture(scope="module")
def tf_pkl(tmp_path_factory):
    path = tmp_path_factory.mktemp("tfpkl") / "tf_snapshot.pkl"
    path.write_bytes(jtf_tests.tf_pickle_bytes(np.random.RandomState(7)))
    return str(path)


def assert_flat_equal(got, want):
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k in want:
        got_k = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        assert got_k.shape == np.shape(want[k]), k
        np.testing.assert_array_equal(got_k, np.asarray(want[k]), err_msg=k)


def jax_route(path, **kw):
    """JAX import_reference_snapshot, then the bridge: the port's state_dicts."""
    out = jleg.import_reference_snapshot(path, **kw)
    conv = {"G": jax_to_torch_generator, "G_ema": jax_to_torch_generator,
            "D": jax_to_torch_discriminator}
    return {k: None if v is None else conv[k](v) for k, v in out.items()}


# ------------------------------------------------ the copies and their originals

def test_unpickler_and_flatten_equal_the_jax_package(ref_pkl, tf_pkl):
    path, _ = ref_pkl
    blob = open(path, "rb").read()
    got = tleg.SafeRefUnpickler(io.BytesIO(blob)).load()
    want = jleg.SafeRefUnpickler(io.BytesIO(blob)).load()
    assert got.keys() == want.keys() and got["cur_nimg"] == want["cur_nimg"] == 4000
    for key in ("G", "G_ema", "D"):
        assert isinstance(got[key], tleg.StubModule) and type(got[key]).__name__ == "StubModule"
        assert got[key].class_name == want[key].class_name
        assert got[key].state["_init_kwargs"] == want[key].state["_init_kwargs"]
        assert_flat_equal(tleg.flatten_module_state(got[key]),
                          jleg.flatten_module_state(want[key]))
    assert tleg.load_network_pkl(path).keys() == jleg.load_network_pkl(path).keys()

    got, want = tleg.load_network_pkl(tf_pkl), jleg.load_network_pkl(tf_pkl)
    assert got.keys() == want.keys()
    for key in ("G", "G_ema", "D"):
        assert isinstance(got[key], ttf.TFNetworkStub)
        assert got[key].version == want[key].version
        assert got[key].static_kwargs == want[key].static_kwargs
        assert_flat_equal(ttf.collect_tf_params(got[key]), jtf.collect_tf_params(want[key]))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(c_dim=5, use_noise=True, input_type="const", num_bf16_res=2, conv_clamp=None),
    {"motion.fourier": False, "time_enc.cond_type": "sum_w", "sampling.total_dists": None},
])
def test_infer_generator_config_equals_the_jax_package(kw):
    cfg = port_cfg(small_gen_cfg(**kw))
    init_kwargs = ref_pickle.generator_init_kwargs(cfg)
    got = tleg.infer_generator_config(tleg.StubModule({"state": {"_init_kwargs": init_kwargs}}))
    want = jleg.infer_generator_config(jleg.StubModule({"state": {"_init_kwargs": init_kwargs}}))
    assert got == port_cfg(want) == cfg
    empty = {"state": {}}                    # every default
    assert tleg.infer_generator_config(tleg.StubModule(empty)) == \
        port_cfg(jleg.infer_generator_config(jleg.StubModule(empty)))


@pytest.mark.parametrize("source", ["test", "tool"])
def test_tf_renamers_equal_the_jax_package(source):
    rnd = np.random.RandomState(8)
    if source == "test":                      # tests/test_legacy_tf.py's networks
        nets = (jtf_tests.make_tf_generator(rnd), jtf_tests.make_tf_discriminator(rnd))
    else:                                     # the tool's, at other widths
        nets = (ref_pickle.tf_generator(rnd, 16, 32, 256, 32, mapping_layers=3),
                ref_pickle.tf_discriminator(rnd, 16, 256, 32))
    blob = pickle_bytes(nets + nets[:1])
    tf_G, tf_D, _ = tleg.SafeRefUnpickler(io.BytesIO(blob)).load()
    j_G, j_D, _ = jleg.SafeRefUnpickler(io.BytesIO(blob)).load()
    pg, pd = ttf.collect_tf_params(tf_G), ttf.collect_tf_params(tf_D)
    assert_flat_equal(pg, jtf.collect_tf_params(j_G))
    assert_flat_equal(pd, jtf.collect_tf_params(j_D))
    assert_flat_equal(ttf.tf_to_torch_generator_state(pg), jtf.tf_to_torch_generator_state(pg))
    assert_flat_equal(ttf.tf_to_torch_discriminator_state(pd),
                      jtf.tf_to_torch_discriminator_state(pd))
    assert ttf.generator_kwargs_from_tf(tf_G.static_kwargs) == \
        jtf.generator_kwargs_from_tf(j_G.static_kwargs)
    assert ttf.discriminator_kwargs_from_tf(tf_D.static_kwargs) == \
        jtf.discriminator_kwargs_from_tf(j_D.static_kwargs)
    assert [ttf._noise_idx(r, c) for r in (4, 8, 256) for c in (0, 1)] == \
        [jtf._noise_idx(r, c) for r in (4, 8, 256) for c in (0, 1)]
    for args in [(tf_G, tf_D, tf_G), (tf_G, tf_D), [tf_G, tf_D, tf_G]]:
        j_args = type(args)(j_G if a is tf_G else j_D for a in args)
        assert ttf.is_tf_pickle(args) == jtf.is_tf_pickle(j_args) == (args == (tf_G, tf_D, tf_G))
    for mod in (ttf, jtf):
        with pytest.raises(ValueError, match="version too low"):
            mod._check_version(mod.TFNetworkStub())
        with pytest.raises(ValueError, match="Unknown TensorFlow kwarg"):
            mod.generator_kwargs_from_tf(dict(tf_G.static_kwargs, not_a_kwarg=1))
        with pytest.raises(NotImplementedError, match="progressive-era"):
            mod.tf_to_torch_generator_state({"synthesis/ToRGB_lod0/weight": np.zeros(1)})


def pickle_bytes(nets):
    """TF networks pickled under dnnlib.tflib.network.Network: the test
    module's registered class as it is, the tool's with its names."""
    import pickle
    if isinstance(nets[0], ref_pickle.Network):
        with ref_pickle._reference_names():
            return pickle.dumps(nets)
    return pickle.dumps(nets)


# --------------------------------------------------- the import against JAX's

def test_reference_pkl_equals_the_jax_route(ref_pkl):
    path, source = ref_pkl
    got = tleg.import_reference_snapshot(path)
    C = min(small_disc_cfg().channel_base // 4, small_disc_cfg().channel_max)
    want = jax_route(path, epilogue_channels=C)
    for key in ("G", "G_ema", "D"):
        assert_flat_equal(got[key], want[key])
        assert_flat_equal(got[key], source[key].state_dict())     # the pickled modules'

    gcfg, dcfg = small_gen_cfg(**GEN_KW), small_disc_cfg()
    jvars = jleg.import_reference_snapshot(path, epilogue_channels=C)
    G = port_module(Generator, gcfg, got["G_ema"])
    z, t, mz = inputs(gcfg, seed=3)
    for noise_mode in ("const", "none"):
        want_img = JGenerator(gcfg).apply(jvars["G_ema"], z, None, t, motion_z=mz,
                                         noise_mode=noise_mode)
        with torch.no_grad():
            got_img = G(torch.from_numpy(z), None, torch.from_numpy(t),
                        motion_z=torch.from_numpy(mz), noise_mode=noise_mode)
        assert_close(got_img, np.transpose(np.asarray(want_img), (0, 3, 1, 2)), FP32_TOL)
    D = port_module(Discriminator, dcfg, got["D"])
    img = np.random.RandomState(4).randn(6, 32, 32, 3).astype(np.float32)
    td = np.asarray([[0.0, 2.0, 7.0], [1.0, 5.0, 6.0]], np.float32)
    want_logits = JDiscriminator(dcfg).apply(jvars["D"], img, None, td)["image_logits"]
    with torch.no_grad():
        got_logits = D(nchw(img), None, torch.from_numpy(td))["image_logits"]
    assert_close(got_logits, np.asarray(want_logits), FP32_TOL)


def tf_gen_cfg():
    """A video G at tests/test_legacy_tf.py's TF widths (its end-to-end test's)."""
    return jconfig.GeneratorConfig(
        w_dim=jtf_tests.WDIM, z_dim=jtf_tests.WDIM, img_resolution=jtf_tests.RES,
        channel_base=2 * jtf_tests.FMAP_BASE, channel_max=jtf_tests.FMAP_MAX, num_bf16_res=0,
        conv_clamp=None, mapping_layers=2, use_noise=True, input_type="const",
        motion=jconfig.MotionConfig(z_dim=32, v_dim=32, motion_z_distance=16),
        time_enc=jconfig.TimeEncConfig(dim=32),
        sampling=jconfig.SamplingConfig(num_frames_per_video=2, max_num_frames=128,
                                        total_dists=(1, 2, 4, 8), max_dist=8))


def test_tf_pkl_equals_the_jax_route(tf_pkl):
    got = tleg.import_reference_snapshot(tf_pkl)
    want = jax_route(tf_pkl)
    for key in ("G", "G_ema", "D"):
        assert_flat_equal(got[key], want[key])

    # a partial copy into a video G: the motion encoder keeps its fresh weights
    cfg = tf_gen_cfg()
    z, t, mz = inputs(cfg, seed=5)
    G = seeded(Generator, cfg, 0)
    fresh = {k: v.clone() for k, v in G.state_dict().items()}
    # the same template as flax variables (tests/test_torch_bridge.py's round trip)
    template = jleg.convert_generator_state({k: v.numpy() for k, v in fresh.items()})
    merged = jleg.import_reference_snapshot(tf_pkl, gen_template=template)["G_ema"]
    got = tleg.import_reference_snapshot(tf_pkl, G_ema=G)["G_ema"]
    assert_flat_equal(got, jax_to_torch_generator(merged))
    assert_flat_equal(G.state_dict(), got)
    enc = [k for k in fresh if ".motion_encoder." in k]
    assert enc and all(torch.equal(got[k], fresh[k]) for k in enc)
    for noise_mode in ("const", "none"):
        want_img = JGenerator(cfg).apply(merged, z, None, t, motion_z=mz, noise_mode=noise_mode)
        with torch.no_grad():
            got_img = G(torch.from_numpy(z), None, torch.from_numpy(t),
                        motion_z=torch.from_numpy(mz), noise_mode=noise_mode)
        assert_close(got_img, np.transpose(np.asarray(want_img), (0, 3, 1, 2)), FP32_TOL)


def test_a_shape_the_template_does_not_have_raises(ref_pkl):
    path, _ = ref_pkl
    G = Generator(port_cfg(small_gen_cfg(**GEN_KW, channel_max=32)))
    with pytest.raises(ValueError, match="the checkpoint holds"):
        tleg.import_reference_snapshot(path, G=G)


def test_an_lstm_raises(tmp_path):
    path = lstm_pickle(tmp_path / "lstm.pkl")
    with pytest.raises(NotImplementedError, match="P9c"):
        tleg.import_reference_snapshot(path)


# ------------------------------------------------------------ resume from a .pkl

def test_the_loop_resumes_from_a_pkl(ref_pkl, tmp_path, monkeypatch):
    """Weights only: the first step starts from the pickle's G, G_ema and D,
    at step 0 and cur_nimg 0 with fresh Adam moments (the JAX loop's and the
    reference's resume_pkl)."""
    _, source = ref_pkl
    gcfg, dcfg = port_cfg(small_gen_cfg()), port_cfg(small_disc_cfg())
    gen = torch.Generator().manual_seed(11)
    G, D = Generator(gcfg, generator=gen), Discriminator(dcfg, generator=gen)
    G_ema = Generator(gcfg, generator=gen)
    path = ref_pickle.write_reference_pickle(str(tmp_path / "resume.pkl"), G=G, D=D,
                                             G_ema=G_ema, cur_nimg=123000)
    seen = {}
    make = tloop.make_train_step

    def recording(*args, **kw):
        step = make(*args, **kw)

        def first(state, *a, **k):
            if not seen:
                seen.update({name: {k2: v.clone() for k2, v in
                                    getattr(state, name).state_dict().items()}
                             for name in ("G", "D", "G_ema")})
                seen.update(step=state.step, cur_nimg=state.cur_nimg,
                            adam=len(state.opt_G.state) + len(state.opt_D.state))
            return step(state, *a, **k)
        return first

    monkeypatch.setattr(tloop, "make_train_step", recording)
    ds = build_video_dataset_dir(str(tmp_path), num_videos=4, frames_per_video=20, res=32)
    result = tloop.training_loop(tiny_setup(ds, str(tmp_path / "run"), kimg=0.012,
                                            resume=path),
                                 device=torch.device("cpu"), log=lambda *_: None)
    for name, module in (("G", G), ("D", D), ("G_ema", G_ema)):
        assert_flat_equal(seen[name], module.state_dict())
    assert (seen["step"], seen["cur_nimg"], seen["adam"]) == (0, 0, 0)
    assert (result["start_step"], result["start_nimg"]) == (0, 0)
    assert result["state"].step == 1 and result["cur_nimg"] == 12
