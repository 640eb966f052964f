"""The port's training loop, snapshots, setup and entry point, on the CPU.

  * setup_training equals the JAX package's field by field (presets, ADA
    modes, the UserError cases);
  * generate_videos equals the JAX package's with bridged weights and the
    same motion trajectory, within TOL of scale (as test_torch_models.py),
    and truncates toward each class's mean w;
  * the loop at tests/test_loop_e2e.py:tiny_setup's sizes writes the
    artifacts and stats.jsonl schema that test_loop_artifacts_and_resume
    asserts, ticks and snapshots on the JAX loop's schedule, repeats itself
    with one seed, raises before a step for every option it does not have
    yet, runs the multi-GPU options in one process, and raises without CUDA
    unless asked for the CPU.

Snapshots, resume, the converter and the loop's metrics are held in
test_torch_loop_resume.py, with the helpers here.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import jax
import torch

from stylegan_v_tpu import train_setup as jsetup
from stylegan_v_tpu.models import Discriminator as JDiscriminator
from stylegan_v_tpu.models import Generator as JGenerator
from stylegan_v_tpu.models.motion import MotionMappingNetwork as JMotion
from stylegan_v_tpu.training import train_step as jts
from stylegan_v_tpu.training import video_io as jvideo_io
from stylegan_v_tpu.utils import config as jcfglib
from stylegan_v_tpu_torch import train as ttrain
from stylegan_v_tpu_torch import train_setup as tsetup
from stylegan_v_tpu_torch.io import checkpoint as tckpt
from stylegan_v_tpu_torch.io.bridge import jax_to_torch_generator
from stylegan_v_tpu_torch.metrics import metric_utils as tmu
from stylegan_v_tpu_torch.models import Discriminator, Generator
from stylegan_v_tpu_torch.models.config import SamplingConfig
from stylegan_v_tpu_torch.models.motion import MotionMappingNetwork
from stylegan_v_tpu_torch.training import loop as tloop
from stylegan_v_tpu_torch.training import train_step as tts
from stylegan_v_tpu_torch.training import video_io as tvideo_io
from stylegan_v_tpu_torch.training.loss import LossConfig
from stylegan_v_tpu_torch.utils import config as tcfglib
from test_data import build_video_dataset_dir, build_video_dataset_zip
from test_torch_models import port_cfg, small_disc_cfg, small_gen_cfg
from test_torch_train import one_torch_thread

__all__ = ["one_torch_thread"]        # the fixture, from test_torch_train.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


def as_plain(v):
    """A value for comparison across the two packages: dataclasses by name and fields."""
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, {f.name: as_plain(getattr(v, f.name))
                                   for f in dataclasses.fields(v)})
    if isinstance(v, dict):
        return {k: as_plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [as_plain(x) for x in v]
    return v


# -------------------------------------------------------------------- setup

SETUP_CASES = {
    "auto": [],
    "paper256": ["training.cfg=paper256", "training.kimg=100", "training.mirror=false"],
    "fixed": ["training.aug=fixed", "training.p=0.3", "training.batch_size=8",
              "model.loss_kwargs.r1_gamma=2.0", "training.batch_gpu=4"],
    "noaug": ["training.aug=noaug", "training.fp32=true", "training.subset=100",
              "model.optim.generator.lr=0.001", "model.optim.discriminator.betas=[0.5,0.9]"],
}


@pytest.mark.parametrize("case", sorted(SETUP_CASES))
def test_setup_training_equals_the_jax_package(case):
    overrides = SETUP_CASES[case] + ["training.metrics=[]"]
    config_dir = os.path.join(REPO, "configs")
    want = jsetup.setup_training(jcfglib.load_config(config_dir, overrides), 256, 0,
                                 run_dir="runs/x")
    got = tsetup.setup_training(tcfglib.load_config(config_dir, overrides), 256, 0,
                                run_dir="runs/x")
    for f in dataclasses.fields(want):
        assert as_plain(getattr(got, f.name)) == as_plain(getattr(want, f.name)), f.name
    names = {f.name for f in dataclasses.fields(got)} - {f.name for f in dataclasses.fields(want)}
    assert names == {"allow_tf32"} and got.allow_tf32 is False


@pytest.mark.parametrize("overrides,c_dim", [
    (["training.cfg=nope"], 0), (["training.aug=fixed"], 0), (["training.aug=sometimes"], 0),
    (["training.augpipe=nope"], 0), (["training.cond=true"], 0),
    (["training.gpus=3", "training.batch_size=16"], 0),
])
def test_setup_training_user_errors_equal_the_jax_package(overrides, c_dim):
    config_dir = os.path.join(REPO, "configs")
    with pytest.raises(jsetup.UserError) as jerr:
        jsetup.setup_training(jcfglib.load_config(config_dir, overrides), 256, c_dim)
    with pytest.raises(tsetup.UserError) as terr:
        tsetup.setup_training(tcfglib.load_config(config_dir, overrides), 256, c_dim)
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------- video output

def test_generate_videos_equals_the_jax_package():
    """Chunked synthesis (3 videos x 7 frames, 2 frames a chunk, one padded
    frame) against one motion trajectory for the whole clip, at 16^2."""
    jcfg = small_gen_cfg(img_resolution=16)
    rng = np.random.RandomState(0)
    N, T = 3, 7
    z = rng.randn(N, jcfg.z_dim).astype(np.float32)
    ts = np.tile(np.arange(T, dtype=np.float32)[None] * 1.5, (N, 1))
    mz = rng.randn(N, JMotion.required_traj_len(jcfg, float(ts.max())),
                   jcfg.motion.z_dim).astype(np.float32)
    JG = JGenerator(jcfg)
    # weights drawn at std 0.3 into the structure of an abstract init (a
    # concrete one costs seconds of eager JAX), so that few pixels saturate
    shapes = jax.eval_shape(lambda: JG.init(jax.random.PRNGKey(1), z, None, ts[:, :3],
                                            motion_z=mz, noise_mode="const"))
    r = np.random.RandomState(5)
    variables = jax.tree_util.tree_map(lambda s: (r.randn(*s.shape) * 0.3).astype(s.dtype),
                                       shapes)
    want = jvideo_io.generate_videos(JG, variables, z, None, ts, motion_z=mz,
                                     batch_size_num_frames=6)
    G = Generator(port_cfg(jcfg))
    G.load_state_dict(jax_to_torch_generator(variables))
    got = tvideo_io.generate_videos(G, z, None, ts, motion_z=mz, batch_size_num_frames=6)
    assert got.shape == want.shape == (N, T, 16, 16, 3) and got.dtype == np.float32
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), err
    assert ((want > 0) & (want < 1)).mean() > 0.9
    # without motion_z, one trajectory drawn from the seed for the whole clip
    a = tvideo_io.generate_videos(G, z, None, ts, batch_size_num_frames=6, seed=3)
    b = tvideo_io.generate_videos(G, z, None, ts, batch_size_num_frames=100, seed=3)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_generate_videos_truncates_toward_each_class_mean():
    """Class-conditional truncation (reference logging.py:27-32): each video
    moves toward its class's mean w, estimated from 1000 samples drawn from
    a torch.Generator seeded with seed + 1, not toward the global w_avg."""
    cfg = port_cfg(small_gen_cfg(img_resolution=16, c_dim=2))
    G = Generator(cfg, generator=torch.Generator().manual_seed(0)).eval()
    r = np.random.RandomState(1)
    z = torch.from_numpy(r.randn(3, cfg.z_dim).astype(np.float32))
    c = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    ts = torch.arange(4.0)[None].repeat(3, 1)
    mz = torch.from_numpy(r.randn(3, MotionMappingNetwork.required_traj_len(cfg, 3.0),
                                  cfg.motion.z_dim).astype(np.float32))
    got = tvideo_io.generate_videos(G, z, c, ts, motion_z=mz, truncation_psi=0.25, seed=4)
    with torch.no_grad():
        z_avg = torch.randn((3 * 1000, cfg.z_dim), generator=torch.Generator().manual_seed(5))
        w_avg = G.mapping(z_avg, c.repeat_interleave(1000, dim=0))[:, 0].reshape(3, 1000, -1)
        ws = 0.25 * G.mapping(z, c) + 0.75 * w_avg.mean(dim=1)[:, None]
        img = G.synthesis(ws, t=ts, c=c, motion_z=mz, noise_mode="const")
    want = (img * 0.5 + 0.5).clamp(0, 1).permute(0, 2, 3, 1).reshape(3, 4, 16, 16, 3)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-6)
    full = tvideo_io.generate_videos(G, z, c, ts, motion_z=mz)
    assert np.abs(full - got).max() > 1e-3


# ---------------------------------------------------------------- snapshots

def small_state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    G = Generator(port_cfg(small_gen_cfg()), generator=gen)
    D = Discriminator(port_cfg(small_disc_cfg()), generator=gen)
    tcfg = tts.TrainingConfig(batch_size=2)
    opt = tts.OptimizerConfig(lr=0.002)
    return tts.init_train_state(G, D, opt, opt, tcfg, augment_p=0.25), tcfg


def state_tensors(state):
    """Every tensor of a TrainState by name, and its counters."""
    out = {f"{m}.{k}": v for m in ("G", "D", "G_ema")
           for k, v in getattr(state, m).state_dict().items()}
    for m in ("opt_G", "opt_D"):
        for i, s in getattr(state, m).state_dict()["state"].items():
            out.update({f"{m}.{i}.{k}": v for k, v in s.items()})
    out.update({k: getattr(state, k) for k in ("pl_mean", "augment_p", "ada_sign_acc")})
    return out, (state.step, state.cur_nimg)


def assert_states_equal(a, b):
    (ta, ca), (tb, cb) = state_tensors(a), state_tensors(b)
    assert ca == cb and set(ta) == set(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k].cpu(), tb[k].cpu()), k


SMALL16 = {"G": small_gen_cfg(img_resolution=16), "D": small_disc_cfg(img_resolution=16)}


def jax_state_with_moments(seed=0):
    """A JAX TrainState at 16^2 with random values everywhere, Adam's moments
    included (its structure from an abstract trace of init_train_state)."""
    G, D = JGenerator(SMALL16["G"]), JDiscriminator(SMALL16["D"])
    shapes = jax.eval_shape(lambda: jts.init_train_state(
        jax.random.PRNGKey(seed), G, D, jts.OptimizerConfig(), jts.OptimizerConfig(),
        jts.TrainingConfig(batch_size=2)))
    r = np.random.RandomState(seed)

    def fill(s):
        if np.issubdtype(s.dtype, np.integer):
            return np.full(s.shape, 7, s.dtype)        # step and Adam's counts
        return np.abs(r.randn(*s.shape)).astype(s.dtype)

    state = jax.tree_util.tree_map(fill, shapes)
    return state.replace(cur_nimg=np.int32(2048), augment_p=np.float32(0.125),
                         pl_mean=np.float32(0.5), ada_sign_acc=np.float32(-0.25))


# --------------------------------------------------------------------- loop

def tiny_setup(ds_path, run_dir, kimg=0.05, resume=None, **kw):
    """tests/test_loop_e2e.py:tiny_setup on the port's classes, one loader
    worker, a tick every two steps and a snapshot every two ticks."""
    sampling = SamplingConfig(num_frames_per_video=3, max_num_frames=16,
                              total_dists=(1, 2, 4, 8), max_dist=8)
    fields = dict(
        run_dir=run_dir, desc="tiny",
        gen_cfg=port_cfg(small_gen_cfg()), disc_cfg=port_cfg(small_disc_cfg()),
        loss_cfg=LossConfig(r1_gamma=0.5, pl_weight=0.0),
        train_cfg=tts.TrainingConfig(batch_size=4, ema_kimg=0.5, ada_target=0.6),
        opt_g=tts.OptimizerConfig(lr=0.002), opt_d=tts.OptimizerConfig(lr=0.002),
        augment_cfg=None, augment_p=0.0,
        dataset_kwargs=dict(path=ds_path, sampling=sampling, max_num_frames=16),
        sampling_cfg=sampling, use_fractional_t=True,
        total_kimg=kimg, kimg_per_tick=0.02, snap_ticks=2,
        metrics=[], seed=0, num_chips=1, resume=resume, freeze_layers=0,
        num_workers=1)
    fields.update(kw)
    return tsetup.TrainSetup(**fields)


def expected_schedule(start_nimg, total_kimg, kimg_per_tick, snap_ticks, nimg_per_step=12):
    """stylegan_v_tpu/training/loop.py:274-302: the nimg of each tick and of
    each snapshot."""
    ticks, snaps, cur, next_tick = [], [], start_nimg, start_nimg
    while True:
        cur += nimg_per_step
        done = cur >= total_kimg * 1000
        if not done and cur < next_tick + kimg_per_tick * 1000:
            continue
        next_tick = cur
        ticks.append(cur)
        if len(ticks) % snap_ticks == 0 or done:
            snaps.append(cur)
        if done:
            return ticks, snaps


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    ds = build_video_dataset_dir(str(root), num_videos=6, frames_per_video=20, res=32)
    setup = tiny_setup(ds, str(root / "run"))
    stdout = sys.stdout
    result = tloop.training_loop(setup, device=torch.device("cpu"))       # log=print
    assert sys.stdout is stdout                     # the Logger gave stdout back
    return root, ds, setup, result


def test_loop_artifacts_stats_and_schedule(first_run):
    root, _, setup, result = first_run
    run = root / "run"
    files = os.listdir(run)
    for name in ("reals.jpg", "fakes_init.jpg", "stats.jsonl", "log.txt"):
        assert name in files, files
    ticks, snaps = expected_schedule(0, 0.05, 0.02, 2)
    assert (ticks, snaps) == ([24, 48, 60], [48, 60])
    assert result["cur_nimg"] == 60 and result["ticks"] == 3
    assert sorted(f for f in files if f.startswith("fakes0")) == sorted(
        f"fakes{n:06d}.{ext}" for n in snaps for ext in ("jpg", "mp4"))
    assert {f for f in files if f.startswith("network-snapshot-")} == {
        "network-snapshot-000000.pt", "network-snapshot-000000.meta.json"}
    # stats.jsonl rows carry mean/std/num per stat (test_loop_e2e.py:54-64)
    rows = [json.loads(line) for line in open(run / "stats.jsonl")]
    assert len(rows) == len(ticks)
    for row in rows:
        assert isinstance(row.pop("timestamp"), float)
        assert "Loss/G/loss" in row and "Progress/augment_p" in row
        for k, v in row.items():
            assert set(v) == {"mean", "std", "num"}, k
    assert [row["Timing/data_fetch"]["num"] for row in rows] == [2, 2, 1]
    timing_keys = {k for row in rows for k in row if k.startswith("Timing/")}
    assert timing_keys == {"Timing/data_fetch", "Timing/Gmain_Dmain_Gpl_Dr1",
                           "Timing/Gmain_Dmain", "Timing/Gmain_Dmain_Gpl"}
    log = (run / "log.txt").read_text()
    assert "Training for 0.05 kimg" in log
    assert [line.split()[:2] for line in log.splitlines() if line.startswith("tick ")] == \
        [["tick", str(i + 1)] for i in range(len(ticks))]
    payload, meta = tckpt.load_snapshot(str(run / "network-snapshot-000000.pt"))
    assert meta["cur_nimg"] == 60 and payload["step"] == 5


def test_two_runs_with_one_seed_are_equal(first_run, tmp_path):
    root, ds, _, first = first_run
    second = tloop.training_loop(tiny_setup(ds, str(tmp_path / "run")),
                                 device=torch.device("cpu"), log=lambda *_: None)
    assert_states_equal(second["state"], first["state"])

    def stats(path):
        rows = [json.loads(line) for line in open(path)]
        return [{k: v for k, v in row.items() if not k.startswith(("Timing/", "timestamp"))}
                for row in rows]

    assert stats(tmp_path / "run" / "stats.jsonl") == stats(root / "run" / "stats.jsonl")


@pytest.mark.parametrize("allow_tf32", [False, True])
def test_loop_runs_with_tf32_as_its_setup_asks(first_run, tmp_path, allow_tf32):
    """TF32 in every D call is the setup's allow_tf32 (off by default), and the
    caller's settings come back when the loop returns."""
    _, ds, _, _ = first_run
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    seen = set()

    def hook(module, *_):
        if isinstance(module, Discriminator):
            seen.add((cudnn.allow_tf32, matmul.allow_tf32))

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = not allow_tf32, not allow_tf32
        tloop.training_loop(tiny_setup(ds, str(tmp_path / "run"), kimg=0.012,
                                       allow_tf32=allow_tf32),
                            device=torch.device("cpu"), log=lambda *_: None)
        assert seen == {(allow_tf32, allow_tf32)}
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (not allow_tf32, not allow_tf32)
    finally:
        handle.remove()
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_step_seed_depends_on_seed_and_step_only():
    assert tloop.step_seed(0, 5) == tloop.step_seed(0, 5)
    seeds = {tloop.step_seed(s, i) for s in range(3) for i in range(100)}
    assert len(seeds) == 300 and all(0 <= s < 2 ** 63 for s in seeds)


# configs/model/mocogan.yaml's G: the autoregressive (LSTM) motion strategy
LSTM_KW = {"motion.gen_strategy": "autoregressive", "motion.fourier": False,
           "motion.motion_z_distance": 1, "input_type": "const",
           "time_enc.cond_type": "concat_w"}


def lstm_pickle(path):
    """A reference pickle whose G and G_ema hold the LSTM motion encoder
    (`rnn.*`), seeded, at small_gen_cfg's widths."""
    from stylegan_v_tpu_torch.tools.ref_pickle import write_reference_pickle
    G = Generator(port_cfg(small_gen_cfg(**LSTM_KW)), generator=torch.Generator().manual_seed(4))
    return write_reference_pickle(str(path), G=G, G_ema=G), G


@pytest.mark.parametrize("option", ["mocogan", "pkl"])
def test_unported_options_raise_before_a_step(tmp_path, option):
    """[mocogan]: MoCoGAN over two chips is ported (P9c-ranks;
    tests/test_torch_mocogan_ranks.py trains it over two ranks), and one
    process asked for two chips raises check_world's ValueError before
    anything is made. [pkl]: since P9c, one rank resumes from a .pkl whose G
    holds the LSTM and trains a step from its weights (G_ema's second LSTM
    bias, which never trains, is still the pickle's)."""
    run = str(tmp_path / "run")
    if option == "mocogan":
        with pytest.raises(ValueError, match="num_gpus=2"):
            tloop.training_loop(tiny_setup("unused", run, disc_source="mocogan", num_chips=2),
                                device=torch.device("cpu"))
        assert not os.path.exists(run)
        return
    path, source = lstm_pickle(tmp_path / "network-snapshot.pkl")
    ds = build_video_dataset_dir(str(tmp_path), num_videos=4, frames_per_video=20, res=32)
    result = tloop.training_loop(
        tiny_setup(ds, run, kimg=0.012, resume=path, gen_cfg=port_cfg(small_gen_cfg(**LSTM_KW))),
        device=torch.device("cpu"), log=lambda *_: None)
    assert result["state"].step == 1
    key = "synthesis.motion_encoder.rnn.bias_hh_l0"
    assert torch.equal(result["state"].G_ema.state_dict()[key], source.state_dict()[key])


@pytest.mark.parametrize("option", ["metrics", "chips", "zero1"])
def test_options_ported_for_several_ranks_run(first_run, tmp_path, monkeypatch, option):
    """The multi-GPU options (ROADMAP P8) in one process: in-training metrics
    over two replicas score this process's replica; ZeRO-1 over one rank is
    plain Adam; two chips need two processes, and one process says how to
    start them before it makes anything. tests/test_torch_parallel.py runs
    them over two ranks."""
    _, ds, _, _ = first_run
    run = tmp_path / "run"
    if option == "chips":
        with pytest.raises(ValueError, match="num_gpus=2"):
            tloop.training_loop(tiny_setup(ds, str(run), num_chips=2),
                                device=torch.device("cpu"))
        assert not os.path.exists(run)
        return
    monkeypatch.setitem(tmu._custom_detectors, "i3d", lambda **_: tmu._stub_detector("i3d"))
    kw = {"metrics": dict(metrics=["fvd2048_16f"], metric_kwargs=dict(
              num_replicas=2, max_real_override=4, num_gen_override=3,
              cache_dir=str(tmp_path / "cache"))),
          "zero1": dict(train_cfg=tts.TrainingConfig(batch_size=4, zero1=True))}[option]
    result = tloop.training_loop(tiny_setup(ds, str(run), kimg=0.012, **kw),
                                 device=torch.device("cpu"), log=lambda *_: None)
    assert result["state"].step == 1 and type(result["state"].opt_G) is torch.optim.Adam
    if option == "metrics":
        rows = [json.loads(line) for line in open(run / "metric-fvd2048_16f.jsonl")]
        assert len(rows) == 1 and np.isfinite(rows[0]["results"]["fvd2048_16f"])


def test_training_loop_and_entry_point_raise_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = str(tmp_path / "run")
    for device in (None, "cuda", torch.device("cuda", 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tloop.training_loop(tiny_setup("unused", run), device=device)
    zip_path = build_video_dataset_zip(str(tmp_path), num_videos=2, frames_per_video=8, res=32)
    args = [f"dataset.path={zip_path}", "training.metrics=[]", f"project_release_dir={run}"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(args)
    assert not os.path.exists(run)
    # asked for the CPU, the entry point composes, freezes and resolves the setup
    assert ttrain.main(args + ["training.dry_run=true", "--device", "cpu"]) is None
    frozen = tcfglib.load_frozen(os.path.join(run, "experiment_config.yaml"))
    assert frozen.dataset.path == zip_path and frozen.training.metrics == []
