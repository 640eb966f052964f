"""The port's quality demo (`python -m stylegan_v_tpu_torch.train_fvd_demo`),
its backfill (`fvd_demo_backfill`) and `profile_model`, on the CPU.

  * build_setup equals the TrainSetup that scripts/train_fvd_demo.py hands
    the JAX loop, field by field, for the default flags and two overrides
    (the JAX loop and the JAX detector's registration are stubbed, so
    neither side trains nor draws an I3D);
  * the demo's I3D follows flax's lecun_normal: each conv's weight standard
    deviation within 3 % of sqrt(1 / fan_in), no weight beyond two of the
    untruncated sigmas, one draw a seed, repeatable to the bit;
  * at detector seed 17, on 4 seeded 64^2 clips at native resolution, the
    RMS of its features is within 0.8-1.25 of the JAX demo's detector's
    (another draw of the same distribution: measured 1.0698);
  * the demo's stall watchdog prints every other thread's stack under the
    interpreter lock, and stops;
  * a miniature run (32^2, batch 4, channel_base 1024, 0.02 kimg, bgc) writes
    finite, non-negative FVD rows; the backfill re-scores its snapshots
    under seed 18 into rows that scripts/fvd_seed_agreement.py:load_series
    joins by name with them, and under seed 17 gives the in-training value;
  * tools/fvd_demo_report.py reads the JAX demo's committed run as its
    record states it;
  * profile_model prints one row a batch size on a fresh 32^2 G, and its
    torch.profiler trace;
  * each entry point raises without a card unless asked for the CPU.
"""
import dataclasses
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import jax
import torch

from stylegan_v_tpu.metrics import metric_utils as jmu
from stylegan_v_tpu.metrics.detectors_flax import i3d as ji3d
from stylegan_v_tpu.training import loop as jloop
from stylegan_v_tpu_torch import fvd_demo_backfill as tbackfill
from stylegan_v_tpu_torch import profile_model as tprofile
from stylegan_v_tpu_torch import train_fvd_demo as tdemo
from stylegan_v_tpu_torch.metrics import metric_utils as tmu
from test_torch_detectors import flax_features
from test_torch_loop import as_plain
from test_torch_train import one_torch_thread

__all__ = ["one_torch_thread"]        # the fixture, from test_torch_train.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = ["--videos", "6", "--dataset-frames", "16", "--res", "32", "--batch", "4",
        "--channel-base", "1024", "--total-kimg", "0.02", "--kimg-per-tick", "0.008",
        "--snap-ticks", "1", "--fvd-items", "4", "--workers", "2"]


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def registries():
    """Both packages' detector registries as they were before the module."""
    saved = [(d, dict(d)) for mod in (jmu, tmu)
             for d in (mod._custom_detectors, mod._custom_detector_tags)]
    yield
    for d, before in saved:
        d.clear()
        d.update(before)


@pytest.fixture(scope="module")
def small_zip(tmp_path_factory):
    """6 videos of 16 frames at 32^2, written once."""
    path = str(tmp_path_factory.mktemp("data") / "mv.zip")
    return tdemo.load_maker().write_dataset(path, 6, 16, 32, seed=0)


# -------------------------------------------------------------------- setup

def jax_demo_setup(monkeypatch, argv):
    """The TrainSetup that scripts/train_fvd_demo.py:main hands the JAX loop,
    and the arguments of its detector registration."""
    demo = load_script("train_fvd_demo")
    got = {}
    monkeypatch.setattr(jloop, "training_loop", lambda setup: got.update(setup=setup))
    monkeypatch.setattr(demo, "register_random_i3d",
                        lambda *a, **kw: got.update(i3d=(a, kw)))
    monkeypatch.setattr(sys, "argv", ["train_fvd_demo.py", "--no-compile-cache"] + argv)
    try:
        demo.main()
    finally:
        import faulthandler
        faulthandler.cancel_dump_traceback_later()
    return got["setup"], got["i3d"]


@pytest.mark.parametrize("flags", [[], ["--augpipe", "none", "--gamma", "0"],
                                   ["--augpipe", "blit", "--batch", "8", "--fvd-items", "64",
                                    "--total-kimg", "0.5", "--resume", "latest"]],
                         ids=["defaults", "none-auto-gamma", "blit"])
def test_build_setup_equals_the_jax_demo(flags, small_zip, monkeypatch):
    argv = ["--outdir", "runs/x", "--data", small_zip] + flags
    want, (i3d_args, i3d_kw) = jax_demo_setup(monkeypatch, argv)
    got = tdemo.build_setup(tdemo.parse_args(argv))
    for f in dataclasses.fields(want):
        assert as_plain(getattr(got, f.name)) == as_plain(getattr(want, f.name)), f.name
    names = {f.name for f in dataclasses.fields(got)} - {f.name for f in dataclasses.fields(want)}
    assert names == {"allow_tf32"} and got.allow_tf32 is False
    # the JAX demo registers its I3D as (seed, 16 frames, res, resize224)
    args = tdemo.parse_args(argv)
    assert i3d_args == (args.detector_seed, tdemo.FVD_FRAMES, args.res, args.resize224)
    assert not i3d_kw


# ------------------------------------------------------------------ the I3D

def test_random_i3d_follows_flax_lecun_normal():
    a, b, c = tdemo.random_i3d(17), tdemo.random_i3d(17), tdemo.random_i3d(18)
    convs = [(n, m) for n, m in a.named_modules() if isinstance(m, torch.nn.Conv3d)]
    assert len(convs) == 58
    for name, m in convs:
        fan_in = m.weight[0].numel()
        std = 1.0 / math.sqrt(fan_in)            # lecun_normal's, after the truncation
        w = m.weight.double()
        assert abs(float(w.std()) / std - 1) < 0.03, name
        assert float(w.abs().max()) <= 2 * std / tdemo.TRUNC_STD * (1 + 1e-6), name
        if m.bias is not None:
            assert not m.bias.any()
    for (ka, va), (kb, vb), (kc, vc) in zip(a.state_dict().items(), b.state_dict().items(),
                                            c.state_dict().items()):
        assert ka == kb == kc and torch.equal(va, vb), ka
        if ka.endswith("conv3d.weight"):
            assert not torch.equal(va, vc), ka
        elif ka.endswith("running_var"):
            assert torch.equal(va, torch.ones_like(va)) and torch.equal(va, vc), ka
    # flax's own lecun_normal has that standard deviation and bound
    w = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (3, 3, 3, 64, 192)))
    std = 1.0 / math.sqrt(3 * 3 * 3 * 64)
    assert abs(w.std() / std - 1) < 0.01 and np.abs(w).max() <= 2 * std / tdemo.TRUNC_STD * 1.0001


def test_cache_tag_names_the_port_draw():
    tag = tdemo.i3d_cache_tag(17, 16, 64, False)
    assert tag == "torch-rand-i3d-s17-f16-r64-native"
    assert tdemo.i3d_cache_tag(18, 16, 64, False) != tag != tdemo.i3d_cache_tag(17, 16, 64, True)


JaxI3d = ji3d.InceptionI3d


class _JittedInit:
    """ji3d.InceptionI3d with its init jitted (eager, it takes about a minute)."""

    def __init__(self):
        self.init = jax.jit(JaxI3d().init)


def test_feature_scale_matches_the_jax_demo_detector():
    demo = load_script("train_fvd_demo")
    drawn = {}
    features_fn = ji3d.i3d_features_fn
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ji3d, "InceptionI3d", _JittedInit)
        mp.setattr(ji3d, "i3d_features_fn",
                   lambda variables, **kw: drawn.update(variables=variables, kw=kw))
        demo.register_random_i3d(17, 16, 64, resize224=False)
        jmu._custom_detectors["i3d"](rescale=True, resize=True, return_features=True)
    assert drawn["kw"]["resize"] is False
    videos = np.random.RandomState(3).randint(0, 256, (4, 16, 64, 64, 3)).astype(np.uint8)
    want = flax_features(features_fn, drawn["variables"], videos, resize=False)
    tdemo.register_random_i3d(17, 16, 64, resize224=False, device="cpu")
    assert tmu._custom_detector_tags["i3d"] == "torch-rand-i3d-s17-f16-r64-native"
    got = tmu._custom_detectors["i3d"](rescale=True, resize=True, return_features=True)(videos)
    assert got.shape == want.shape == (4, 1024) and np.isfinite(got).all()
    ratio = float(np.sqrt((got ** 2).mean()) / np.sqrt((want ** 2).mean()))
    assert 0.8 <= ratio <= 1.25, ratio


# ------------------------------------------------------------ the miniature

@pytest.fixture(scope="module")
def mini_run(tmp_path_factory, small_zip):
    """A miniature demo run on the CPU, with the metric cache in its own HOME."""
    root = tmp_path_factory.mktemp("demo")
    outdir = str(root / "run")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(root / "home"))
        series = tdemo.main(["--outdir", outdir, "--data", small_zip, "--device", "cpu"] + MINI)
    return outdir, small_zip, series, str(root / "home")


def read_rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_miniature_run_writes_finite_fvd_rows(mini_run):
    outdir, _, series, _ = mini_run
    rows = read_rows(os.path.join(outdir, "metric-fvd2048_16f.jsonl"))
    assert len(rows) == len(series) == 2              # a snapshot a tick, two ticks
    for r, (nimg, fvd) in zip(rows, series):
        v = r["results"]["fvd2048_16f"]
        assert v == fvd and math.isfinite(v) and v >= 0.0
        assert r["snapshot"] == "network-snapshot-000000" and r["snapshot_nimg"] == nimg
    # 0.02 kimg at 12 images a step: the loop stops at the first step past
    # it, as the JAX loop does (float arithmetic on the fraction)
    assert [n for n, _ in series] == [12, 24]
    assert os.path.exists(os.path.join(outdir, "network-snapshot-000000.pt"))


def test_backfill_rows_join_the_in_training_rows(mini_run, monkeypatch):
    outdir, data, series, home = mini_run
    monkeypatch.setenv("HOME", home)
    agreement = load_script("fvd_seed_agreement")
    common = ["--outdir", outdir, "--data", data, "--res", "32", "--dataset-frames", "16",
              "--fvd-items", "4", "--device", "cpu"]
    seed18 = os.path.join(outdir, "metric-fvd2048_16f.seed18.jsonl")
    rows = tbackfill.main(common + ["--detector-seed", "18", "--out-jsonl", seed18])
    assert [r["snapshot"] for r in rows] == ["network-snapshot-000000"]
    assert rows[0]["detector_seed"] == 18 and rows[0]["snapshot_nimg"] == 0
    assert tmu._custom_detector_tags["i3d"] == "torch-rand-i3d-s18-f16-r32-native"
    trained = agreement.load_series(os.path.join(outdir, "metric-fvd2048_16f.jsonl"))
    rescored = agreement.load_series(seed18)
    assert set(trained) == set(rescored) == {"network-snapshot-000000"}
    v = rescored["network-snapshot-000000"]
    assert math.isfinite(v) and v >= 0 and v != trained["network-snapshot-000000"]
    # recorded snapshots are skipped; --force appends
    assert tbackfill.main(common + ["--detector-seed", "18", "--out-jsonl", seed18]) == []
    # under the training run's seed 17 the backfill gives the in-training FVD
    # of the snapshot on disk (the last tick's)
    seed17 = os.path.join(outdir, "metric-fvd2048_16f.seed17.jsonl")
    again = tbackfill.main(common + ["--detector-seed", "17", "--out-jsonl", seed17, "--force"])
    assert len(again) == 1
    assert abs(again[0]["results"]["fvd2048_16f"] - series[-1][1]) <= 1e-6 * series[-1][1]
    assert len(read_rows(seed18)) == 1


def test_stall_watchdog_prints_every_thread_and_stops(capsys):
    import time
    with tdemo.StallWatchdog(0.05) as dog:
        time.sleep(0.3)
    assert not dog.thread.is_alive()
    err = capsys.readouterr().err
    assert err.count("Stall watchdog: every thread's stack after 0.05 s") >= 2
    assert "Thread MainThread (most recent call last):" in err
    assert "test_stall_watchdog_prints_every_thread_and_stops" in err
    assert "Thread stall-watchdog" not in err


def test_report_reads_the_jax_demo_run():
    """tools/fvd_demo_report.py on the JAX package's committed 500-kimg run:
    the numbers its record states (peak 0.00315 at 64 kimg, 1.48e-4 at 192,
    final/peak 12.6x; Dreal 0.85-1.39 after tick 16), and the ticks that
    wrote no snapshot found from the metric rows' timestamps."""
    from stylegan_v_tpu_torch.tools import fvd_demo_report
    s = fvd_demo_report.summary(os.path.join(REPO, "runs", "fvd_demo_r5"))
    assert (s["snapshots"], s["first_kimg"], s["last_kimg"], s["ticks"]) == (32, 16, 500, 63)
    assert s["peak"][0] == 64 and abs(s["peak"][1] - 0.003152) < 1e-6
    assert s["min"][0] == 192 and abs(s["min"][1] - 1.4767e-4) < 1e-8
    assert abs(s["final_over_peak"] - 12.63) < 0.01 and abs(s["min_over_peak"] - 21.35) < 0.01
    assert abs(s["d_real"][0] - 0.8496) < 1e-3 and abs(s["d_real"][1] - 1.3929) < 1e-3
    assert s["d_fake"][0] < s["d_fake"][1] < 0
    assert set(s["p"]) == {1, 8, 16, 24, 32, 48, 63}
    # its backfills under detector seeds 17-19 (the record's table: 12.6x, 11.3x, 10.2x)
    assert [(n, round(f["final_over_peak"], 1)) for n, f in s["seeds"].items()] == [
        (17, 12.6), (18, 11.3), (19, 10.2)]
    assert set(s["step_ms"]) == {"Gmain_Dmain", "Gmain_Dmain_Gpl", "Gmain_Dmain_Gpl_Dr1"}
    # the run wrote a snapshot every 2 ticks: 31 of its 62 intervals hold no
    # metric row
    assert abs(s["sec_per_tick"] - 8.781) < 1e-3
    text = fvd_demo_report.report(os.path.join(REPO, "runs", "fvd_demo_r5"))
    assert "final/peak 12.63x, min/peak 21.35x" in text


# ------------------------------------------------------------ profile_model

def test_profile_model_prints_a_row_a_batch_size(capsys, tmp_path):
    rows = tprofile.main(["--device", "cpu", "--resolution", "32", "--frames", "2",
                          "--batch-sizes", "1,2", "--iters", "1", "--trace-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu  resolution: 32"
    assert out[1].split() == ["videos", "frames", "s/iter", "frames/sec"]
    assert [r["videos"] for r in rows] == [1, 2] and len(out) == 5
    assert out[4] == f"trace written to {tmp_path}"
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    for line, r in zip(out[2:], rows):
        cells = line.split()
        assert len(cells) == 4 and cells[:2] == [str(r["videos"]), "2"]
        assert r["sec_per_iter"] > 0 and r["frames_per_sec"] > 0 and "peak_gib" not in r


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("entry", ["train_fvd_demo", "fvd_demo_backfill", "profile_model"])
def test_entry_points_raise_without_a_card(entry, tmp_path):
    main = {"train_fvd_demo": tdemo.main, "fvd_demo_backfill": tbackfill.main,
            "profile_model": tprofile.main}[entry]
    argv = {"train_fvd_demo": ["--outdir", str(tmp_path), "--data", str(tmp_path / "none.zip")],
            "fvd_demo_backfill": ["--outdir", str(tmp_path)],
            "profile_model": ["--resolution", "32"]}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not os.path.exists(tmp_path / "none.zip")
