"""The port's snapshots, resume, JAX-snapshot converter and in-training
metrics, on the CPU: the second half of test_torch_loop.py, whose helpers
and tiny loop these tests use.

  * snapshots round-trip to the bit, `find_latest_snapshot` finds the newest,
    the meta equals the JAX package's, and the JAX-snapshot converter writes
    what the bridge gives;
  * the loop resumes from `latest` to the bit, keeps the ADA warp executor
    its snapshot names (a converted JAX run's shear), scores its metrics after each
    snapshot into rows with the JAX loop's fields, and a failed metric is
    logged while training goes on.
"""
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import jax
import torch

from stylegan_v_tpu.io import checkpoint as jckpt
from stylegan_v_tpu.metrics import metric_main as jmm
from stylegan_v_tpu_torch.io import checkpoint as tckpt
from stylegan_v_tpu_torch.io.bridge import jax_to_torch_train_state
from stylegan_v_tpu_torch.metrics import metric_utils as tmu
from stylegan_v_tpu_torch.models import Discriminator, Generator
from stylegan_v_tpu_torch.training import augment as taug
from stylegan_v_tpu_torch.training import loop as tloop
from stylegan_v_tpu_torch.training import train_step as tts
from stylegan_v_tpu_torch.training.loss import LossConfig
from test_torch_loop import (REPO, SMALL16, assert_states_equal, expected_schedule, first_run,
                             jax_state_with_moments, one_torch_thread, small_state, tiny_setup)
from test_torch_models import port_cfg, small_disc_cfg, small_gen_cfg

__all__ = ["first_run", "one_torch_thread"]        # fixtures shared with test_torch_loop.py


def test_snapshot_round_trip_to_the_bit(tmp_path):
    state, tcfg = small_state()
    step = tts.make_train_step(state.G, state.D, LossConfig(r1_gamma=1.0), tcfg)
    r = np.random.RandomState(1)
    t = np.sort(r.randint(0, 60, size=(2, 3)), axis=1).astype(np.float32)
    batch = {"real_img": torch.from_numpy(r.randint(0, 255, (2, 3, 3, 32, 32)).astype(np.uint8)),
             "real_c": torch.zeros(2, 0), "real_t": torch.from_numpy(t),
             "gen_c": torch.zeros(2, 3, 0), "gen_t": torch.from_numpy(np.stack([t] * 3, 1))}
    state, _ = step(state, batch, generator=torch.Generator().manual_seed(2), do_dr1=True)
    configs = {"G": state.G.cfg, "D": state.D.cfg}
    p1 = tckpt.save_snapshot(str(tmp_path), state, 1000, configs)
    p2 = tckpt.save_snapshot(str(tmp_path), state, 12_345, configs, extra_meta={"note": "x"})
    os.makedirs(tmp_path / "network-snapshot-000099.pt.d")        # not a snapshot file
    assert p1.endswith("network-snapshot-000001.pt") and os.path.isfile(p1)
    assert tckpt.find_latest_snapshot(str(tmp_path)) == p2
    assert tckpt.find_latest_snapshot(str(tmp_path / "absent")) is None

    payload, meta = tckpt.load_snapshot(p2)
    assert meta["cur_nimg"] == 12_345 and meta["note"] == "x"
    assert all(v.device.type == "cpu" for v in payload["G"].values())
    assert tckpt.meta_decode(meta["configs"]) == configs
    # the meta is the JAX package's, field for field
    jconfigs = {"G": small_gen_cfg(), "D": small_disc_cfg()}
    assert json.dumps(meta["configs"]) == json.dumps(
        {k: jckpt._meta_encode(v) for k, v in jconfigs.items()})
    fresh, _ = small_state(seed=7)
    tckpt.restore_train_state(fresh, payload)
    assert_states_equal(fresh, state)
    assert fresh.opt_G.param_groups[0]["lr"] == state.opt_G.param_groups[0]["lr"]


def test_copy_params_by_name_and_shape():
    src = {"a": torch.ones(2, 2), "b": torch.full((3,), 7.0), "d": torch.ones(5)}
    dst = {"a": torch.zeros(2, 2, dtype=torch.float64), "b": torch.zeros(4),
           "c": torch.zeros(4)}
    out = tckpt.copy_params(src, dst)
    assert out["a"].dtype == torch.float64 and bool((out["a"] == 1).all())
    assert out["b"] is dst["b"] and out["c"] is dst["c"] and "d" not in out
    with pytest.raises(KeyError):
        tckpt.copy_params(src, dst, require_all=True)


def test_jax_snapshot_converter_equals_the_bridge(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "convert_jax_snapshot_to_torch",
        os.path.join(REPO, "scripts", "convert_jax_snapshot_to_torch.py"))
    converter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(converter)
    jstate = jax_state_with_moments()
    jpath = jckpt.save_snapshot(str(tmp_path / "jax"), jstate, 2048, configs=SMALL16)
    path = converter.convert(jpath, str(tmp_path / "torch"))
    assert path == tckpt.find_latest_snapshot(str(tmp_path / "torch"))
    payload, meta = tckpt.load_snapshot(path)
    assert meta["cur_nimg"] == 2048
    # the warp executor the JAX run ran: "auto" is gather at 16^2, shear at 256^2
    assert meta["warp_mode"] == "gather" and converter.jax_warp_mode(256) == "shear"

    G, D = Generator(port_cfg(SMALL16["G"])), Discriminator(port_cfg(SMALL16["D"]))
    want = jax_to_torch_train_state(jstate, G, D)
    for key, name in (("G", "params_G"), ("D", "params_D"), ("G_ema", "params_Gema")):
        assert set(payload[key]) == set(want[name])
        for k, v in want[name].items():
            assert torch.equal(payload[key][k], v), (key, k)
    for opt in ("opt_G", "opt_D"):
        got = payload[opt]["state"]
        assert set(got) == set(want[opt]) and len(got) == len(list(
            (G if opt == "opt_G" else D).parameters()))
        for i, s in want[opt].items():
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(got[i][k], s[k]), (opt, i, k)
        assert float(got[0]["step"]) == 7.0
    assert [float(payload[k]) for k in ("pl_mean", "augment_p", "ada_sign_acc")] == \
        [0.5, 0.125, -0.25]
    assert (payload["step"], payload["cur_nimg"]) == (7, 2048)
    # the D epilogue fc's moments take its row permutation, as its weight does
    fc = [n for n, _ in D.named_parameters()].index("b4.fc.weight")
    mu = np.asarray(jstate.opt_D[0].mu["b4"]["fc"]["weight"])        # [(h*4+w)*C + c, out]
    C = mu.shape[0] // 16
    np.testing.assert_array_equal(payload["opt_D"]["state"][fc]["exp_avg"][:, 2 * 16 + 7].numpy(),
                                  mu[7 * C + 2])


def test_loop_resumes_from_latest_to_the_bit(first_run, tmp_path):
    root, ds, _, first = first_run
    run = str(tmp_path / "run")
    shutil.copytree(root / "run", run)
    snap, _ = tckpt.load_snapshot(tckpt.find_latest_snapshot(run))
    fresh, _ = small_state(seed=3)
    tckpt.restore_train_state(fresh, snap)
    assert_states_equal(fresh, first["state"])           # what was saved, to the bit
    result = tloop.training_loop(tiny_setup(ds, run, kimg=0.1, resume="latest"),
                                 device=torch.device("cpu"))                 # log=print
    assert (result["start_step"], result["start_nimg"]) == (5, 60)
    assert result["cur_nimg"] == 108 and result["state"].step == 9
    ticks, snaps = expected_schedule(60, 0.1, 0.02, 2)
    assert result["ticks"] == len(ticks)
    assert tckpt.find_latest_snapshot(run).endswith("network-snapshot-000000.pt")
    assert "Resuming from" in open(os.path.join(run, "log.txt")).read()
    with pytest.raises(FileNotFoundError):
        tloop.training_loop(tiny_setup(ds, run, resume=os.path.join(run, "absent.pt")),
                            device=torch.device("cpu"), log=lambda *_: None)


@pytest.mark.parametrize("named,setup_mode,runs", [
    (None, "auto", "gather"), ("shear", "auto", "shear"), ("gather", "auto", "gather"),
    ("shear", "gather", "gather")])
def test_a_resumed_run_keeps_the_warp_executor_its_snapshot_names(first_run, tmp_path,
                                                                   monkeypatch, named,
                                                                   setup_mode, runs):
    """training_loop resumed from a snapshot whose meta names a warp executor
    (a converted JAX run names "shear" at 256^2) runs the ADA pipe with it
    where the setup's warp_mode is "auto", and its next snapshot names it."""
    root, ds, _, _ = first_run
    run = str(tmp_path / "run")
    shutil.copytree(root / "run", run)
    meta_path = tckpt.find_latest_snapshot(run)[:-len(".pt")] + ".meta.json"
    meta = json.load(open(meta_path))
    meta.pop("warp_mode", None)
    if named is not None:
        meta["warp_mode"] = named
    json.dump(meta, open(meta_path, "w"))
    calls = {"shear": 0, "gather": 0}
    shear, gather = taug.shear_affine_grid_sample, taug.affine_grid_sample

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(taug, "shear_affine_grid_sample", counted("shear", shear))
    monkeypatch.setattr(taug, "affine_grid_sample", counted("gather", gather))
    aug = taug.AugmentConfig(**taug.AUGPIPE_SPECS["bgc"], warp_mode=setup_mode)
    tloop.training_loop(tiny_setup(ds, run, kimg=0.072, resume="latest", augment_cfg=aug),
                        device=torch.device("cpu"), log=lambda *_: None)
    assert calls[runs] > 0 and calls["shear" if runs == "gather" else "gather"] == 0, calls
    _, meta = tckpt.load_snapshot(tckpt.find_latest_snapshot(run))
    assert meta["cur_nimg"] == 72 and meta["warp_mode"] == runs


def test_loop_scores_its_metrics_after_each_snapshot(first_run, tmp_path, monkeypatch):
    """training.metrics=[fvd2048_16f] with a small detector registered as 'i3d'
    and the item overrides of training.metric_kwargs: one
    metric-fvd2048_16f.jsonl row per snapshot, with the fields of the JAX
    loop's rows (its metric_main.report_metric)."""
    _, ds, _, _ = first_run
    monkeypatch.setitem(tmu._custom_detectors, "i3d",
                        lambda **_: tmu._stub_detector("i3d"))
    run = tmp_path / "run"
    setup = tiny_setup(ds, str(run), metrics=["fvd2048_16f"],
                       metric_kwargs=dict(max_real_override=4, num_gen_override=3,
                                          cache_dir=str(tmp_path / "cache")))
    tloop.training_loop(setup, device=torch.device("cpu"), log=lambda *_: None)
    rows = [json.loads(line) for line in open(run / "metric-fvd2048_16f.jsonl")]
    _, snaps = expected_schedule(0, 0.05, 0.02, 2)
    assert [r["snapshot_nimg"] for r in rows] == snaps
    assert all(np.isfinite(r["results"]["fvd2048_16f"]) for r in rows)
    jmm.report_metric(dict(metric="fvd2048_16f", results={"fvd2048_16f": 1.0},
                           total_time=1.0, num_runs=1),
                      run_dir=str(tmp_path / "jax"), snapshot_nimg=snaps[0])
    want = json.loads(open(tmp_path / "jax" / "metric-fvd2048_16f.jsonl").read())
    assert [set(r) for r in rows] == [set(want)] * len(snaps)
    assert [r["snapshot"] for r in rows] == [want["snapshot"]] * len(snaps)
    assert len(os.listdir(tmp_path / "cache")) == 1        # the real stats, once


def test_a_failed_metric_is_logged_and_training_goes_on(first_run, tmp_path, monkeypatch):
    _, ds, _, _ = first_run

    def broken(**_):
        raise OSError("detector file unreadable")

    monkeypatch.setitem(tmu._custom_detectors, "i3d", broken)
    lines = []
    setup = tiny_setup(ds, str(tmp_path / "run"), metrics=["fvd2048_16f"],
                       metric_kwargs=dict(cache=False))
    tloop.run_metrics(setup, small_state()[0].G_ema, torch.device("cpu"), 48, lines.append)
    assert "metric evaluation failed: OSError('detector file unreadable')" in lines[0]
    assert "Traceback" in lines[1]
    assert not os.path.exists(tmp_path / "run" / "metric-fvd2048_16f.jsonl")
