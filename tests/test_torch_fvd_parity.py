"""The port's FVD ranking-parity harness, `python -m stylegan_v_tpu_torch.fvd_parity`,
on the CPU.

  * Its copies of snapshot_id, load_ref_jsonl and stage_rank_agreement equal
    scripts/fvd_parity.py's (loaded by path), the rho >= 0.8 and
    best-checkpoint rule included.
  * In stub mode (SGV_STUB_DETECTORS=1, --device cpu) the CLI runs end to
    end over two tiny port snapshots (the second's G_ema perturbed, as
    tests/test_fvd_parity.py makes its two) against a reference-format
    jsonl: the report has the JAX test's fields.
  * Without a detector directory and without stub mode it exits 3.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from stylegan_v_tpu_torch import fvd_parity as tfp
from stylegan_v_tpu_torch.io.checkpoint import save_snapshot
from stylegan_v_tpu_torch.models import Discriminator, Generator
from stylegan_v_tpu_torch.training import train_step as tts
from test_data import build_video_dataset_dir
from test_torch_models import port_cfg, small_disc_cfg, small_gen_cfg
from test_torch_train import one_torch_thread

__all__ = ["one_torch_thread"]        # the fixture, from test_torch_train.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jfp():
    spec = importlib.util.spec_from_file_location(
        "fvd_parity", os.path.join(REPO, "scripts", "fvd_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_snapshot_id_equals_the_jax_script(jfp):
    paths = ["runs/x/network-snapshot-000123.pkl", "runs/x/network-snapshot-000048/",
             "network-snapshot-000048", "network-snapshot-1234567.pkl", "a/b/ckpt.pkl",
             "runs/x/network-snapshot-000123.pt", "run/12/", "x"]
    assert [tfp.snapshot_id(p) for p in paths] == [jfp.snapshot_id(p) for p in paths]
    # the port's own snapshots by their stem
    assert tfp.checkpoint_id("runs/x/network-snapshot-000123.pt") == "000123"
    assert tfp.checkpoint_id("runs/x/network-snapshot-000123.pkl") == "000123"


def test_load_ref_jsonl_equals_the_jax_script(jfp, tmp_path):
    rows = [{"results": {"fvd2048_16f": 120.5}, "snapshot_pkl": "network-snapshot-000048.pkl"},
            {"results": {"fvd2048_16f": 80.0}, "snapshot": "network-snapshot-000096"},
            {"results": {"fid50k_full": 3.0}, "snapshot_pkl": "network-snapshot-000144.pkl"},
            {"results": {"fvd2048_16f": 70.0}}]
    path = tmp_path / "metric-fvd2048_16f.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    for arg in (str(path), str(tmp_path)):
        got = tfp.load_ref_jsonl(arg)
        assert got == jfp.load_ref_jsonl(arg) == {"000048": 120.5, "000096": 80.0}


@pytest.mark.parametrize("ours, ref", [
    ({"a": 10.0, "b": 5.0, "c": 7.0}, {"a": 100.0, "b": 50.0, "c": 70.0, "d": 1.0}),
    ({"a": 10.0, "b": 5.0, "c": 7.0}, {"a": 1.0, "b": 100.0, "c": 50.0}),
    ({"a": 1.0, "b": 2.0, "c": 3.0, "d": 4.0}, {"a": 1.0, "b": 3.0, "c": 2.0, "d": 4.0}),
    ({"a": 1.0, "b": 2.0}, {"b": 5.0, "c": 1.0}),
])
def test_stage_rank_agreement_equals_the_jax_script(jfp, ours, ref):
    got, want = {}, {}
    assert tfp.stage_rank_agreement(ours, ref, got) == jfp.stage_rank_agreement(ours, ref, want)
    assert got == want


def test_the_rule_passes_an_agreeing_order_and_fails_an_inverted_one():
    ours = {"a": 10.0, "b": 5.0, "c": 7.0}
    report = {}
    assert tfp.stage_rank_agreement(ours, {"a": 100.0, "b": 50.0, "c": 70.0}, report)
    ra = report["rank_agreement"]
    assert ra["spearman_rho"] == 1.0 and ra["best_ckpt_agrees"]
    assert not tfp.stage_rank_agreement(ours, {"a": 1.0, "b": 100.0, "c": 50.0}, {})


@pytest.fixture(scope="module")
def run(tmp_path_factory, one_torch_thread):
    """Two port snapshots of a small G (the second with G_ema moved by 0.05),
    a 32^2 dataset of 4 videos of 24 frames, and a reference-format jsonl."""
    root = tmp_path_factory.mktemp("parity")
    data = build_video_dataset_dir(str(root), num_videos=4, frames_per_video=24, res=32)
    gcfg, dcfg = port_cfg(small_gen_cfg()), port_cfg(small_disc_cfg())
    gen = torch.Generator().manual_seed(5)
    state = tts.init_train_state(Generator(gcfg, generator=gen), Discriminator(dcfg, generator=gen),
                                 tts.OptimizerConfig(), tts.OptimizerConfig(),
                                 tts.TrainingConfig(batch_size=4))
    run_dir = str(root / "run")
    save_snapshot(run_dir, state, 48_000, configs={"G": gcfg, "D": dcfg})
    with torch.no_grad():
        for p in state.G_ema.parameters():
            p.add_(0.05)
    save_snapshot(run_dir, state, 96_000, configs={"G": gcfg, "D": dcfg})
    ref = root / "metric-fvd2048_16f.jsonl"
    ref.write_text("".join(json.dumps({"results": {"fvd2048_16f": v}, "metric": "fvd2048_16f",
                                       "snapshot_pkl": s}) + "\n"
                           for s, v in [("network-snapshot-000048.pkl", 120.0),
                                        ("network-snapshot-000096.pkl", 80.0)]))
    return root, data, run_dir, str(ref)


def test_stub_mode_runs_end_to_end(run, monkeypatch, capsys):
    root, data, run_dir, ref = run
    monkeypatch.setenv("SGV_STUB_DETECTORS", "1")
    monkeypatch.setenv("HOME", str(root / "home"))                 # the metric stats cache
    out = root / "fvd_parity.json"
    rc = tfp.main(["--data", data, "--ckpts", os.path.join(run_dir, "network-snapshot-*"),
                   "--ref-jsonl", ref, "--out", str(out), "--max-real", "4", "--num-gen", "4",
                   "--device", "cpu"])
    assert rc in (0, 2)
    report = json.loads(out.read_text())
    assert report["detector_gate"]["status"] == "stubbed"
    assert set(report["ours"]) == {"000048", "000096"}
    assert all(np.isfinite(v) for v in report["ours"].values())
    ra = report["rank_agreement"]
    assert ra["status"] == "ok" and ra["n"] == 2
    assert "spearman_rho" in ra and "best_ckpt_agrees" in ra
    assert report["parity"] == (rc == 0)
    assert "[2/3] FVD sweep over 2 checkpoints..." in capsys.readouterr().out


def test_without_detectors_or_stub_mode_it_exits_3(run, monkeypatch, capsys):
    root, data, run_dir, ref = run
    monkeypatch.delenv("SGV_STUB_DETECTORS", raising=False)
    rc = tfp.main(["--detectors", str(root / "no_detectors"), "--data", data,
                   "--ckpts", os.path.join(run_dir, "network-snapshot-*"), "--ref-jsonl", ref,
                   "--out", str(root / "never.json"), "--device", "cpu"])
    assert rc == 3 and not (root / "never.json").exists()
    out = capsys.readouterr().out
    assert "[1/3] detector gate: missing" in out and "Blocked on external input #1" in out
