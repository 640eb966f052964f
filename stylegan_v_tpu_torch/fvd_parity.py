"""One-command FVD ranking-parity harness of the port: the BASELINE north-star gate.

    python -m stylegan_v_tpu_torch.fvd_parity --detectors detectors/ \\
        --data /data/ffs_256.zip --ckpts 'runs/ref_ffs/network-snapshot-*.pkl' \\
        --ref-jsonl runs/ref_ffs/metric-fvd2048_16f.jsonl

The counterpart of scripts/fvd_parity.py (the JAX package's), with its flags
plus `--device` (default cuda:0; no card raises, `--device cpu` runs on the
CPU). Stages, each skipped only for a missing input, never silently:
  1. DETECTOR GATE: the port's I3D against the real TorchScript file at
     native and 256^2 inputs (max_rel <= 1e-3, mean_rel <= 1e-4), through
     validate_detectors.validate.
  2. FVD SWEEP: fvd2048_16f of each checkpoint (a reference
     network-snapshot-*.pkl through io/legacy.py, or the port's own
     network-snapshot-*.pt, by generate.load_any_checkpoint) against --data,
     on --device.
  3. RANK AGREEMENT: the checkpoints matched to the reference's
     metric-fvd2048_16f.jsonl by snapshot id; Spearman rho, Kendall tau and
     best-checkpoint agreement. Parity needs rho >= 0.8 and the same best
     checkpoint.

SGV_STUB_DETECTORS=1 runs the whole pipeline with the metrics' stub
detector (stage 1 reported as "stubbed"). The real run waits for three
inputs that are not in the repository: detectors/i3d_torchscript.pt, a
reference run's snapshots with the metric-fvd2048_16f.jsonl it wrote for
them, and the dataset zip it trained on.

Exit codes, as the JAX script's: 0 parity, 2 no parity, 3 the I3D file is
missing (outside stub mode).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import List, Optional

import numpy as np


def snapshot_id(path: str) -> str:
    """'network-snapshot-000123.pkl' / orbax 'network-snapshot-000123' -> '000123'."""
    m = re.search(r"(\d{4,})(?:\.pkl)?/?$", os.path.basename(path.rstrip("/")))
    return m.group(1) if m else os.path.basename(path.rstrip("/"))


def checkpoint_id(path: str) -> str:
    """snapshot_id of a checkpoint, the port's .pt snapshots by their stem."""
    return snapshot_id(path[:-len(".pt")] if path.endswith(".pt") else path)


def stage_detector_gate(detector_dir: str, report: dict, device="cuda:0") -> bool:
    if os.environ.get("SGV_STUB_DETECTORS"):
        report["detector_gate"] = {"status": "stubbed",
                                   "note": "SGV_STUB_DETECTORS=1 (CI mode)"}
        return True
    path = os.path.join(detector_dir, "i3d_torchscript.pt")
    if not os.path.exists(path):
        report["detector_gate"] = {
            "status": "missing",
            "note": f"{path} not found — fetch with scripts/download_detectors.py"}
        return False
    from .validate_detectors import validate
    out: dict = {}
    ok = validate("i3d", path, out, device)
    report["detector_gate"] = {"status": "ok" if ok else "FAILED",
                               "cases": out["i3d"]["cases"]}
    return ok


def stage_fvd_sweep(ckpt_paths, data: str, detector_dir, report: dict, device="cuda:0",
                    max_real=None, num_gen=None) -> dict:
    from .generate import load_any_checkpoint
    from .metrics import metric_main

    ours = {}
    for path in ckpt_paths:
        G = load_any_checkpoint(path, device)
        dataset_kwargs = dict(path=data, sampling=G.cfg.sampling,
                              max_num_frames=G.cfg.sampling.max_num_frames,
                              resolution=G.cfg.img_resolution)
        kwargs = {}
        if max_real is not None:
            kwargs["max_real_override"] = max_real
        if num_gen is not None:
            kwargs["num_gen_override"] = num_gen
        r = metric_main.calc_metric(
            metric="fvd2048_16f", G=G, dataset_kwargs=dataset_kwargs,
            detector_dir=detector_dir, device=device, **kwargs)
        sid = checkpoint_id(path)
        ours[sid] = float(r["results"]["fvd2048_16f"])
        print(f"  {sid}: fvd2048_16f = {ours[sid]:.2f}", flush=True)
    report["ours"] = ours
    return ours


def load_ref_jsonl(path: str) -> dict:
    """Reference metric-fvd2048_16f.jsonl -> {snapshot_id: fvd}
    (reference metric_main.py:81-91 line format)."""
    if os.path.isdir(path):
        path = os.path.join(path, "metric-fvd2048_16f.jsonl")
    ref = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            res = rec.get("results", {})
            val = res.get("fvd2048_16f")
            snap = rec.get("snapshot_pkl") or rec.get("snapshot") or ""
            if val is not None and snap:
                ref[snapshot_id(snap)] = float(val)
    return ref


def stage_rank_agreement(ours: dict, ref: dict, report: dict) -> bool:
    common = sorted(set(ours) & set(ref))
    report["matched_snapshots"] = common
    if len(common) < 2:
        report["rank_agreement"] = {
            "status": "insufficient",
            "note": f"{len(common)} matched snapshots (need >= 2)"}
        return False
    a = np.array([ours[k] for k in common])
    b = np.array([ref[k] for k in common])
    from scipy import stats
    rho = float(stats.spearmanr(a, b).statistic)
    tau = float(stats.kendalltau(a, b).statistic)
    argmin_agree = bool(common[int(np.argmin(a))] == common[int(np.argmin(b))])
    report["rank_agreement"] = {
        "status": "ok", "n": len(common), "spearman_rho": round(rho, 4),
        "kendall_tau": round(tau, 4), "best_ckpt_agrees": argmin_agree,
        "pairs": {k: {"ours": round(ours[k], 2), "ref": round(ref[k], 2)}
                  for k in common}}
    return rho >= 0.8 and argmin_agree


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--detectors", default=os.environ.get("SGV_DETECTOR_DIR", "detectors"))
    ap.add_argument("--data", required=True, help="real dataset dir/zip")
    ap.add_argument("--ckpts", required=True,
                    help="glob of checkpoints (.pkl files or the port's .pt snapshots)")
    ap.add_argument("--ref-jsonl", required=True,
                    help="reference metric-fvd2048_16f.jsonl (or its run dir)")
    ap.add_argument("--out", default="fvd_parity.json")
    ap.add_argument("--max-real", type=int, default=None,
                    help="override real-item count (CI shrink)")
    ap.add_argument("--num-gen", type=int, default=None,
                    help="override generated-item count (CI shrink)")
    ap.add_argument("--device", default="cuda:0", help="cuda:0 (the default), cuda:N or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    """The CLI; returns the exit code (0 parity, 2 no parity, 3 no I3D file)."""
    from .training.loop import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    report: dict = {}
    gate_ok = stage_detector_gate(args.detectors, report, device)
    print(f"[1/3] detector gate: {report['detector_gate']['status']}", flush=True)
    if not gate_ok and report["detector_gate"]["status"] == "missing":
        print(json.dumps(report))
        print("\nBlocked on external input #1 (see module docstring).")
        return 3

    ckpts = sorted(glob.glob(args.ckpts)) or [args.ckpts]
    # the glob may also catch the snapshots' .meta.json sidecars: drop them
    ckpts = [p for p in ckpts if os.path.isfile(p) and p.endswith((".pkl", ".pt"))]
    if not ckpts:
        raise SystemExit(f"no checkpoints match {args.ckpts!r}")
    print(f"[2/3] FVD sweep over {len(ckpts)} checkpoints...", flush=True)
    ours = stage_fvd_sweep(ckpts, args.data, args.detectors, report, device,
                           max_real=args.max_real, num_gen=args.num_gen)

    print("[3/3] rank agreement vs reference jsonl...", flush=True)
    ref = load_ref_jsonl(args.ref_jsonl)
    agree = stage_rank_agreement(ours, ref, report)
    report["parity"] = bool(gate_ok and agree)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report["rank_agreement"]))
    print(f"wrote {args.out}  parity={'PASS' if report['parity'] else 'FAIL'}", flush=True)
    return 0 if report["parity"] else 2


if __name__ == "__main__":
    raise SystemExit(main())
