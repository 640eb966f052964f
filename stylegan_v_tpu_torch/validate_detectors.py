"""Validate the port's detector modules against the REAL TorchScript files.

    python -m stylegan_v_tpu_torch.validate_detectors --detector-dir detectors/

The counterpart of scripts/validate_detectors.py (the JAX package's), with its
flags plus `--device` (default cuda:0; no card raises, `--device cpu` runs on
the CPU). With a reference file present, the metrics load its state_dict
into the port's own I3D, InceptionV3 or C3D and run that on the device
(metrics/metric_utils.py:_port_detector); this tool holds that path to the
file's own forward.

For each detector file found it runs the TorchScript module on the CPU in
float32, called as the metrics call it (raw uint8, the reference kwargs):
the reference by design, as in the JAX script. Beside it, the port's path on
`--device` with TF32 off, on the same fixed seeded inputs (`fixture_inputs`),
at the detector's native size and at 256^2. Each case passes at max_rel <=
1e-3 and mean_rel <= 1e-4 of the reference's mean absolute feature. It
writes `detector_fixtures.json` in the JAX script's schema (md5 and a sample
of the TorchScript's features a case), so one file serves both packages:
tests/test_torch_detector_fixtures.py holds the port's modules to its
recorded features when the file and the detectors are present.

Exit codes, as the JAX script's: 0 every case passed, 1 no detector file
found, 2 a case failed.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
from typing import Dict, List, Optional

import numpy as np


def _md5(a: np.ndarray) -> str:
    return hashlib.md5(np.ascontiguousarray(a, np.float32).tobytes()).hexdigest()


def fixture_inputs(name: str):
    """Deterministic per-case uint8 inputs, shared by this script, the JAX
    script and both packages' fixtures tests so recorded reference features
    stay reproducible byte-for-byte."""
    rng = np.random.RandomState(0)
    if name == "i3d":
        return [(f"{r}^2", rng.randint(0, 255, (4, 16, r, r, 3))
                 .astype(np.uint8)) for r in (224, 256)]
    if name == "c3d_ucf101":
        return [(f"{r}^2", rng.randint(0, 255, (4, 16, r, r, 3))
                 .astype(np.uint8)) for r in (112, 256)]
    if name == "inception":
        cases = [(f"{r}^2 feats", rng.randint(0, 255, (8, r, r, 3))
                  .astype(np.uint8)) for r in (299, 256)]
        cases.append(("256^2 probs",
                      rng.randint(0, 255, (8, 256, 256, 3)).astype(np.uint8)))
        return cases
    raise ValueError(name)


# reference detector kwargs per case, in fixture_inputs order (FVD:
# frechet_video_distance.py:23; FID: return_features; IS: no_output_bias)
CASE_TORCH_KWARGS = {
    "i3d": [dict(rescale=True, resize=True, return_features=True)] * 2,
    "c3d_ucf101": [{}] * 2,
    "inception": [dict(return_features=True), dict(return_features=True),
                  dict(no_output_bias=True)],
}

MAX_REL, MEAN_REL = 1e-3, 1e-4        # the gate, of the reference's mean absolute feature


def has_mean_cube(state_dict) -> bool:
    """Whether a C3D state_dict carries the per-pixel mean cube, by the rule
    metrics/detectors/c3d.py:load_c3d_state_dict loads it with."""
    return any("mean" in k.split(".")[-1].lower() and v.squeeze().ndim == 4
               for k, v in state_dict.items())


def port_case_fns(name: str, path: str, device) -> Dict[str, object]:
    """label -> the port's features function for that case, built by the
    metrics' own loader with the case's reference kwargs."""
    from .metrics import metric_utils
    fns, by_kwargs = {}, {}
    for (label, _), kw in zip(fixture_inputs(name), CASE_TORCH_KWARGS[name]):
        key = repr(sorted(kw.items()))
        if key not in by_kwargs:
            by_kwargs[key] = metric_utils._port_detector(name, path, device, **kw)
        fns[label] = by_kwargs[key]
    return fns


def validate(name: str, path: str, out: dict, device="cuda:0") -> bool:
    """Gate the port's module for detector `name` on `device` against the
    TorchScript file at `path` on the CPU, at NATIVE resolution (the
    detector's internal operating size, where any resize is a no-op) AND at
    256^2, invoking the TorchScript as the metrics do (raw uint8, reference
    kwargs), so the gate covers its preprocessing too. Records the cases in
    out[name]; returns whether every case passed."""
    import torch
    from .utils.misc import float32_precision

    model = torch.jit.load(path, map_location="cpu").eval()

    def torch_raw(arr, **kwargs):
        perm = (0, 4, 1, 2, 3) if arr.ndim == 5 else (0, 3, 1, 2)
        with torch.no_grad():
            return model(torch.from_numpy(
                np.ascontiguousarray(arr.transpose(perm))), **kwargs).float().numpy()

    port_fns = port_case_fns(name, path, device)
    cases = []   # (label, want, got)
    with float32_precision(False):
        for (label, inp), kw in zip(fixture_inputs(name), CASE_TORCH_KWARGS[name]):
            cases.append((label, torch_raw(inp, **kw), port_fns[label](inp)))
    if name == "c3d_ucf101" and not has_mean_cube(model.state_dict()):
        print(f"{name:12s} NOTE: no mean buffer found in the TorchScript "
              f"state_dict — the port's path uses the channel-mean fallback")

    ok = True
    out[name] = {"file": os.path.basename(path), "input_seed": 0, "cases": {}}
    for label, want, got in cases:
        scale = np.abs(want).mean() + 1e-8
        max_rel = float(np.abs(want - got).max() / scale)
        mean_rel = float(np.abs(want - got).mean() / scale)
        case_ok = max_rel <= MAX_REL and mean_rel <= MEAN_REL
        ok &= case_ok
        print(f"{name:12s} {label:12s} max_rel {max_rel:.2e}  "
              f"mean_rel {mean_rel:.2e}  {'OK' if case_ok else 'FAIL'}", flush=True)
        out[name]["cases"][label] = {
            "torch_features_md5": _md5(want),
            "want_sample": [round(float(v), 6) for v in
                            np.asarray(want, np.float64).ravel()[:16]],
            "want_mean_abs": float(np.abs(want).mean()),
            "max_rel": max_rel, "mean_rel": mean_rel, "ok": case_ok}
    out[name]["ok"] = ok
    return ok


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--detector-dir", default=os.environ.get("SGV_DETECTOR_DIR", "detectors"))
    ap.add_argument("--out", default="detector_fixtures.json")
    ap.add_argument("--device", default="cuda:0", help="cuda:0 (the default), cuda:N or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    """The CLI; returns the exit code (0 passed, 1 no file, 2 a case failed)."""
    from .metrics.metric_utils import DETECTOR_FILES
    from .training.loop import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    results, all_ok, found = {}, True, 0
    for name, fname in DETECTOR_FILES.items():
        path = os.path.join(args.detector_dir, fname)
        if not os.path.exists(path):
            print(f"{name:12s} SKIP ({path} not found — "
                  f"run scripts/download_detectors.py)")
            continue
        found += 1
        all_ok &= validate(name, path, results, device)

    if results:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"wrote {args.out}")
    if not found:
        print("No detector files found; nothing validated.")
        return 1
    return 0 if all_ok else 2


if __name__ == "__main__":
    raise SystemExit(main())
