"""Validation of the shear warp executor on the card, at every resolution.

    python -m stylegan_v_tpu_torch.validate_shear_onchip
    python -m stylegan_v_tpu_torch.validate_shear_onchip --res 32,64 --device cpu

The counterpart of scripts/validate_shear_onchip.py (the JAX package's), with
its draws plus `--device` (default cuda:0; no card raises, `--device cpu`
runs on the CPU). For each resolution from 32^2 to 1024^2 it runs the
anti-aliased warp of the ADA pipe (training/augment.py:_warp_antialiased)
with warp_mode="shear" and bf16 geometry (K7, then K8 and K7-bwd in the
backward) against warp_mode="gather" with float32 geometry (K4) on the same
images and maps, with the JAX script's Hz_pad of 6 (`--hz-pad 3` gives the
pipe's canvases, (res + 12) * 2): the PSNR of the interior ([8:-8]; the
peak is the reference's range), and whether the gradient of sum(|warp|) is finite. A resolution
passes at PSNR > 28 dB with finite outputs and gradient; one that fails
prints FAIL and makes the script exit 1 (the JAX script only prints).

The draws are the JAX script's: one np.random.RandomState(0) in the order
32, 64, ..., 1024; at each, B images of 9 channels (B = 4 up to 256^2, 2 at
512^2, 1 at 1024^2), theta uniform in [-pi, pi], per-axis scales in
[0.7, 1.4]. `--res` runs a subset and keeps each one's draws. Each
resolution also prints the forward's and the forward + backward's ms: CUDA
events on the card, the host clock on the CPU.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

RESOLUTIONS = (32, 64, 128, 256, 512, 1024)
CHANNELS = 9
HZ_PAD = 6                 # the JAX script's Hz_pad; the pipe's is 3 (len(_SYM6) // 4)
BORDER = 8                 # the PSNR's excluded border, in output pixels
PSNR_GATE = 28.0           # dB


def batch_size(res: int) -> int:
    return 4 if res <= 256 else (2 if res <= 512 else 1)


def draws(resolutions=RESOLUTIONS) -> Dict[int, tuple]:
    """{res: (x [B, res, res, 9], theta [B], sx [B], sy [B])} as numpy, drawn in
    the JAX script's order from RandomState(0); a resolution not asked for is
    drawn and dropped, so every one gets the same numbers alone or in a set."""
    rng = np.random.RandomState(0)
    out = {}
    for res in RESOLUTIONS:
        B = batch_size(res)
        x = rng.randn(B, res, res, CHANNELS).astype(np.float32)
        th = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
        sx = np.asarray(rng.uniform(0.7, 1.4, B), np.float32)
        sy = np.asarray(rng.uniform(0.7, 1.4, B), np.float32)
        if res in resolutions:
            out[res] = (x, th, sx, sy)
        if res >= max(resolutions):
            break
    return out


def psnr(ref: np.ndarray, got: np.ndarray) -> float:
    """The JAX script's PSNR: the interior's squared error against the peak
    of the whole reference's range. Both NCHW."""
    d = (ref - got)[:, :, BORDER:-BORDER, BORDER:-BORDER]
    peak = ref.max() - ref.min()
    return float(10 * np.log10(peak ** 2 / np.mean(d.astype(np.float64) ** 2)))


def timed_ms(fn, device: torch.device, iters: int) -> float:
    """Mean ms of fn() after one warm call: CUDA events on the card, the host
    clock on the CPU."""
    fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def validate(res: int, case, device: torch.device, iters: int = 10,
             hz_pad: int = HZ_PAD) -> Dict:
    """One resolution: the shear warp (bf16 geometry) against the gather warp
    (float32 geometry) on `device`; returns psnr, finiteness, ms and ok."""
    from .ops import setup_filter
    from .training.augment import _SYM6, _warp_antialiased, rotate2d, scale2d

    x_np, th, sx, sy = case
    x = torch.from_numpy(x_np).permute(0, 3, 1, 2).contiguous().to(device)   # NHWC -> NCHW
    G = (rotate2d(torch.from_numpy(th)) @ scale2d(torch.from_numpy(sx), torch.from_numpy(sy))
         ).to(device)
    Hz = setup_filter(_SYM6).to(device)

    def shear(images):
        return _warp_antialiased(images, G, Hz, hz_pad, geom_dtype="bfloat16",
                                 warp_mode="shear")

    def shear_grad():
        xg = x.detach().requires_grad_(True)
        shear(xg).float().abs().sum().backward()
        return xg.grad

    with torch.no_grad():
        got = shear(x)
        ref = _warp_antialiased(x, G, Hz, hz_pad, geom_dtype="float32", warp_mode="gather")
    grad = shear_grad()
    grad_finite = bool(torch.isfinite(grad).all())
    finite = bool(torch.isfinite(got).all()) and grad_finite
    value = psnr(ref.cpu().numpy(), got.float().cpu().numpy())
    with torch.no_grad():
        fwd_ms = timed_ms(lambda: shear(x), device, iters)
    bwd_ms = timed_ms(shear_grad, device, iters)
    ok = finite and value > PSNR_GATE
    return {"res": res, "batch": x.shape[0], "canvas": (res + 4 * hz_pad) * 2, "psnr": value,
            "grad_finite": grad_finite, "finite": finite, "fwd_ms": fwd_ms,
            "fwd_bwd_ms": bwd_ms, "ok": ok}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--res", default=",".join(map(str, RESOLUTIONS)),
                    help="comma-separated resolutions, a subset of 32,64,...,1024")
    ap.add_argument("--hz-pad", type=int, default=HZ_PAD,
                    help="the warp's Hz_pad: 6 as the JAX script, 3 as the ADA pipe (whose "
                         "canvases are (res + 12) * 2)")
    ap.add_argument("--iters", type=int, default=10, help="timed calls of each direction")
    ap.add_argument("--device", default="cuda:0", help="cuda:0 (the default), cuda:N or cpu")
    args = ap.parse_args(argv)
    if args.iters < 1:
        ap.error("--iters must be at least 1")
    return args


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    """The CLI; returns a row a resolution and raises SystemExit(1) when any failed."""
    from .training.loop import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    wanted = sorted(int(r) for r in args.res.split(","))
    unknown = set(wanted) - set(RESOLUTIONS)
    if unknown:
        raise ValueError(f"resolutions {sorted(unknown)} are not among {RESOLUTIONS}")
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={device} ({name})  shear: bf16 geometry, K7 / K8 + K7-bwd; "
          f"gather: float32 geometry, K4; ms by {clock}", flush=True)
    rows = []
    for res, case in draws(wanted).items():
        r = validate(res, case, device, args.iters, args.hz_pad)
        rows.append(r)
        print(f"res {res:5d}: psnr {r['psnr']:6.1f} dB  grad finite {r['grad_finite']}  "
              f"fwd {r['fwd_ms']:.3f} ms  fwd+bwd {r['fwd_bwd_ms']:.3f} ms  (B={r['batch']}, "
              f"canvas {r['canvas']}^2)  -> {'PASS' if r['ok'] else 'FAIL'}",
              flush=True)
    print("verdict:", {r["res"]: r["ok"] for r in rows}, flush=True)
    if not all(r["ok"] for r in rows):
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
