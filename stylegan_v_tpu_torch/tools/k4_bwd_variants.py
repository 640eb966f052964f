"""Time variants of the K4-bwd kernel (csrc/affine_warp_bwd.cu) at the ADA
step's warp, to see where its time goes.

    python3 -m stylegan_v_tpu_torch.tools.k4_bwd_variants

Each variant is a copy of the kernel's source (and of affine_warp.cuh) with
one edit, built with the port's nvcc flags into a temporary directory and
called through ctypes with the wrapper's arguments. They all run on the
pipe's own warp at 16 videos x 3 frames: dy [16, 9, 524, 524] -> dx
[16, 9, 536, 536] in bfloat16, reflect mode, G_inv from the bgc pipe at
p = 1 (as chip_smoke.py phase 10 takes it). CUDA-event times in turns,
twice; each variant's worst error against the plain version is printed
beside its registers and spills (only the unchanged kernel is exact):

  final       the kernel as it is
  enum_only   the enumeration alone: each candidate adds 1, no geometry
  no_loads    the enumeration and the geometry, no dy loads
  pixel1x1    one input pixel a thread (QX = QY = 1)
  pixel2x2    2 x 2 input pixels a thread
  regs128     the kernel at up to 128 registers a thread (2 blocks an SM)

Needs a CUDA device and nvcc; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import cuda_build, grid_sample
from ..training import augment

CSRC = Path(cuda_build.__file__).resolve().parents[1] / "csrc"
VISIT = "                                        float yh) {\n"
MATCH = "    if ((q[0] & q[1] & q[2] & q[3]) < 0) return;\n"
PIXELS = ("constexpr int QX = 1;                   // input pixels a thread owns: QX x QY\n"
          "constexpr int QY = 2;\n")
BOUNDS = "__global__ void __launch_bounds__(THREADS, 3)"


def pixels(qx: int, qy: int):
    return PIXELS, f"constexpr int QX = {qx};\nconstexpr int QY = {qy};\n"


VARIANTS = {
    "final": [],
    "enum_only": [(VISIT, VISIT + "    acc[0][0] += 1.0f;\n    return;\n")],
    "no_loads": [(MATCH, MATCH + "    acc[0][0] += t.wx;\n    return;\n")],
    "pixel1x1": [pixels(1, 1)],
    "pixel2x2": [pixels(2, 2)],
    "regs128": [(BOUNDS, "__global__ void __launch_bounds__(THREADS, 2)")],
}


def build(root: Path):
    """Start one nvcc for each variant; returns {name: (library, process)}."""
    source = (CSRC / "affine_warp_bwd.cu").read_text()
    started = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the kernel source has changed")
            text = text.replace(old, new)
        d = root / name
        d.mkdir()
        (d / "affine_warp_bwd.cu").write_text(text)
        (d / "affine_warp.cuh").write_text((CSRC / "affine_warp.cuh").read_text())
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(d / "lib.so"), str(d / "affine_warp_bwd.cu")]
        started[name] = (d / "lib.so", subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True))
    return started


def step_warp(dev):
    """The ADA pipe's warp_upsample=2 call at 16 x 3: (shape, G_inv, out_h, out_w)."""
    calls, warp = [], augment.affine_grid_sample

    def recorded(x, G_inv, out_h, out_w, mode="reflect"):
        calls.append((tuple(x.shape), G_inv.detach().clone(), out_h, out_w))
        return warp(x, G_inv, out_h, out_w, mode)

    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.rand(16, 9, 256, 256, generator=g, device=dev) * 2 - 1
    pipe = augment.make_augment_pipe(augment.AugmentConfig(**augment.AUGPIPE_SPECS["bgc"],
                                                           warp_upsample=2))
    augment.affine_grid_sample = recorded
    try:
        with torch.no_grad():
            pipe(g, x, torch.ones((), device=dev))
    finally:
        augment.affine_grid_sample = warp
    return calls[0]


def cuda_ms(fn, iters: int = 10) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k4_bwd_variants needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        fns = {}
        for name, (lib, proc) in build(Path(tmp)).items():
            out, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"variant {name} failed to build:\n{out}")
            ptxas = [line.split(":", 1)[-1].strip() for line in out.splitlines()
                     if "registers" in line or "spill" in line]
            print(f"{name}: {' / '.join(ptxas)}")
            fn = ctypes.CDLL(str(lib)).affine_warp_bwd
            fn.argtypes, fn.restype = list(grid_sample._ARGTYPES), ctypes.c_int
            fns[name] = fn
        (N, C, H, W), G, out_h, out_w = step_warp(dev)
        dy = torch.randn(N, C, out_h, out_w, generator=torch.Generator(device=dev).manual_seed(7),
                         device=dev).to(torch.bfloat16)
        want = grid_sample.affine_grid_sample_bwd_plain(dy, G, H, W).float()
        dx = torch.empty(N, C, H, W, dtype=dy.dtype, device=dev)

        def call(fn):
            err = fn(dy.data_ptr(), G.data_ptr(), dx.data_ptr(), 1, 0, N, C, H, W, out_h, out_w,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")

        for name, fn in fns.items():
            call(fn)
            torch.cuda.synchronize()
            print(f"{name}: max_abs_err {(dx.float() - want).abs().max().item():.3g}")
        order = list(fns) + list(fns)[::-1]
        ms = {name: [] for name in fns}
        for _ in range(2):
            for name in order:
                call(fns[name])                                       # warm
                ms[name].append(cuda_ms(lambda: call(fns[name])))
        for name, t in ms.items():
            print(f"{name:10s} {min(t):.4f}-{max(t):.4f} ms over {len(t)} turns")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
