"""Smoke run of the PyTorch port (stylegan_v_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, "generate a clip, then score it", at the
FFS-256 width and holds it against the port's plain PyTorch paths:

  1. device:  the card's name and power limit; TF32 off for cuDNN and matmul.
  2. build:   the downfirdn2d_x2 CUDA kernel, built with nvcc for sm_90a.
  3. kernel:  the kernel against its plain version at the six shapes of the
              Discriminator's resnet skips (2 videos x 3 frames), float32 and
              bf16, plus an asymmetric filter; CUDA-event times of both.
  4. slice:   G(z, None, t) for 4 videos x 3 timestamps, then D on the
              frames, with weights from a seeded torch.Generator; the frames
              and logits must be finite and the kernel must launch 6 times.
  5. speed:   synthesis frames/s at 32 videos x 8 frames.
  6. parity:  a reduced-width G->D on the card (with the kernel) against the
              same weights and inputs on the CPU (plain path).

Any failed check exits non-zero. The last two lines are the kernel record
and {"ok": true, "device": {...}}. There is no CPU path: without a CUDA
device the script fails.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

# Kernel vs plain: float32 sums in another order; bf16 rounds once from a float32 sum.
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# Card vs CPU at reduced width, float32 with TF32 off: cuDNN and the CPU sum in
# other orders through ~20 layers, relative to the output's scale.
PARITY_TOL = 1e-3
D_SKIP_SHAPES = [  # (frames or videos, C, H, W) at 2 videos x 3 frames, D's dtype there
    ((6, 64, 256, 256), "bfloat16"), ((6, 128, 128, 128), "bfloat16"),
    ((6, 256, 64, 64), "bfloat16"), ((6, 512, 32, 32), "bfloat16"),
    ((2, 768, 16, 16), "float32"), ((2, 512, 8, 8), "float32"),
]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def cuda_ms(fn, iters: int) -> float:
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi)
    print(f"[1 device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)
    return smi


def phase_build():
    from stylegan_v_tpu_torch.ops import fir_kernels
    t0 = time.perf_counter()
    lib = fir_kernels.build_library()
    print(f"[2 build] {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)


def phase_kernel(dev):
    import torch
    from stylegan_v_tpu_torch.ops import downfirdn2d_x2, downfirdn2d_x2_plain, setup_filter

    sym = setup_filter([1, 3, 3, 1])
    asym = (torch.arange(16, dtype=torch.float32).reshape(4, 4) - 5.0) / 40
    g = torch.Generator(device=dev).manual_seed(0)
    max_err, path_ms, path_plain_ms = 0.0, 0.0, 0.0
    for i, (shape, path_dtype) in enumerate(D_SKIP_SHAPES):
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            err = 0.0
            for name, f in [("sym", sym)] + ([("asym", asym)] if i == 0 else []):
                got, want = downfirdn2d_x2(x, f), downfirdn2d_x2_plain(x, f)
                torch.cuda.synchronize()
                e = (got.float() - want.float()).abs().max().item()
                tol = KERNEL_TOL[dtype_name]
                check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                      f"kernel vs plain {shape} {dtype_name} {name}: max err {e}")
                err = max(err, e)
            max_err = max(max_err, err)
            for _ in range(3):                        # warm-up
                downfirdn2d_x2(x, sym), downfirdn2d_x2_plain(x, sym)
            # in turns: plain, kernel, kernel, plain
            plain_a = cuda_ms(lambda: downfirdn2d_x2_plain(x, sym), 20)
            kern_a = cuda_ms(lambda: downfirdn2d_x2(x, sym), 20)
            kern_b = cuda_ms(lambda: downfirdn2d_x2(x, sym), 20)
            plain_b = cuda_ms(lambda: downfirdn2d_x2_plain(x, sym), 20)
            kern, plain = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
            if dtype_name == path_dtype:
                path_ms += kern
                path_plain_ms += plain
            gbps = x.numel() * x.element_size() * 1.25 / (kern * 1e-3) / 1e9
            print(f"[3 kernel] {list(shape)} {dtype_name}: max_abs_err {err:.3g}  "
                  f"kernel {kern:.4f} ms ({gbps:.0f} GB/s)  plain {plain:.4f} ms", flush=True)
    return max_err, path_ms, path_plain_ms


def ffs256_models(dev):
    import torch
    from stylegan_v_tpu_torch.models import (Discriminator, DiscriminatorConfig, Generator,
                                             GeneratorConfig)
    from stylegan_v_tpu_torch.models.config import replace

    gen = torch.Generator().manual_seed(0)
    G = Generator(replace(GeneratorConfig(), channel_base=16384), generator=gen)
    D = Discriminator(replace(DiscriminatorConfig(), channel_base=16384), generator=gen)
    return G.to(dev).eval(), D.to(dev).eval()


def phase_slice(dev, G, D):
    import torch
    from stylegan_v_tpu_torch.ops import downfirdn2d_x2

    g = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn(4, G.cfg.z_dim, generator=g, device=dev)
    t = torch.tensor([[0.0, 5.0, 17.0], [3.0, 20.0, 60.0], [100.0, 101.0, 130.0],
                      [500.0, 700.0, 1000.0]], device=dev)
    downfirdn2d_x2.launches = 0
    with torch.no_grad():
        frames = G(z, None, t, generator=g)
        logits = D(frames, None, t)["image_logits"]
    torch.cuda.synchronize()
    launches = downfirdn2d_x2.launches
    check(tuple(frames.shape) == (12, 3, 256, 256) and frames.dtype == torch.float32,
          f"frames {tuple(frames.shape)} {frames.dtype}")
    check(bool(torch.isfinite(frames).all()), "non-finite frames")
    check(tuple(logits.shape) == (4,) and bool(torch.isfinite(logits).all()),
          f"logits {logits.tolist()}")
    check(launches == 6, f"downfirdn2d_x2 launched {launches} times, expected 6")
    print(f"[4 slice] FFS-256 G->D: frames {list(frames.shape)} finite, std "
          f"{frames.std().item():.4f}; logits {[round(v, 4) for v in logits.tolist()]}; "
          f"downfirdn2d_x2 launches {launches}", flush=True)
    return launches


def phase_speed(dev, G, smi):
    import torch
    videos, frames, iters = 32, 8, 5
    g = torch.Generator(device=dev).manual_seed(2)
    z = torch.randn(videos, G.cfg.z_dim, generator=g, device=dev)
    t = torch.arange(frames, dtype=torch.float32, device=dev)[None].repeat(videos, 1)
    mz = G.synthesis.motion_encoder.sample_motion_z(videos, g)
    with torch.no_grad():
        for _ in range(2):                                   # warm-up
            G(z, None, t, motion_z=mz)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ms = cuda_ms(lambda: G(z, None, t, motion_z=mz), iters)
        wall = (time.perf_counter() - t0) / iters
    fps = videos * frames / (ms * 1e-3)
    print(f"[5 speed] FFS-256 synthesis {videos}x{frames}: {fps:.1f} frames/s "
          f"({ms:.2f} ms/batch device, {wall * 1e3:.2f} ms/batch host, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB) on {smi}", flush=True)


def phase_parity(dev):
    import torch
    from stylegan_v_tpu_torch.models import (Discriminator, DiscriminatorConfig, Generator,
                                             GeneratorConfig, MotionConfig, SamplingConfig,
                                             TimeEncConfig)
    from stylegan_v_tpu_torch.ops import downfirdn2d_x2

    sampling = SamplingConfig(num_frames_per_video=3, max_num_frames=128)
    gcfg = GeneratorConfig(  # tests/test_models.py:small_gen_cfg
        w_dim=64, z_dim=64, img_resolution=32, channel_base=1024, channel_max=64,
        num_bf16_res=0, mapping_layers=2,
        motion=MotionConfig(z_dim=32, v_dim=32, motion_z_distance=16, kernel_size=11),
        time_enc=TimeEncConfig(dim=32, min_period_len=16, max_period_len=1024),
        sampling=sampling)
    dcfg = DiscriminatorConfig(  # tests/test_models.py:small_disc_cfg
        img_resolution=32, channel_base=1024, channel_max=64, num_bf16_res=0,
        concat_res=8, mbstd_group_size=2, mapping_layers=2, sampling=sampling)
    gen = torch.Generator().manual_seed(3)
    G, D = Generator(gcfg, generator=gen).eval(), Discriminator(dcfg, generator=gen).eval()
    z = torch.randn(4, gcfg.z_dim, generator=gen)
    t = torch.tensor([[0.0, 3.0, 9.0], [2.0, 4.0, 30.0], [10.0, 50.0, 90.0],
                      [1.5, 64.25, 127.0]])
    mz = G.synthesis.motion_encoder.sample_motion_z(4, gen)

    def run(G, D, device):
        with torch.no_grad():
            frames = G(z.to(device), None, t.to(device), motion_z=mz.to(device))
            return frames.cpu(), D(frames, None, t.to(device))["image_logits"].cpu()

    before = downfirdn2d_x2.launches
    ref_frames, ref_logits = run(G, D, torch.device("cpu"))
    check(downfirdn2d_x2.launches == before, "the CPU run launched the kernel")
    frames, logits = run(copy.deepcopy(G).to(dev), copy.deepcopy(D).to(dev), dev)
    check(downfirdn2d_x2.launches == before + 3, "the card run did not launch the kernel")
    errs = []
    for name, got, want in [("frames", frames, ref_frames), ("logits", logits, ref_logits)]:
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()) and err <= PARITY_TOL * scale,
              f"card vs CPU {name}: max err {err} > {PARITY_TOL} * {scale}")
        errs.append(f"{name} max_abs_err {err:.3g} (scale {scale:.3g})")
    print(f"[6 parity] reduced-width G->D, card vs CPU, tol {PARITY_TOL} x scale: "
          + "; ".join(errs), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    max_err, ms, plain_ms = phase_kernel(dev)
    G, D = ffs256_models(dev)
    launches = phase_slice(dev, G, D)
    phase_speed(dev, G, smi)
    del G, D
    torch.cuda.empty_cache()
    phase_parity(dev)
    print(json.dumps({"kernels": [{
        "name": "downfirdn2d_x2", "route": "cuda",
        "source": "stylegan_v_tpu_torch/csrc/downfirdn2d_x2.cu",
        "replaces": "stylegan_v_tpu/ops/pallas_kernels.py:100",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
