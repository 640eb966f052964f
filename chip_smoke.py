"""Smoke run of the PyTorch port (stylegan_v_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at the FFS-256 width, "generate a clip, then
score it", the training step without augment and the ADA training step, and
holds them against the port's plain PyTorch paths:

  1. device:  the card's name and power limit; the TF32 settings as the
              process finds them. Every phase but 8 and 11 runs with TF32
              off for cuDNN and matmul (utils/misc.py:float32_precision);
              8 and 11 rely on the training step's own default.
  2. build:   the CUDA kernels (K1 downfirdn2d_x2, K1-bwd downfirdn2d_x2_bwd,
              K4 affine_warp, K4-bwd affine_warp_bwd), one nvcc each for
              sm_90a, all started together.
  3. kernel:  K1 against its plain version at the six shapes of the
              Discriminator's resnet skips, at 2 videos x 3 frames and at the
              step's 16 x 3, float32 and bf16, plus an asymmetric filter at
              the first shape; CUDA-event times of the kernel, its plain
              version and its library call (F.conv2d, depthwise) in turns, in
              D's dtype at each shape, at 16 x 3 with a cold L2 (copies of
              the input rotated past 100 MB); GB/s and share of the HBM
              bound; the 16 x 3 sums are one D pass.
  4. slice:   G(z, None, t) for 4 videos x 3 timestamps, then D on the
              frames, with weights from a seeded torch.Generator; the frames
              and logits must be finite and K1 must launch 6 times.
  5. speed:   synthesis frames/s at 32 videos x 8 frames.
  6. parity:  a reduced-width G->D on the card (with the kernel) against the
              same weights and inputs on the CPU (plain path).
  7. bwd:     K1-bwd against its plain version at the output shapes of the
              six skips, as phase 3 (library call F.conv_transpose2d);
              autograd through K1 launches K1-bwd, and a second-order grad
              launches K1 again.
  8. train:   the no-augment training step at 16 videos x 3 frames, 256^2:
              one step with R1, three without, one more with R1; every loss,
              stat and parameter finite, K1 and K1-bwd launch counts per
              step; ms/step, peak memory, amortised frames/s; TF32 off for
              cuDNN and matmul inside every D call of the step.
  9. grads:   at phase 6's reduced width, the Gmain gradient of G and the
              Dr1 gradient of D (R1's double backward) on the card against
              the CPU.
 10. warp:    K4 and K4-bwd against their plain versions at the two warp
              shapes of the ADA pipe at 16 videos x 3 frames (taken from the
              pipe itself), float32 and bf16, with five sets of G_inv
              (identity, bgc draws at p = 1, an extreme zoom-out, a 4x
              zoom-in, per-axis scales 4 and 1/4); K4 equal to the bit to
              its reference design (affine_warp_per_pixel: every tap from
              device memory), and the share of K4's tiles that stage their
              box by the plan (ops/grid_sample.py:_warp_tile_boxes, computed
              on the host, not measured on the card) for each set; two
              K4-bwd calls at the step's shape equal to the bit; CUDA-event
              times in turns of K4, its reference design, K4-bwd and the
              plain versions, at the step's call with the nearest PyTorch
              calls (F.grid_sample after F.affine_grid, and
              aten.grid_sampler_2d_backward: not the same function, whose
              border half pixel differs) and each one's share of its bound;
              autograd through K4 to second order.
 11. ada:     the ADA training step (bgc, warp_upsample=2) at 16 x 3, 256^2,
              augment_p = 0.5: one step with R1, three without, one more
              with R1, as phase 8, with K1, K1-bwd, K4 and K4-bwd launch
              counts per step and TF32 off inside the step.
 12. augpar:  at phase 6's reduced width, the bgc pipe's output, Gmain's
              gradient of G and Dr1's gradient of D through the pipe (R1
              through the warp's double backward) on the card against the
              CPU, with the same draws on both.
 13. loop:    the training loop fed by the zip loader, through the entry
              point (stylegan_v_tpu_torch.train.main) on a seeded 256^2
              dataset written here (16 videos x 32 frames of binary PPM in a
              zip): the `auto` preset at batch 16, i.e. phase 11's FFS-256
              step (bgc ADA, R1 every 16, mirror), 21 steps over 4 ticks with
              snapshots 000000 and 000001, then `training.resume=latest` for
              21 more; stats.jsonl schema and finiteness, the snapshot equal
              to the bit to the state in memory and to a state restored from
              it on the card, the resumed run's start, K1/K1-bwd/K4/K4-bwd
              launches per run from phase 11's counts per step, TF32 off in
              every D call; loader-fed ms/step, frames/s amortised over the
              resumed run's ticks, data_fetch and peak memory beside phase
              11's pre-staged numbers.
 14. metrics: the metric stack (stylegan_v_tpu_torch/metrics) on phase 13's
              G_ema and dataset, with TF32 off, the I3D, Inception and C3D
              under seeded random weights registered under the reference's
              detector names: (a) each detector on the card against the same
              module on the CPU from uint8 at 256^2 (I3D [2, 16] frames
              resized to 224^2, Inception 2 images to 299^2, C3D 1 clip of 16
              frames to 112^2); (b) calc_metric("fvd2048_16f") with 32 real
              and 64 generated clips, finite, and again from the real-stats
              cache, equal to 1e-6 relative; (c) FID, KID, IS and ISv at small
              counts, finite; (d) fvd2048_128f's generator side, 4 clips of
              128 frames; (e) generator-side FVD extraction of 256 clips timed
              (clips/s, synthesis and detector split by CUDA events, peak
              memory); (g) no K1, K1-bwd, K4 or K4-bwd launch in (b)-(e); (f)
              the loop through the entry point with
              training.metrics=[fvd2048_16f] and the same overrides for 21
              steps: two snapshots, two finite metric-fvd2048_16f.jsonl rows
              named after them.

Any failed check exits non-zero. The last two lines are the kernel record
(each kernel's launches in phase 11, worst error, time, plain and library
time, and its bound: bytes at 3.35 TB/s or float32 operations at 67 TFLOP/s,
whichever is larger) and {"ok": true, "device": {...}}. There is no CPU path: without a CUDA
device the script fails.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time

# Kernel vs plain: float32 sums in another order; bf16 rounds once from a float32 sum.
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# Card vs CPU at reduced width, float32 with TF32 off: cuDNN and the CPU sum in
# other orders through ~20 layers, relative to the output's scale (for a
# gradient: the largest magnitude in the network's gradient).
PARITY_TOL = 1e-3
D_SKIP_SHAPES = [  # (frames or videos, C, H, W) at 2 videos x 3 frames, D's dtype there
    ((6, 64, 256, 256), "bfloat16"), ((6, 128, 128, 128), "bfloat16"),
    ((6, 256, 64, 64), "bfloat16"), ((6, 512, 32, 32), "bfloat16"),
    ((2, 768, 16, 16), "float32"), ((2, 512, 8, 8), "float32"),
]
# The same skips at the training step's 16 videos x 3 frames: one D pass.
D_SKIP_SHAPES_16X3 = [((8 * n, c, h, w), dtype) for (n, c, h, w), dtype in D_SKIP_SHAPES]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet (700 W)
F32_FLOPS_PER_S = 67e12        # the same card's float32 rate outside the tensor cores
L2_COLD_BYTES = 100e6          # rotate among copies of an input until they exceed twice the L2


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


def in_turns(fns, iters: int):
    """CUDA-event ms of each of fns, timed in turns A B C C B A and averaged."""
    order = list(range(len(fns)))
    ms = [0.0] * len(fns)
    for k in order + order[::-1]:
        ms[k] += cuda_ms(fns[k], iters) / 2
    return ms


def rotating(fn, inputs):
    """fn on inputs[0], inputs[1], ... in turn: a cold L2 for each call."""
    n = [0]

    def call():
        n[0] += 1
        return fn(inputs[n[0] % len(inputs)])
    return call


def cold_copies(x):
    """x and enough copies of it to exceed L2_COLD_BYTES together."""
    k = max(1, -(-int(L2_COLD_BYTES) // (x.numel() * x.element_size())))
    return [x] + [x.clone() for _ in range(k - 1)]


def bound_ms(nbytes: float, flops: float):
    """The least time for moving nbytes and computing flops (float32, outside
    the tensor cores) on the card, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def depthwise_library(kind, f, C, dtype, dev):
    """The one PyTorch call that computes K1 ("down": F.conv2d) or K1-bwd
    ("up": F.conv_transpose2d) in the input's dtype: depthwise, stride 2,
    padding 1, the flipped filter. A yardstick only; the port never calls it."""
    import torch
    import torch.nn.functional as F
    w = torch.as_tensor(f, dtype=torch.float32).flip([0, 1])[None, None]
    w = w.expand(C, 1, 4, 4).to(dev, dtype).contiguous()
    if kind == "down":
        return lambda x: F.conv2d(x, w, stride=2, padding=1, groups=C)
    return lambda dy: F.conv_transpose2d(dy, w, stride=2, padding=1, groups=C)


def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"[1 device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}; TF32 as the process finds it: "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)
    return smi


def phase_build():
    from stylegan_v_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    libs = cuda_build.build_libraries()
    print(f"[2 build] {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_kernel(dev, tag, kind, kernel, plain):
    """K1 (kind "down") or K1-bwd ("up") against its plain version at D's six
    skip shapes at 2 x 3 and at 16 x 3, in float32 and bf16 (the first shape
    of each with an asymmetric filter too), with CUDA-event times of the
    kernel, its plain version and its library call in turns, in D's dtype at
    each shape; at 16 x 3 with a cold L2. Returns the worst error and, summed
    over the six shapes at 16 x 3 (one D pass), the kernel, plain, library and
    bound times."""
    import torch
    from stylegan_v_tpu_torch.ops import setup_filter

    sym = setup_filter([1, 3, 3, 1])
    asym = (torch.arange(16, dtype=torch.float32).reshape(4, 4) - 5.0) / 40
    g = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for batch, shapes in (("2x3", D_SKIP_SHAPES), ("16x3", D_SKIP_SHAPES_16X3)):
        small = {"ms": 0.0, "plain_ms": 0.0}
        for i, ((n, c, h, w), path_dtype) in enumerate(shapes):
            shape = (n, c, h, w) if kind == "down" else (n, c, h // 2, w // 2)
            for dtype_name in ("float32", "bfloat16"):
                dtype = getattr(torch, dtype_name)
                x = torch.randn(shape, generator=g, device=dev).to(dtype)
                for name, f in [("sym", sym)] + ([("asym", asym)] if i == 0 else []):
                    got, want = kernel(x, f), plain(x, f)
                    torch.cuda.synchronize()
                    e = (got.float() - want.float()).abs().max().item()
                    tol = KERNEL_TOL[dtype_name]
                    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                          f"{tag} vs plain {batch} {list(shape)} {dtype_name} {name}: "
                          f"max err {e}")
                    max_err = max(max_err, e)
                if dtype_name != path_dtype:
                    continue
                library = depthwise_library(kind, sym, c, dtype, dev)
                xs = cold_copies(x) if batch == "16x3" else [x]
                fns = [rotating(lambda x: plain(x, sym), xs),
                       rotating(lambda x: kernel(x, sym), xs), rotating(library, xs)]
                for fn in fns:                                  # warm-up
                    fn(), fn()
                plain_t, kern, lib = in_turns(fns, 10)
                nbytes = (x.numel() + got.numel()) * x.element_size()
                # K1: 16 FMAs for each of x / 4 outputs; K1-bwd: 4 for each dx output
                bound, by = bound_ms(nbytes, 8 * max(x.numel(), got.numel()))
                print(f"{tag} {batch} {list(shape)} {dtype_name}: kernel {kern:.4f} ms "
                      f"({nbytes / (kern * 1e-3) / 1e9:.0f} GB/s, {bound / kern:.1%} of the "
                      f"{bound:.4f} ms bound)  plain {plain_t:.4f} ms  library {lib:.4f} ms",
                      flush=True)
                if batch == "16x3":
                    for k, v in (("ms", kern), ("plain_ms", plain_t), ("library_ms", lib),
                                 ("bound_ms", bound)):
                        sums[k] += v
                    sums["bound_by"] = by if sums.get("bound_by", by) == by else "mixed"
                else:
                    small["ms"] += kern
                    small["plain_ms"] += plain_t
                del xs, fns
        if batch == "2x3":
            print(f"{tag} one D pass at 2x3: kernel {small['ms']:.4f} ms, plain "
                  f"{small['plain_ms']:.4f} ms", flush=True)
    print(f"{tag} one D pass at 16x3 (cold L2): kernel {sums['ms']:.4f} ms, plain "
          f"{sums['plain_ms']:.4f} ms, library {sums['library_ms']:.4f} ms, bound "
          f"{sums['bound_ms']:.4f} ms ({sums['bound_ms'] / sums['ms']:.1%} of it)", flush=True)
    return max_err, sums


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


def reduced_models():
    """Phase 6's reduced-width G and D on the CPU, with inputs for 4 videos."""
    import torch
    from stylegan_v_tpu_torch.models import (Discriminator, DiscriminatorConfig, Generator,
                                             GeneratorConfig, MotionConfig, SamplingConfig,
                                             TimeEncConfig)

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
    return G, D, z, t, mz, gen


def phase_parity(dev):
    import torch
    from stylegan_v_tpu_torch.ops import downfirdn2d_x2

    G, D, z, t, mz, _ = reduced_models()

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


def phase_bwd(dev):
    import torch
    from stylegan_v_tpu_torch.ops import (downfirdn2d_x2, downfirdn2d_x2_bwd,
                                          downfirdn2d_x2_bwd_plain, downfirdn2d_x2_plain,
                                          fir_kernels, setup_filter)

    result = phase_kernel(dev, "[7 bwd]", "up", downfirdn2d_x2_bwd, downfirdn2d_x2_bwd_plain)
    # Autograd through K1 on the card: first order launches K1-bwd, second order K1.
    f = setup_filter([1, 3, 3, 1])
    x = torch.randn(2, 8, 32, 32, device=dev, requires_grad=True)
    k1, k1b = downfirdn2d_x2.launches, downfirdn2d_x2_bwd.launches
    y = fir_kernels._DownFirX2.apply(x, f)
    dx, = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    first = (downfirdn2d_x2.launches - k1, downfirdn2d_x2_bwd.launches - k1b)
    gx, = torch.autograd.grad(dx.square().sum(), x)
    torch.cuda.synchronize()
    second = (downfirdn2d_x2.launches - k1, downfirdn2d_x2_bwd.launches - k1b)
    check(first == (1, 1) and second == (2, 2),
          f"K1/K1-bwd launches through autograd: {first} then {second}, expected (1, 1), (2, 2)")
    # sum(dx^2) with dx = 2 K1bwd(K1(x)) has the gradient 8 (K1bwd K1)^2 x
    want = 8 * downfirdn2d_x2_bwd_plain(downfirdn2d_x2_plain(
        downfirdn2d_x2_bwd_plain(downfirdn2d_x2_plain(x.detach(), f), f), f), f)
    err = (gx - want).abs().max().item()
    check(err <= KERNEL_TOL["float32"] * want.abs().max().item(),
          f"second-order grad through K1 vs plain: max err {err}")
    print(f"[7 bwd] autograd on the card: grad launches K1-bwd {first[1]}x, grad of grad "
          f"launches K1 {second[0] - first[0]}x more; second order max_abs_err {err:.3g}",
          flush=True)
    return result


# K1 and K1-bwd launches per training step at 256^2. D's forward launches K1 once
# per resnet skip (6) and a backward through D launches K1-bwd once per skip (6).
# Without R1: Gmain runs D forward and backward into the frames (6 + 6), Dmain
# runs Dgen and Dreal (12 + 12): 18 and 18. Dr1 adds a D forward (6 K1), the
# first-order grad into the real frames (6 K1-bwd), and that grad's backward,
# which runs K1 for each of its 6 K1-bwd nodes and K1-bwd for each of the 6 K1
# nodes of the forward: 30 and 30.
LAUNCHES_PER_STEP = {False: (18, 18), True: (30, 30)}
# With the ADA pipe (phase 11), K4 runs in every D call of the step: Gmain,
# Dgen and Dreal (3); K4-bwd in Gmain's backward into G (1): Dgen's frames come
# from G under no_grad and Dreal's from data, so no gradient runs back through
# their warps. Dr1 adds a K4 forward, the K4-bwd of the first-order grad into
# the real frames, and that grad's backward, which runs K4 again: 5 and 2. The
# warp's 12-tap filters never take K1's case, so K1 and K1-bwd stay as above.
ADA_LAUNCHES_PER_STEP = {False: (18, 18, 3, 1), True: (30, 30, 5, 2)}
TRAIN_SHAPE = (16, 3, 256)     # videos, frames, resolution: bench.py:bench_train_step's
ADA_P = 0.5                    # the step's cost does not depend on p; at 0.5 transforms fire
WARP_BATCH = (16, 9, 256)      # the pipe's input at TRAIN_SHAPE: videos, 3 frames x RGB, size


def phase_train(dev, smi, G, D, augment, no_aug=None):
    """Phase 8 (augment=False) or 11 (the bgc pipe, warp_upsample=2): five steps
    (R1, three without, R1) on G and D as they are; returns the launches of the
    run's kernels and (ms without R1, ms with R1, amortised ms, frames/s, peak GiB)."""
    import torch
    from stylegan_v_tpu_torch.ops import (affine_warp, affine_warp_bwd, downfirdn2d_x2,
                                          downfirdn2d_x2_bwd)
    from stylegan_v_tpu_torch.training import (AUGPIPE_SPECS, AugmentConfig, LossConfig,
                                               OptimizerConfig, TrainingConfig,
                                               init_train_state, make_augment_pipe,
                                               make_train_step)

    kernels = [downfirdn2d_x2, downfirdn2d_x2_bwd] + ([affine_warp, affine_warp_bwd]
                                                      if augment else [])
    expected = ADA_LAUNCHES_PER_STEP if augment else LAUNCHES_PER_STEP
    names = ", ".join(("K1", "K1-bwd", "K4", "K4-bwd")[:len(kernels)])
    tag = "[11 ada]" if augment else "[8 train]"
    (B, F, res), r1_every = TRAIN_SHAPE, 16
    tcfg = TrainingConfig(batch_size=B, ada_target=0.6)
    lcfg = LossConfig(r1_gamma=0.0002 * res ** 2 / B, pl_weight=0.0, video_consistent_aug=True)
    opt = OptimizerConfig(0.0025)
    aug = (make_augment_pipe(AugmentConfig(**AUGPIPE_SPECS["bgc"], warp_upsample=2))
           if augment else None)
    state = init_train_state(G, D, opt, opt, tcfg, augment_p=ADA_P if augment else 0.0)
    step = make_train_step(G, D, lcfg, tcfg, augment_fn=aug)
    g = torch.Generator(device=dev).manual_seed(4)
    t = torch.randint(0, 128, (B, F), generator=g, device=dev).float().sort(dim=1).values
    t = t + torch.arange(F, device=dev) * 0.1
    batch = {"real_img": torch.randint(0, 255, (B, F, 3, res, res), generator=g, device=dev,
                                       dtype=torch.uint8),
             "real_c": torch.zeros(B, 0, device=dev), "real_t": t,
             "gen_c": torch.zeros(B, 3, 0, device=dev),
             "gen_t": torch.stack([t, t + 1, t + 2], dim=1)}
    # the TF32 settings inside the step, read in every D call
    tf32 = (torch.backends.cudnn, torch.backends.cuda.matmul)
    caller, seen = tuple(t.allow_tf32 for t in tf32), set()
    hook = D.register_forward_hook(lambda *_: seen.add(tuple(t.allow_tf32 for t in tf32)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    times = {True: [], False: []}
    for do_dr1 in (True, False, False, False, True):
        before = [k.launches for k in kernels]
        t0 = time.perf_counter()
        state, stats = step(state, batch, generator=g, do_dr1=do_dr1)
        torch.cuda.synchronize()
        times[do_dr1].append(time.perf_counter() - t0)
        got = tuple(k.launches - n for k, n in zip(kernels, before))
        check(got == expected[do_dr1],
              f"{tag} step (do_dr1={do_dr1}) launched {names} {got} times, expected "
              f"{expected[do_dr1]}")
        bad = [k for k, v in stats.items() if not bool(torch.isfinite(v).all())]
        check(not bad, f"{tag} non-finite stats {bad}")
    launches = tuple(k.launches for k in kernels)
    hook.remove()
    check(seen == {(False, False)}, f"{tag} (cudnn, matmul) allow_tf32 inside the step: {seen}")
    check(tuple(t.allow_tf32 for t in tf32) == caller, f"{tag} the step left TF32 changed")
    for name, module in (("G", state.G), ("D", state.D), ("G_ema", state.G_ema)):
        bad = [n for n, p in module.named_parameters() if not bool(torch.isfinite(p).all())]
        check(not bad, f"{tag} non-finite {name} parameters {bad[:5]}")
    check(state.step == 5 and state.cur_nimg == 5 * B * F, f"{tag} step {state.step}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms_main = sum(times[False][1:]) / len(times[False][1:]) * 1e3   # warm steps
    ms_r1 = times[True][1] * 1e3                                   # the second R1 step
    ms_step = ((r1_every - 1) * ms_main + ms_r1) / r1_every          # bench.py:206
    fps = B * F / (ms_step * 1e-3)                                   # bench.py:210
    what = (f"WITH ADA (bgc, warp_upsample=2, augment_p {ADA_P})" if augment
            else "NO augment")
    beside = ""
    if no_aug is not None:
        beside = (f"; phase 8 without augment: {no_aug[0]:.1f} / {no_aug[1]:.1f} ms, "
                  f"{no_aug[3]:.1f} frames/s")
    print(f"{tag} FFS-256 step, {B}x{F} at {res}^2, {what}: "
          f"{ms_main:.1f} ms without R1 (first {times[False][0] * 1e3:.1f}), {ms_r1:.1f} ms with "
          f"R1 (first {times[True][0] * 1e3:.1f}); amortised at R1 every {r1_every}: "
          f"{ms_step:.1f} ms/step, {fps:.1f} frames/s ({what}){beside}; peak {peak:.2f} GiB; "
          f"losses {', '.join(f'{k} {v.item():.4f}' for k, v in stats.items())}; "
          f"{names} launches per step {expected[False]} without R1, "
          f"{expected[True]} with; (cudnn, matmul) allow_tf32 inside the step {sorted(seen)}, "
          f"the caller's {caller}; on {smi}", flush=True)
    return launches, (ms_main, ms_r1, ms_step, fps, peak)


def phase_grads(dev):
    import torch
    from stylegan_v_tpu_torch.ops import downfirdn2d_x2, downfirdn2d_x2_bwd
    from stylegan_v_tpu_torch.training import GANLoss, LossConfig

    G, D, z, t, mz, gen = reduced_models()
    real = torch.rand(12, 3, 32, 32, generator=gen) * 2 - 1
    frames = {}

    def grads(G, D, device):
        """Gmain's gradient of G and Dr1's of D. D's input in Gmain takes the
        CPU frames' values on the card (the gradient still runs through the
        card's G): frames that differ by float rounding put a few of D's
        leaky-ReLU inputs on the other side of zero, whose slope jump moves
        single gradients by up to ~1e-3 of scale in any two runs."""
        loss = GANLoss(G, D, LossConfig(r1_gamma=1.0))
        run = loss.run_synthesis

        def pinned(*args, **kwargs):
            img = run(*args, **kwargs)
            if "cpu" not in frames:
                frames["cpu"] = img.detach()
                return img
            return img + (frames["cpu"].to(device) - img).detach()

        loss.run_synthesis = pinned
        l, _ = loss.gmain(z.to(device), None, t.to(device), mz.to(device))
        gG = torch.autograd.grad(l, list(G.parameters()), allow_unused=True)
        l, _ = loss.dreal_dr1(real.to(device), None, t.to(device), do_main=False, do_r1=True,
                              r1_gamma=1.0)
        gD = torch.autograd.grad(l, list(D.parameters()), allow_unused=True)
        return [{n: (g if g is not None else torch.zeros_like(p)).cpu()
                 for (n, p), g in zip(m.named_parameters(), gs)}
                for m, gs in ((G, gG), (D, gD))]

    before = (downfirdn2d_x2.launches, downfirdn2d_x2_bwd.launches)
    want = grads(copy.deepcopy(G), copy.deepcopy(D), torch.device("cpu"))
    check((downfirdn2d_x2.launches, downfirdn2d_x2_bwd.launches) == before,
          "the CPU run launched a kernel")
    got = grads(copy.deepcopy(G).to(dev), copy.deepcopy(D).to(dev), dev)
    ran = (downfirdn2d_x2.launches - before[0], downfirdn2d_x2_bwd.launches - before[1])
    check(min(ran) > 0, f"the card run launched K1, K1-bwd {ran} times")
    msgs = []
    for name, g, w in (("Gmain dG", got[0], want[0]), ("Dr1 dD", got[1], want[1])):
        scale = max(v.abs().max().item() for v in w.values())
        err, worst = max((((g[k] - w[k]).abs().max().item()), k) for k in w)
        check(all(bool(torch.isfinite(v).all()) for v in g.values())
              and err <= PARITY_TOL * scale,
              f"card vs CPU {name}: max err {err} at {worst} > {PARITY_TOL} * {scale}")
        msgs.append(f"{name} max_abs_err {err:.3g} at {worst} (scale {scale:.3g})")
    print(f"[9 grads] reduced width, card (K1, K1-bwd launched {ran}) vs CPU, tol "
          f"{PARITY_TOL} x scale: " + "; ".join(msgs), flush=True)


def warp_calls(dev):
    """The K4 calls of the ADA pipe at 16 videos x 3 frames (9 channels), as
    (input shape, G_inv, out_h, out_w, dtype) for warp_upsample 2 and 1, taken
    from the pipe itself run on the card with bgc draws at p = 1."""
    import torch
    from stylegan_v_tpu_torch.training import augment as taug

    (N, C, H), calls, warp = WARP_BATCH, [], taug.affine_grid_sample

    def recorded(x, G_inv, out_h, out_w, mode="reflect"):
        calls.append((tuple(x.shape), G_inv.detach().clone(), out_h, out_w, x.dtype))
        return warp(x, G_inv, out_h, out_w, mode)

    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.rand(N, C, H, H, generator=g, device=dev) * 2 - 1
    taug.affine_grid_sample = recorded
    try:
        for warp_upsample in (2, 1):
            pipe = taug.make_augment_pipe(taug.AugmentConfig(**taug.AUGPIPE_SPECS["bgc"],
                                                             warp_upsample=warp_upsample))
            with torch.no_grad():
                pipe(g, x, torch.ones((), device=dev))
    finally:
        taug.affine_grid_sample = warp
    shapes = [(c[0], c[2], c[3]) for c in calls]
    # warp_upsample=2: reflect pad 6, 2x up, warp to the canvas less 3 a side; 1: direct
    big, out = 2 * (H + 12), 2 * (H + 6)
    check(shapes == [((N, C, big, big), out, out), ((N, C, H, H), H, H)],
          f"the ADA pipe's warp calls: {shapes}")
    return calls


def per_pixel_warp():
    """K4's reference design, the C entry point affine_warp_per_pixel of
    csrc/affine_warp.cu (every tap from device memory), as a function of
    (x, G_inv, out_h, out_w); for comparisons only: it counts no launch."""
    import torch
    from stylegan_v_tpu_torch.ops import cuda_build, grid_sample

    fn = cuda_build.entry_point("affine_warp", grid_sample._ARGTYPES, "affine_warp_per_pixel")

    def warp(x, G_inv, out_h, out_w, mode="reflect"):
        N, C, H, W = x.shape
        y = torch.empty(N, C, out_h, out_w, dtype=x.dtype, device=x.device)
        cuda_build.launch("affine_warp_per_pixel", fn,
                          (x.data_ptr(), G_inv.data_ptr(), y.data_ptr(),
                           cuda_build.DTYPE_CODES[x.dtype], grid_sample.MODES[mode], N, C, H, W,
                           out_h, out_w), x.device.index)
        return y
    return warp


def phase_warp(dev):
    """K4 and K4-bwd against their plain versions at the pipe's shapes, K4
    against its reference design to the bit; returns each one's worst error
    and its time, the plain version's and the nearest PyTorch call's at the
    ADA step's call (the 536^2 canvas in the pipe's bf16), and for K4 its
    reference design's time there."""
    import math
    import torch
    import torch.nn.functional as F
    from stylegan_v_tpu_torch.ops import (affine_grid_sample, affine_grid_sample_bwd_plain,
                                          affine_grid_sample_plain, affine_warp,
                                          affine_warp_bwd)
    from stylegan_v_tpu_torch.ops.grid_sample import _warp_tile_boxes

    calls = warp_calls(dev)
    per_pixel = per_pixel_warp()
    c = 4 * math.cos(math.pi / 4)     # a quarter scale at 45 degrees, past the border
    extreme = torch.tensor([[[c, -c, 1.7], [c, c, -2.3], [0, 0, 1]],
                            [[4, 0, -3.1], [0, 4, 2.6], [0, 0, 1]]], device=dev)
    z = 0.25 * math.cos(math.pi / 6), 0.25 * math.sin(math.pi / 6)   # 4x zoom-in at 30 degrees
    zoom_in = torch.tensor([[[z[0], -z[1], 0.1], [z[1], z[0], -0.2], [0, 0, 1]]], device=dev)
    r = math.cos(math.pi / 9), math.sin(math.pi / 9)     # per-axis scales 4 and 1/4 (ADA tails)
    aniso = torch.tensor([[[4, 0, 0.3], [0, 0.25, -0.1], [0, 0, 1]],
                          [[0.25 * r[0], -4 * r[1], -0.4], [0.25 * r[1], 4 * r[0], 0.9],
                           [0, 0, 1]]], device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    worst = {"K4": 0.0, "K4-bwd": 0.0}
    path = {}
    for i, ((N, C, H, W), G_bgc, out_h, out_w, path_dtype) in enumerate(calls):
        alternate = torch.arange(N, device=dev) % 2
        sets = {"identity": torch.eye(3, device=dev).repeat(N, 1, 1), "bgc": G_bgc,
                "extreme": extreme[alternate], "zoom_in": zoom_in.repeat(N, 1, 1),
                "aniso": aniso[alternate]}
        for dtype_name in ("float32", "bfloat16"):
            dtype, tol = getattr(torch, dtype_name), KERNEL_TOL[dtype_name]
            x = torch.randn(N, C, H, W, generator=g, device=dev).to(dtype)
            dy = torch.randn(N, C, out_h, out_w, generator=g, device=dev).to(dtype)
            err = {"K4": 0.0, "K4-bwd": 0.0}
            fwd = lambda G: affine_warp(x, G, out_h, out_w)                  # noqa: E731
            fwd_plain = lambda G: affine_grid_sample_plain(x, G, out_h, out_w)  # noqa: E731
            bwd = lambda G: affine_warp_bwd(dy, G, H, W)                      # noqa: E731
            bwd_plain = lambda G: affine_grid_sample_bwd_plain(dy, G, H, W)   # noqa: E731
            staged, equal_plain = {}, []
            for set_name, G in sets.items():
                for name, kernel, plain in (("K4", fwd, fwd_plain), ("K4-bwd", bwd, bwd_plain)):
                    got, want = kernel(G), plain(G)
                    torch.cuda.synchronize()
                    e = (got.float() - want.float()).abs().max().item()
                    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                          f"{name} vs plain {[N, C, H, W]} {dtype_name} {set_name}: max err {e}")
                    err[name] = max(err[name], e)
                    worst[name] = max(worst[name], e)
                    if name == "K4":
                        check(torch.equal(got, per_pixel(x, G, out_h, out_w)),
                              f"K4 {[N, C, H, W]} {dtype_name} {set_name}: not equal to the bit "
                              f"to its reference design")
                        equal_plain.append(torch.equal(got, want))
                plan = _warp_tile_boxes(G, H, W, out_h, out_w, channels=C,
                                        itemsize=x.element_size())
                staged[set_name] = float((plan.channels > 0).mean())
            if i == 0:    # K4-bwd sums without atomics, in a fixed order: it repeats to the bit
                check(torch.equal(bwd(G_bgc), bwd(G_bgc)),
                      f"K4-bwd {[N, C, H, W]} {dtype_name}: two calls differ")
            # The nearest PyTorch calls, not the same function (border half pixel):
            # a yardstick only; the port never calls them.
            theta = G_bgc[:, :2].to(dtype)
            grid = F.affine_grid(theta, [N, C, out_h, out_w], align_corners=False)
            nearest = {
                "K4": lambda: F.grid_sample(
                    x, F.affine_grid(theta, [N, C, out_h, out_w], align_corners=False),
                    mode="bilinear", padding_mode="reflection", align_corners=False),
                "K4-bwd": lambda: torch.ops.aten.grid_sampler_2d_backward(
                    dy, x, grid, 0, 2, False, [True, False])}
            at_path = i == 0 and dtype == path_dtype
            moved = (x.numel() + dy.numel()) * x.element_size()
            # 4 taps per output (K4), 4 per dy element (K4-bwd), 2 flops each
            bound, by = bound_ms(moved, 8 * dy.numel())
            times = {}
            for name, kernel, plain in (("K4", fwd, fwd_plain), ("K4-bwd", bwd, bwd_plain)):
                fns = {"kernel": lambda: kernel(G_bgc), "plain": lambda: plain(G_bgc)}
                if name == "K4":
                    fns["per_pixel"] = lambda: per_pixel(x, G_bgc, out_h, out_w)
                if at_path:
                    fns["nearest"] = nearest[name]
                for fn in fns.values():                                 # warm-up
                    fn()
                times[name] = dict(zip(fns, in_turns(list(fns.values()), 10)))
            if at_path:
                for name, t in times.items():
                    path[name] = (t["kernel"], t["plain"], t["nearest"], bound, by)
                path["K4"] += (times["K4"]["per_pixel"],)
            k4, k4b = times["K4"], times["K4-bwd"]
            print(f"[10 warp] {[N, C, H, W]} -> {[out_h, out_w]} {dtype_name}: K4 "
                  f"{k4['kernel']:.4f} ms ({bound / k4['kernel']:.1%} of the {bound:.4f} ms "
                  f"bound) reference design {k4['per_pixel']:.4f} plain {k4['plain']:.4f}"
                  + (f" nearest {k4['nearest']:.4f}" if at_path else "")
                  + f"; K4-bwd {k4b['kernel']:.4f} ms ({bound / k4b['kernel']:.1%}) plain "
                  f"{k4b['plain']:.4f}" + (f" nearest {k4b['nearest']:.4f}" if at_path else "")
                  + f"; max_abs_err over {', '.join(sets)}: K4 {err['K4']:.3g}, K4-bwd "
                  f"{err['K4-bwd']:.3g}; K4 equal to the bit to its reference design, to the "
                  f"plain version {sum(equal_plain)} of {len(equal_plain)}; K4 tiles staged by the "
                  f"plan (computed on the host, not measured) "
                  + ", ".join(f"{k} {v:.4f}" for k, v in staged.items())
                  + ("; K4-bwd repeats to the bit" if i == 0 else ""), flush=True)
    # Autograd through K4 on the card: first order launches K4-bwd, second order K4.
    x = torch.randn(3, 5, 18, 20, generator=g, device=dev, requires_grad=True)
    G = extreme[torch.tensor([0, 1, 0], device=dev)]
    k4, k4b = affine_warp.launches, affine_warp_bwd.launches
    y = affine_grid_sample(x, G, 11, 13)
    dx, = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    first = (affine_warp.launches - k4, affine_warp_bwd.launches - k4b)
    gx, = torch.autograd.grad(dx.square().sum(), x)
    torch.cuda.synchronize()
    second = (affine_warp.launches - k4, affine_warp_bwd.launches - k4b)
    check(first == (1, 1) and second == (2, 2),
          f"K4/K4-bwd launches through autograd: {first} then {second}, expected (1, 1), (2, 2)")
    P, PT = affine_grid_sample_plain, affine_grid_sample_bwd_plain
    want = 8 * PT(P(PT(P(x.detach(), G, 11, 13), G, 18, 20), G, 11, 13), G, 18, 20)
    e = (gx - want).abs().max().item()
    check(e <= KERNEL_TOL["float32"] * want.abs().max().item(),
          f"second-order grad through K4 vs plain: max err {e}")
    print(f"[10 warp] autograd on the card: grad launches K4-bwd {first[1]}x, grad of grad "
          f"launches K4 {second[0] - first[0]}x more; second order max_abs_err {e:.3g}",
          flush=True)
    return ((worst["K4"], *path["K4"]), (worst["K4-bwd"], *path["K4-bwd"]))


class RecordedDraws:
    """A draw source that records a CPU generator's draws, then replays them
    (`replay()`), so that two devices augment with the same transforms."""

    def __init__(self, seed: int):
        import torch
        self.gen, self.draws, self.next = torch.Generator().manual_seed(seed), [], None

    def _draw(self, fn, shape):
        if self.next is None:
            self.draws.append(fn(shape, generator=self.gen))
            return self.draws[-1]
        self.next += 1
        return self.draws[self.next - 1]

    def rand(self, shape):
        import torch
        return self._draw(torch.rand, shape)

    def randn(self, shape):
        import torch
        return self._draw(torch.randn, shape)

    def replay(self):
        self.next = 0
        return self


def phase_aug_parity(dev):
    """Card vs CPU at phase 6's width with the bgc pipe (warp_upsample=2) and
    the same draws: the pipe's output, Gmain's dG and Dr1's dD. The geometry
    runs in float32 on both (on the card the pipe's default is bf16). D's
    input takes the CPU run's augmented values on the card (the gradient still
    runs through the card's pipe), as phase 9 pins the frames."""
    import torch
    from stylegan_v_tpu_torch.ops import affine_warp, affine_warp_bwd
    from stylegan_v_tpu_torch.training import (AUGPIPE_SPECS, AugmentConfig, GANLoss,
                                               LossConfig, make_augment_pipe)

    G, D, z, t, mz, gen = reduced_models()
    real = torch.rand(12, 3, 32, 32, generator=gen) * 2 - 1
    pipe = make_augment_pipe(AugmentConfig(**AUGPIPE_SPECS["bgc"], warp_upsample=2,
                                           geom_dtype="float32"))
    draws = {k: RecordedDraws(seed) for k, seed in (("pipe", 8), ("gmain", 9), ("dr1", 10))}
    outs = {}

    def pinned(device, key):
        def augment(src, img, p):
            out = pipe(src, img, p)
            if device.type == "cpu":
                outs[key] = out.detach()
                return out
            return out + (outs[key].to(device) - out).detach()
        return augment

    def run(G, D, device):
        ap = torch.tensor(ADA_P, device=device)
        fused = pipe(draws["pipe"], real.reshape(4, 9, 32, 32).to(device), ap).cpu()
        loss = GANLoss(G, D, LossConfig(r1_gamma=1.0))
        loss.augment_fn = pinned(device, "gmain")
        l, _ = loss.gmain(z.to(device), None, t.to(device), mz.to(device),
                          aug_draws=draws["gmain"], augment_p=ap)
        gG = torch.autograd.grad(l, list(G.parameters()), allow_unused=True)
        loss.augment_fn = pinned(device, "dr1")
        l, _ = loss.dreal_dr1(real.to(device), None, t.to(device), do_main=False, do_r1=True,
                              r1_gamma=1.0, aug_draws=draws["dr1"], augment_p=ap)
        gD = torch.autograd.grad(l, list(D.parameters()), allow_unused=True)
        return [{"out": fused}] + [{n: (g if g is not None else torch.zeros_like(p)).cpu()
                                    for (n, p), g in zip(m.named_parameters(), gs)}
                                   for m, gs in ((G, gG), (D, gD))]

    before = (affine_warp.launches, affine_warp_bwd.launches)
    want = run(copy.deepcopy(G), copy.deepcopy(D), torch.device("cpu"))
    check((affine_warp.launches, affine_warp_bwd.launches) == before,
          "the CPU run launched a kernel")
    for src in draws.values():
        src.replay()
    got = run(copy.deepcopy(G).to(dev), copy.deepcopy(D).to(dev), dev)
    ran = (affine_warp.launches - before[0], affine_warp_bwd.launches - before[1])
    # the pipe 1 K4; Gmain 1 K4 + 1 K4-bwd; Dr1 1 K4 + 1 K4-bwd + 1 K4 (R1's backward)
    check(ran == (4, 2), f"the card run launched K4, K4-bwd {ran} times, expected (4, 2)")
    msgs = []
    for name, g, w in (("pipe output", got[0], want[0]), ("Gmain dG", got[1], want[1]),
                       ("Dr1 dD", got[2], want[2])):
        scale = max(v.abs().max().item() for v in w.values())
        err, worst = max((((g[k] - w[k]).abs().max().item()), k) for k in w)
        check(all(bool(torch.isfinite(v).all()) for v in g.values())
              and err <= PARITY_TOL * scale,
              f"card vs CPU with ADA {name}: max err {err} at {worst} > {PARITY_TOL} * {scale}")
        msgs.append(f"{name} max_abs_err {err:.3g} (scale {scale:.3g})")
    print(f"[12 augpar] reduced width, bgc at p {ADA_P}, card (K4, K4-bwd launched {ran}) vs "
          f"CPU, tol {PARITY_TOL} x scale: " + "; ".join(msgs), flush=True)


LOOP_DATA = (16, 32, 256)   # videos, frames a video, resolution of phase 13's dataset
LOOP_RUNS = ((0, 21), (21, 42))   # the two runs' step indices: 1008 and 2016 frames at 48 a step


def _reflect(x, lo, hi):
    """scripts/make_moving_dataset.py:_reflect (a copy: that script imports Pillow)."""
    import numpy as np
    span = hi - lo
    y = np.mod(x - lo, 2 * span)
    return lo + np.where(y > span, 2 * span - y, y)


def render_video(rng, res, frames):
    """scripts/make_moving_dataset.py:render_video, a copy: [T, H, W, 3] uint8 of a
    gradient background and 1-3 bouncing anti-aliased sprites."""
    import numpy as np
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi)
    proj = (np.cos(ang) * xx + np.sin(ang) * yy)
    proj = (proj - proj.min()) / max(float(np.ptp(proj)), 1e-6)
    c0 = rng.uniform(0.05, 0.65, size=3).astype(np.float32)
    c1 = rng.uniform(0.35, 0.95, size=3).astype(np.float32)
    bg = c0 + proj[..., None] * (c1 - c0)
    img = np.broadcast_to(bg, (frames, res, res, 3)).copy()
    t = np.arange(frames, dtype=np.float32)
    for _ in range(rng.randint(1, 4)):
        shape = rng.choice(["disc", "square"])
        color = rng.uniform(0.1, 1.0, size=3).astype(np.float32)
        r = rng.uniform(0.10, 0.22) * res
        speed = rng.uniform(0.8, 3.0) * res / 64.0
        theta = rng.uniform(0, 2 * np.pi)
        p0 = rng.uniform(r, res - 1 - r, size=2).astype(np.float32)
        cx = _reflect(p0[0] + speed * np.cos(theta) * t, r, res - 1 - r)
        cy = _reflect(p0[1] + speed * np.sin(theta) * t, r, res - 1 - r)
        dx = xx[None] - cx[:, None, None]
        dy = yy[None] - cy[:, None, None]
        d = np.sqrt(dx * dx + dy * dy) if shape == "disc" else np.maximum(np.abs(dx), np.abs(dy))
        alpha = np.clip(r + 0.5 - d, 0.0, 1.0)[..., None]
        img = img * (1.0 - alpha) + color * alpha
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_ppm_zip(path, seed=0):
    """LOOP_DATA's videos as <video>/<frame>.ppm (binary P6) in a stored zip, as
    FFS is zipped; seeded as scripts/make_moving_dataset.py seeds its videos."""
    import zipfile
    import numpy as np
    videos, frames, res = LOOP_DATA
    header = f"P6\n{res} {res}\n255\n".encode()
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as zf:
        for v in range(videos):
            vid = render_video(np.random.RandomState(seed * 1_000_003 + v), res, frames)
            for f in range(frames):
                zf.writestr(f"video{v:05d}/{f:06d}.ppm", header + vid[f].tobytes())
    return path


def _equal_trees(a, b, where=""):
    """Every tensor of a nest of dicts and lists equal to the bit; returns the count."""
    import torch
    if isinstance(a, torch.Tensor):
        check(isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b),
              f"[13 loop] {where} differs from the saved state")
        return 1
    if isinstance(a, dict):
        check(isinstance(b, dict) and set(a) == set(b), f"[13 loop] {where} keys differ")
        return sum(_equal_trees(a[k], b[k], f"{where}.{k}") for k in a)
    if isinstance(a, (list, tuple)):
        check(len(a) == len(b), f"[13 loop] {where} lengths differ")
        return sum(_equal_trees(x, y, f"{where}[{i}]") for i, (x, y) in enumerate(zip(a, b)))
    check(a == b, f"[13 loop] {where}: {a} != {b}")
    return 0


def check_snapshot(dev, run, state):
    """Snapshot 000001, written at the end of the first run (the second
    overwrites it), equals the state that run ended with, and a state restored
    from it on the card; returns the number of tensors compared."""
    import os
    from stylegan_v_tpu_torch.io.checkpoint import (load_snapshot, restore_train_state,
                                                    snapshot_payload)
    from stylegan_v_tpu_torch.models import Discriminator, Generator
    from stylegan_v_tpu_torch.training import init_train_state
    from stylegan_v_tpu_torch.training.train_step import OptimizerConfig, TrainingConfig

    payload, meta = load_snapshot(os.path.join(run, "network-snapshot-000001.pt"))
    check(meta["cur_nimg"] == 1008, f"[13 loop] snapshot 000001 meta {meta['cur_nimg']}")
    n = _equal_trees(snapshot_payload(state), payload, "snapshot 000001")
    fresh = init_train_state(Generator(state.G.cfg).to(dev), Discriminator(state.D.cfg).to(dev),
                             OptimizerConfig(), OptimizerConfig(), TrainingConfig())
    restore_train_state(fresh, payload)     # lr and betas stay fresh's: compare the state
    _equal_trees(*({k: v["state"] if k.startswith("opt_") else v for k, v in p.items()}
                   for p in (snapshot_payload(fresh), payload)),
                 "the state restored from 000001")
    return n


def phase_loop(dev, smi, prestaged, tmp):
    """Phase 13: the loader-fed loop through the entry point, twice (21 steps,
    then 21 more resumed from `latest`), with its checks; `prestaged` is phase
    11's (ms without R1, ms with R1, amortised ms, frames/s, peak GiB). The
    dataset goes in the directory `tmp`; returns its path and the resumed
    run's G_ema, which phase 14 scores."""
    import contextlib
    import importlib.util
    import io
    import math
    import os
    import torch
    from stylegan_v_tpu_torch import train as entry
    from stylegan_v_tpu_torch.models import Discriminator
    from stylegan_v_tpu_torch.ops import (affine_warp, affine_warp_bwd, downfirdn2d_x2,
                                          downfirdn2d_x2_bwd)

    # the loop's host packages: Pillow for the .jpg grids, cv2 for the .mp4, PyYAML
    # for the configs (the card had all three when probed)
    missing = [m for m in ("PIL", "cv2", "yaml") if importlib.util.find_spec(m) is None]
    check(not missing, f"[13 loop] the loop's host packages are missing: {missing}")
    kernels = (downfirdn2d_x2, downfirdn2d_x2_bwd, affine_warp, affine_warp_bwd)
    tf32 = (torch.backends.cudnn, torch.backends.cuda.matmul)
    seen = set()

    def d_hook(module, *_):
        if isinstance(module, Discriminator):
            seen.add(tuple(t.allow_tf32 for t in tf32))

    t0 = time.perf_counter()
    zip_path = write_ppm_zip(os.path.join(tmp, "moving256.zip"))
    t_data = time.perf_counter() - t0
    run = os.path.join(tmp, "run")
    args = [f"dataset.path={zip_path}", "training.batch_size=16", "training.kimg=1",
            "training.kimg_per_tick=0.25", "training.snap=2", "training.metrics=[]",
            f"project_release_dir={run}"]
    hook = torch.nn.modules.module.register_module_forward_hook(d_hook)
    results, counts, peaks, out = [], [], [], io.StringIO()
    try:
        for extra in ([], ["training.resume=latest", "training.kimg=2"]):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for k in kernels:
                k.launches = 0
            with contextlib.redirect_stdout(out):       # the loop's log, in log.txt too
                results.append(entry.main(args + extra))
            torch.cuda.synchronize()
            counts.append(tuple(k.launches for k in kernels))
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            if not extra:
                n_saved = check_snapshot(dev, run, results[0]["state"])
                # the resumed run's peak memory is its own: drop this run's state
                results[0]["step"] = results[0].pop("state").step
    finally:
        hook.remove()
    files = set(os.listdir(run))
    rows = [json.loads(line) for line in open(os.path.join(run, "stats.jsonl"))]

    # the runs: their ends, the resumed start, the launches per run
    first, second = results
    check((first["cur_nimg"], first["step"]) == (1008, 21),
          f"[13 loop] first run ended at {first['cur_nimg']} frames, step {first['step']}")
    check((second["start_nimg"], second["start_step"]) == (1008, 21),
          f"[13 loop] resumed at {second['start_nimg']} frames, step {second['start_step']}")
    check((second["cur_nimg"], second["state"].step) == (2016, 42),
          f"[13 loop] resumed run ended at {second['cur_nimg']}, step {second['state'].step}")
    for (lo, hi), got in zip(LOOP_RUNS, counts):
        want = tuple(sum(ADA_LAUNCHES_PER_STEP[i % 16 == 0][j] for i in range(lo, hi))
                     for j in range(4))
        check(got == want, f"[13 loop] steps {lo}-{hi - 1} launched K1, K1-bwd, K4, K4-bwd "
                           f"{got} times, expected {want} (R1 at every 16th step index)")
    check(seen == {(False, False)}, f"[13 loop] (cudnn, matmul) allow_tf32 in D: {seen}")

    # the artifacts
    want_files = {"log.txt", "stats.jsonl", "experiment_config.yaml", "reals.jpg",
                  "fakes_init.jpg"} | {f"network-snapshot-{k:06d}.{ext}" for k in (0, 1, 2)
                                       for ext in ("pt", "meta.json")}
    want_files |= {f"fakes{n:06d}.{ext}" for n in (576, 1008, 1584, 2016)
                   for ext in ("jpg", "mp4")}
    check(want_files <= files, f"[13 loop] missing artifacts {sorted(want_files - files)}")

    # stats.jsonl: the JAX loop's schema, every stat finite, augment_p in [0, 1]
    check(len(rows) == 8, f"[13 loop] {len(rows)} stats rows, expected 4 ticks a run")
    for row in rows:
        check(isinstance(row.get("timestamp"), float), "[13 loop] a row without timestamp")
        stats = {k: v for k, v in row.items() if k != "timestamp"}
        check({"Loss/G/loss", "Loss/scores/real", "Progress/augment_p",
               "Timing/data_fetch"} <= set(stats), f"[13 loop] stats keys {sorted(stats)}")
        for k, v in stats.items():
            check(set(v) == {"mean", "std", "num"} and v["num"] > 0
                  and math.isfinite(v["mean"]) and math.isfinite(v["std"]),
                  f"[13 loop] stat {k}: {v}")
        p = stats["Progress/augment_p"]["mean"]
        check(0.0 <= p <= 1.0, f"[13 loop] augment_p {p}")

    G_ema = second["state"].G_ema
    del results, first, second
    torch.cuda.empty_cache()

    # loader-fed numbers from the resumed (warm) run's four ticks: the Timing
    # stats are host seconds between dispatches (training/loop.py), which the
    # launch queue's back-pressure holds to the device's pace
    warm = rows[4:]

    def mean_ms(key):
        num = sum(r[key]["num"] for r in warm if key in r)
        return sum(r[key]["mean"] * r[key]["num"] for r in warm if key in r) / num * 1e3, num

    ms_main, n_main = mean_ms("Timing/Gmain_Dmain")
    ms_r1, n_r1 = mean_ms("Timing/Gmain_Dmain_Dr1")
    fetch, _ = mean_ms("Timing/data_fetch")
    steps = sum(r["Timing/data_fetch"]["num"] for r in warm[1:])
    fps = steps * 48 / (warm[-1]["timestamp"] - warm[0]["timestamp"])
    ticks = [line for line in out.getvalue().splitlines() if line.startswith("tick ")]
    print("\n".join(f"[13 loop] {line}" for line in ticks))
    pre = prestaged                 # phase 11's numbers
    print(f"[13 loop] FFS-256 loop fed by the zip loader ({LOOP_DATA[0]} videos x {LOOP_DATA[1]} "
          f"PPM frames at {LOOP_DATA[2]}^2, written in {t_data:.1f} s), `python -m "
          f"stylegan_v_tpu_torch.train` auto preset, batch 16x3, bgc ADA, R1 every 16: "
          f"{LOOP_RUNS[0][1]} steps, then {LOOP_RUNS[1][1] - LOOP_RUNS[1][0]} resumed from "
          f"latest at step 21 / 1008 frames; snapshot 000001 equal to the bit to the state "
          f"in memory and to its restore on the card ({n_saved} tensors); launches K1, K1-bwd, "
          f"K4, K4-bwd per run {counts[0]} and {counts[1]}; (cudnn, matmul) allow_tf32 in D "
          f"{sorted(seen)}. Loader-fed (resumed run): {ms_main:.1f} ms/step without R1 (mean "
          f"Timing/Gmain_Dmain over {n_main} steps), {ms_r1:.1f} ms with R1 ({n_r1} step), "
          f"{fps:.1f} frames/s amortised over ticks 2-4 ({steps} steps, their R1 and a "
          f"snapshot included), data_fetch {fetch:.2f} ms/step, peak {peaks[1]:.2f} GiB (first "
          f"run {peaks[0]:.2f}); pre-staged (phase 11, same process): {pre[0]:.1f} ms without "
          f"R1, {pre[1]:.1f} ms with R1, {pre[3]:.1f} frames/s amortised at R1 every 16, "
          f"data_fetch 0, peak {pre[4]:.2f} GiB; on {smi}", flush=True)
    return zip_path, G_ema


METRIC_ITEMS = (32, 64)     # max_real_override, num_gen_override of phase 14's FVDs
FVD_TIMED_CLIPS = 256       # generator-side FVD extraction timed in phase 14 (16-frame clips)
FVD_KW = dict(rescale=True, resize=True, return_features=True)   # the reference's I3D kwargs


def random_detectors():
    """Phase 14's I3D, Inception and C3D with seeded random weights, on the CPU
    (the reference's detector files are not in the repository)."""
    import torch
    from stylegan_v_tpu_torch.metrics.detectors import C3D, InceptionI3d, InceptionV3, random_init_
    gen = torch.Generator().manual_seed(14)
    return [random_init_(cls(), gen).eval() for cls in (InceptionI3d, InceptionV3, C3D)]


def conv_flops(model, shape) -> int:
    """The operations (2 x multiply-adds) of a module's convolutions on an input
    of `shape`, counted from the shapes by a forward pass on the meta device."""
    import torch
    total = [0]

    def count(m, _, out):
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)):
            total[0] += 2 * out.numel() * m.weight[0].numel()

    meta = copy.deepcopy(model).to("meta")
    for m in meta.modules():
        m.register_forward_hook(count)
    with torch.no_grad():
        meta(torch.empty(shape, device="meta"))
    return total[0]


def phase_detectors(dev, models):
    """Phase 14 (a): each detector's features on the card against the same
    module on the CPU, from uint8 frames at 256^2 through its own rescale and
    resize. Returns the card's copies of the modules."""
    import copy
    import numpy as np
    import torch
    from stylegan_v_tpu_torch.metrics import detectors as det

    rng = np.random.RandomState(14)
    cases = (("I3D", det.i3d_features_fn, (2, 16, 256, 256, 3), FVD_KW),
             ("Inception", det.inception_features_fn, (2, 256, 256, 3),
              dict(return_features=True)),
             ("C3D", det.c3d_features_fn, (1, 16, 256, 256, 3), {}))
    card_models, msgs = [], []
    for (name, fn, shape, kw), model in zip(cases, models):
        x = rng.randint(0, 256, shape).astype(np.uint8)
        want = fn(copy.deepcopy(model), device="cpu", **kw)(x)
        card_models.append(copy.deepcopy(model).to(dev))
        got = fn(card_models[-1], **kw)(torch.from_numpy(x).to(dev))
        scale, err = float(np.abs(want).max()), float(np.abs(got - want).max())
        check(got.shape == want.shape and bool(np.isfinite(got).all()) and scale > 0
              and err <= PARITY_TOL * scale,
              f"[14 metrics] {name} card vs CPU: shape {got.shape}, max abs err {err:.3g}, "
              f"scale {scale:.3g}")
        msgs.append(f"{name} {list(shape)} -> {list(got.shape)}: max abs err {err:.3g} "
                    f"(scale {scale:.3g})")
    print(f"[14 metrics] (a) detectors with seeded random weights, card against CPU, tol "
          f"{PARITY_TOL} x scale: " + "; ".join(msgs), flush=True)
    return card_models


def phase_metrics(dev, smi, G_ema, zip_path, tmp, models):
    """Phase 14: the metric stack on phase 13's FFS-256 G_ema and dataset, with
    random-weight detectors registered under the reference's names: (a) the
    detectors card vs CPU; (b) calc_metric("fvd2048_16f") twice, the second
    from the real-stats cache; (c) FID, KID, IS and ISv at small counts; (d)
    the generator side of fvd2048_128f; (e) the generator-side FVD extraction
    timed, synthesis and detector split; (g) no K1, K1-bwd, K4 or K4-bwd launch
    in (b)-(e); (f) the loop through the entry point with
    training.metrics=[fvd2048_16f], two snapshots, two rows."""
    import contextlib
    import io
    import math
    import os
    import numpy as np
    import torch
    from stylegan_v_tpu_torch import train as entry
    from stylegan_v_tpu_torch.metrics import detectors as det
    from stylegan_v_tpu_torch.metrics import metric_main, metric_utils
    from stylegan_v_tpu_torch.metrics.frechet_inception_distance import compute_fid
    from stylegan_v_tpu_torch.metrics.inception_score import compute_is, compute_isv
    from stylegan_v_tpu_torch.metrics.kernel_inception_distance import compute_kid
    from stylegan_v_tpu_torch.ops import (affine_warp, affine_warp_bwd, downfirdn2d_x2,
                                          downfirdn2d_x2_bwd)

    t_phase = time.perf_counter()
    i3d, inception, c3d = phase_detectors(dev, models)
    fns = {"i3d": (det.i3d_features_fn, i3d), "inception": (det.inception_features_fn, inception),
           "c3d_ucf101": (det.c3d_features_fn, c3d)}
    for name, (fn, model) in fns.items():
        metric_utils.register_detector(name, lambda fn=fn, model=model, **kw: fn(model, **kw),
                                       cache_tag=f"chip-smoke-random-{name}-s14")
    kernels = (downfirdn2d_x2, downfirdn2d_x2_bwd, affine_warp, affine_warp_bwd)
    for k in kernels:
        k.launches = 0
    cache = os.path.join(tmp, "metric-stats")
    common = dict(G=G_ema, dataset_kwargs=dict(path=zip_path, xflip=True), device=dev,
                  cache_dir=cache)
    real, gen = METRIC_ITEMS

    # (b) FVD through the registry, twice: the second call reads the real stats' cache
    fvd, secs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        r = metric_main.calc_metric("fvd2048_16f", max_real_override=real,
                                    num_gen_override=gen, **common)
        secs.append(time.perf_counter() - t0)
        fvd.append(r.results["fvd2048_16f"])
        if len(fvd) == 1:
            cached = os.listdir(cache)
    check(len(cached) == 1 and os.listdir(cache) == cached,
          f"[14 metrics] real-stats cache {cached} then {os.listdir(cache)}")
    check(math.isfinite(fvd[0]) and abs(fvd[1] - fvd[0]) <= 1e-6 * abs(fvd[0]),
          f"[14 metrics] fvd2048_16f {fvd[0]!r} then {fvd[1]!r} from the cache")
    print(f"[14 metrics] (b) calc_metric('fvd2048_16f') on phase 13's G_ema, I3D at 224^2, "
          f"{real} real clips ({LOOP_DATA[0]} videos, mirrored) and {gen} generated: FVD "
          f"{fvd[0]!r} in {secs[0]:.2f} s, then {fvd[1]!r} in {secs[1]:.2f} s from the real-stats cache "
          f"(relative difference {abs(fvd[1] - fvd[0]) / abs(fvd[0]):.3g})", flush=True)

    # (c) FID, KID, IS (Inception) and ISv (C3D) at small counts
    opts = metric_utils.MetricOptions(**common)
    np.random.seed(14)                     # KID's subsets come from the global np.random
    small = dict(fid=compute_fid(opts, max_real=32, num_gen=32),
                 kid=compute_kid(opts, max_real=32, num_gen=32, num_subsets=10,
                                 max_subset_size=32),
                 is_=compute_is(opts, num_gen=32, num_splits=2),
                 isv=compute_isv(opts, num_gen=8, num_splits=2))
    check(all(math.isfinite(v) for v in (small["fid"], small["kid"], *small["is_"],
                                         *small["isv"])),
          f"[14 metrics] FID, KID, IS, ISv {small}")
    check(small["is_"][0] >= 1.0 and small["isv"][0] >= 1.0, f"[14 metrics] IS, ISv {small}")
    print(f"[14 metrics] (c) FID {small['fid']!r} (32 real frames, 32 generated), KID "
          f"{small['kid']!r}, IS {small['is_']} (32 frames, 2 splits), ISv {small['isv']} "
          f"(8 clips of 16 frames, C3D at 112^2)", flush=True)

    # (d) the generator side of fvd2048_128f: 4 clips of 128 frames
    t0 = time.perf_counter()
    st = metric_utils.compute_feature_stats_for_generator(
        opts, "i3d", FVD_KW, capture_mean_cov=True, max_items=4, temporal_detector=True,
        num_video_frames=128, batch_size=128)
    mu, sigma = st.get_mean_cov()
    check(st.num_items == 4 and mu.shape == (1024,) and bool(np.isfinite(sigma).all()),
          f"[14 metrics] 128-frame stats: {st.num_items} items, mean {mu.shape}")
    print(f"[14 metrics] (d) fvd2048_128f's generator side: 4 clips of 128 frames in "
          f"{time.perf_counter() - t0:.2f} s, features finite, |mean| {np.abs(mu).max():.4g}",
          flush=True)

    # (e) generator-side FVD extraction, timed: synthesis and detector by CUDA events
    spans = {"synthesis": [], "detector": []}

    def open_span(kind):
        spans[kind].append([torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True)])
        spans[kind][-1][0].record()

    def timed_i3d(**kw):
        features = det.i3d_features_fn(i3d, **kw)

        def timed(x):
            open_span("detector")
            out = features(x)
            spans["detector"][-1][1].record()
            return out
        timed.on_device = True
        return timed

    metric_utils.register_detector("i3d", timed_i3d, cache_tag="chip-smoke-random-i3d-s14")
    hooks = [G_ema.register_forward_pre_hook(lambda *_: open_span("synthesis")),
             G_ema.register_forward_hook(lambda *_: spans["synthesis"][-1][1].record())]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st = metric_utils.compute_feature_stats_for_generator(
            opts, "i3d", FVD_KW, capture_mean_cov=True, max_items=FVD_TIMED_CLIPS,
            temporal_detector=True, num_video_frames=16, batch_size=128)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for h in hooks:
            h.remove()
        metric_utils.register_detector("i3d", lambda **kw: det.i3d_features_fn(i3d, **kw),
                                       cache_tag="chip-smoke-random-i3d-s14")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    check(st.num_items == FVD_TIMED_CLIPS and bool(np.isfinite(st.get_mean_cov()[1]).all()),
          f"[14 metrics] timed extraction: {st.num_items} clips")
    launches = tuple(k.launches for k in kernels)
    flops = conv_flops(i3d, (1, 3, 16, 224, 224)) * FVD_TIMED_CLIPS
    print(f"[14 metrics] (e) generator-side FVD extraction, {FVD_TIMED_CLIPS} clips x 16 frames "
          f"at 256^2 in {len(spans['synthesis'])} batches of 8 clips: "
          f"{FVD_TIMED_CLIPS / wall:.2f} clips/s ({wall:.3f} s host clock); synthesis "
          f"{ms['synthesis']:.1f} ms ({FVD_TIMED_CLIPS * 16e3 / ms['synthesis']:.1f} frames/s), "
          f"detector (I3D at 224^2 and the features to the host) {ms['detector']:.1f} ms (CUDA "
          f"events; its convolutions {flops / 1e12:.2f} TFLOP, {flops / ms['detector'] / 1e9:.1f} "
          f"TFLOP/s, {flops / ms['detector'] / 1e9 / (F32_FLOPS_PER_S / 1e12):.2f} of the "
          f"float32 peak), the rest {wall * 1e3 - sum(ms.values()):.1f} ms; peak {peak:.2f} GiB; "
          f"on {smi}", flush=True)

    # (g) the metric path launches none of the port's kernels
    check(launches == (0, 0, 0, 0), f"[14 metrics] K1, K1-bwd, K4, K4-bwd launched {launches} "
                                     "times on the metric path, expected none")
    print(f"[14 metrics] (g) K1, K1-bwd, K4, K4-bwd launches during (b)-(e): {launches}",
          flush=True)

    # (f) the loop through the entry point, scoring fvd2048_16f at each of two snapshots
    run = os.path.join(tmp, "run_metrics")
    args = [f"dataset.path={zip_path}", "training.batch_size=16", "training.kimg=1",
            "training.kimg_per_tick=0.5", "training.snap=1", "training.metrics=[fvd2048_16f]",
            f"training.metric_kwargs.max_real_override={real}",
            f"training.metric_kwargs.num_gen_override={gen}",
            f"training.metric_kwargs.cache_dir={cache}", f"project_release_dir={run}"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        entry.main(args)
    t_loop = time.perf_counter() - t0
    logged = [line for line in out.getvalue().splitlines() if "fvd2048_16f" in line
              or "metric evaluation failed" in line]
    path = os.path.join(run, "metric-fvd2048_16f.jsonl")
    rows = [json.loads(line) for line in open(path)] if os.path.exists(path) else []
    snaps = [r.get("snapshot") for r in rows]
    check(snaps == ["network-snapshot-000000", "network-snapshot-000001"]
          and all(math.isfinite(r["results"]["fvd2048_16f"]) for r in rows)
          and all(os.path.exists(os.path.join(run, f"{n}.pt")) for n in snaps),
          f"[14 metrics] the loop's metric rows {rows}; its log: {logged}")
    print(f"[14 metrics] (f) `python -m stylegan_v_tpu_torch.train ... training.metrics="
          f"[fvd2048_16f]` (overrides {real} / {gen}), 21 steps, snapshots at "
          f"{[r['snapshot_nimg'] for r in rows]} frames: rows "
          f"{[(r['snapshot'], r['results']['fvd2048_16f']) for r in rows]} in {t_loop:.1f} s",
          flush=True)
    print(f"[14 metrics] phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)


def kernel_records(k1, k1_bwd, k4, k4_bwd, launches):
    """The kernel record: each kernel's launches in the ADA run (phase 11),
    worst error against its plain version, and its time, its plain version's
    and its library call's beside its bound: K1 and K1-bwd summed over one D
    pass at 16 x 3 (phases 3, 7), K4 and K4-bwd at the step's warp (phase 10);
    for K4 also its reference design's time there."""
    warp = "stylegan_v_tpu/ops/grid_sample.py:33 (XLA gather; no Pallas kernel)"
    conv = "depthwise, stride 2, padding 1, in the input's dtype"
    near = "not the same function (border half pixel)"
    records = []
    for name, times, err, n, replaces, library in (
            ("downfirdn2d_x2", k1[1], k1[0], launches[0],
             "stylegan_v_tpu/ops/pallas_kernels.py:100", f"F.conv2d ({conv})"),
            ("downfirdn2d_x2_bwd", k1_bwd[1], k1_bwd[0], launches[1],
             "stylegan_v_tpu/ops/pallas_kernels.py:100 (its gradient, from jax.grad)",
             f"F.conv_transpose2d ({conv})"),
            ("affine_warp", dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                                     k4[1:])), k4[0], launches[2], warp,
             "F.grid_sample(x, F.affine_grid(G_inv[:, :2]), bilinear, reflection, "
             f"align_corners=False): {near}"),
            ("affine_warp_bwd", dict(zip(("ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by"), k4_bwd[1:])), k4_bwd[0], launches[3],
             f"{warp} (its gradient, from jax.grad)",
             f"aten.grid_sampler_2d_backward(output_mask=[True, False]): {near}")):
        records.append({"name": name, "route": "cuda",
                        "source": f"stylegan_v_tpu_torch/csrc/{name}.cu", "replaces": replaces,
                        "launches": n, "max_abs_err": err, "ms": times["ms"],
                        "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
                        "bound_by": times["bound_by"], "library_call": library,
                        "library_ms": times["library_ms"],
                        "share_of_bound": times["bound_ms"] / times["ms"]})
    # K4's reference design (every tap from device memory), timed in the same run
    records[2].update(reference_design_ms=k4[6])
    return records


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from stylegan_v_tpu_torch.ops import (downfirdn2d_x2, downfirdn2d_x2_bwd,
                                          downfirdn2d_x2_bwd_plain, downfirdn2d_x2_plain)
    from stylegan_v_tpu_torch.utils.misc import float32_precision
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    with float32_precision(False):
        k1 = phase_kernel(dev, "[3 kernel]", "down", downfirdn2d_x2, downfirdn2d_x2_plain)
        G, D = ffs256_models(dev)
        phase_slice(dev, G, D)
        phase_speed(dev, G, smi)
        phase_parity(dev)
        k1_bwd = phase_bwd(dev)
    _, no_aug = phase_train(dev, smi, G, D, augment=False)     # the step's own default
    torch.cuda.empty_cache()
    with float32_precision(False):
        phase_grads(dev)
        k4, k4_bwd = phase_warp(dev)
    torch.cuda.empty_cache()
    launches, prestaged = phase_train(dev, smi, G, D, augment=True, no_aug=no_aug)
    del G, D
    torch.cuda.empty_cache()
    with float32_precision(False):
        phase_aug_parity(dev)
    detectors = random_detectors()
    with tempfile.TemporaryDirectory() as tmp:
        zip_path, G_ema = phase_loop(dev, smi, prestaged, tmp)   # the loop's own TF32 default
        with float32_precision(False):
            phase_metrics(dev, smi, G_ema, zip_path, tmp, detectors)
    records = kernel_records(k1, k1_bwd, k4, k4_bwd, launches)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
