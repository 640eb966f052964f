"""Smoke run of the PyTorch port (stylegan_v_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at the FFS-256 width, "generate a clip, then
score it", the training step without augment and the ADA training step, and
holds them against the port's plain PyTorch paths:

  1. device:  the card's name and power limit; TF32 off for cuDNN and matmul.
  2. build:   the CUDA kernels (K1 downfirdn2d_x2, K1-bwd downfirdn2d_x2_bwd,
              K4 affine_warp, K4-bwd affine_warp_bwd), one nvcc each for
              sm_90a, all started together.
  3. kernel:  K1 against its plain version at the six shapes of the
              Discriminator's resnet skips (2 videos x 3 frames), float32 and
              bf16, plus an asymmetric filter; CUDA-event times of both.
  4. slice:   G(z, None, t) for 4 videos x 3 timestamps, then D on the
              frames, with weights from a seeded torch.Generator; the frames
              and logits must be finite and K1 must launch 6 times.
  5. speed:   synthesis frames/s at 32 videos x 8 frames.
  6. parity:  a reduced-width G->D on the card (with the kernel) against the
              same weights and inputs on the CPU (plain path).
  7. bwd:     K1-bwd against its plain version at the output shapes of the
              six skips, as phase 3; autograd through K1 launches K1-bwd, and
              a second-order grad launches K1 again.
  8. train:   the no-augment training step at 16 videos x 3 frames, 256^2:
              one step with R1, three without, one more with R1; every loss,
              stat and parameter finite, K1 and K1-bwd launch counts per
              step; ms/step, peak memory, amortised frames/s.
  9. grads:   at phase 6's reduced width, the Gmain gradient of G and the
              Dr1 gradient of D (R1's double backward) on the card against
              the CPU.
 10. warp:    K4 and K4-bwd against their plain versions at the two warp
              shapes of the ADA pipe at 16 videos x 3 frames (taken from the
              pipe itself), float32 and bf16, with three sets of G_inv
              (identity, bgc draws at p = 1, an extreme map); CUDA-event
              times in turns; autograd through K4 to second order.
 11. ada:     the ADA training step (bgc, warp_upsample=2) at 16 x 3, 256^2,
              augment_p = 0.5: one step with R1, three without, one more
              with R1, as phase 8, with K1, K1-bwd, K4 and K4-bwd launch
              counts per step.
 12. augpar:  at phase 6's reduced width, the bgc pipe's output, Gmain's
              gradient of G and Dr1's gradient of D through the pipe (R1
              through the warp's double backward) on the card against the
              CPU, with the same draws on both.

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
# other orders through ~20 layers, relative to the output's scale (for a
# gradient: the largest magnitude in the network's gradient).
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
    from stylegan_v_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    libs = cuda_build.build_libraries()
    print(f"[2 build] {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_kernel(dev, tag, kernel, plain, shapes):
    """A kernel against its plain version at `shapes` (its inputs) in float32
    and bf16 (the first shape with an asymmetric filter too), with CUDA-event
    times taken in turns; returns the worst error and the kernel and plain
    times summed over the shapes in D's own dtype there."""
    import torch
    from stylegan_v_tpu_torch.ops import setup_filter

    sym = setup_filter([1, 3, 3, 1])
    asym = (torch.arange(16, dtype=torch.float32).reshape(4, 4) - 5.0) / 40
    g = torch.Generator(device=dev).manual_seed(0)
    max_err, path_ms, path_plain_ms = 0.0, 0.0, 0.0
    for i, (shape, path_dtype) in enumerate(shapes):
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            err = 0.0
            for name, f in [("sym", sym)] + ([("asym", asym)] if i == 0 else []):
                got, want = kernel(x, f), plain(x, f)
                torch.cuda.synchronize()
                e = (got.float() - want.float()).abs().max().item()
                tol = KERNEL_TOL[dtype_name]
                check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                      f"{tag} vs plain {shape} {dtype_name} {name}: max err {e}")
                err = max(err, e)
            max_err = max(max_err, err)
            for _ in range(3):                        # warm-up
                kernel(x, sym), plain(x, sym)
            # in turns: plain, kernel, kernel, plain
            plain_a = cuda_ms(lambda: plain(x, sym), 20)
            kern_a = cuda_ms(lambda: kernel(x, sym), 20)
            kern_b = cuda_ms(lambda: kernel(x, sym), 20)
            plain_b = cuda_ms(lambda: plain(x, sym), 20)
            kern, plain_t = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
            if dtype_name == path_dtype:
                path_ms += kern
                path_plain_ms += plain_t
            moved = (x.numel() + got.numel()) * x.element_size()
            gbps = moved / (kern * 1e-3) / 1e9
            print(f"{tag} {list(shape)} {dtype_name}: max_abs_err {err:.3g}  "
                  f"kernel {kern:.4f} ms ({gbps:.0f} GB/s)  plain {plain_t:.4f} ms", flush=True)
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

    shapes = [((n, c, h // 2, w // 2), dtype) for (n, c, h, w), dtype in D_SKIP_SHAPES]
    result = phase_kernel(dev, "[7 bwd]", downfirdn2d_x2_bwd, downfirdn2d_x2_bwd_plain, shapes)
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
    run's kernels and (ms without R1, ms with R1, amortised ms, frames/s)."""
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
          f"{expected[True]} with; on {smi}", flush=True)
    return launches, (ms_main, ms_r1, ms_step, fps)


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


def phase_warp(dev):
    """K4 and K4-bwd against their plain versions at the pipe's shapes; returns
    each one's worst error and its time and the plain version's at the ADA
    step's call (the 536^2 canvas in the pipe's bf16)."""
    import math
    import torch
    from stylegan_v_tpu_torch.ops import (affine_grid_sample, affine_grid_sample_bwd_plain,
                                          affine_grid_sample_plain, affine_warp,
                                          affine_warp_bwd)

    calls = warp_calls(dev)
    c = 4 * math.cos(math.pi / 4)     # a quarter scale at 45 degrees, past the border
    extreme = torch.tensor([[[c, -c, 1.7], [c, c, -2.3], [0, 0, 1]],
                            [[4, 0, -3.1], [0, 4, 2.6], [0, 0, 1]]], device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    worst = {"K4": 0.0, "K4-bwd": 0.0}
    path = {}
    for i, ((N, C, H, W), G_bgc, out_h, out_w, path_dtype) in enumerate(calls):
        sets = {"identity": torch.eye(3, device=dev).repeat(N, 1, 1), "bgc": G_bgc,
                "extreme": extreme[torch.arange(N, device=dev) % 2]}
        for dtype_name in ("float32", "bfloat16"):
            dtype, tol = getattr(torch, dtype_name), KERNEL_TOL[dtype_name]
            x = torch.randn(N, C, H, W, generator=g, device=dev).to(dtype)
            dy = torch.randn(N, C, out_h, out_w, generator=g, device=dev).to(dtype)
            err = {"K4": 0.0, "K4-bwd": 0.0}
            fwd = lambda G: affine_warp(x, G, out_h, out_w)                  # noqa: E731
            fwd_plain = lambda G: affine_grid_sample_plain(x, G, out_h, out_w)  # noqa: E731
            bwd = lambda G: affine_warp_bwd(dy, G, H, W)                      # noqa: E731
            bwd_plain = lambda G: affine_grid_sample_bwd_plain(dy, G, H, W)   # noqa: E731
            for set_name, G in sets.items():
                for name, kernel, plain in (("K4", fwd, fwd_plain), ("K4-bwd", bwd, bwd_plain)):
                    got, want = kernel(G).float(), plain(G).float()
                    torch.cuda.synchronize()
                    e = (got - want).abs().max().item()
                    check(torch.allclose(got, want, rtol=tol, atol=tol),
                          f"{name} vs plain {[N, C, H, W]} {dtype_name} {set_name}: max err {e}")
                    err[name] = max(err[name], e)
                    worst[name] = max(worst[name], e)
            times = {}
            for name, kernel, plain in (("K4", fwd, fwd_plain), ("K4-bwd", bwd, bwd_plain)):
                kernel(G_bgc), plain(G_bgc)                                 # warm-up
                # in turns: plain, kernel, kernel, plain
                plain_a = cuda_ms(lambda: plain(G_bgc), 10)
                kern_a = cuda_ms(lambda: kernel(G_bgc), 10)
                kern_b = cuda_ms(lambda: kernel(G_bgc), 10)
                plain_b = cuda_ms(lambda: plain(G_bgc), 10)
                times[name] = ((kern_a + kern_b) / 2, (plain_a + plain_b) / 2)
                if i == 0 and dtype == path_dtype:
                    path[name] = times[name]
            moved = (x.numel() + dy.numel()) * x.element_size()
            print(f"[10 warp] {[N, C, H, W]} -> {[out_h, out_w]} {dtype_name}: K4 "
                  f"{times['K4'][0]:.4f} ms ({moved / times['K4'][0] / 1e6:.0f} GB/s) plain "
                  f"{times['K4'][1]:.4f}; K4-bwd {times['K4-bwd'][0]:.4f} ms plain "
                  f"{times['K4-bwd'][1]:.4f}; max_abs_err over identity, bgc, extreme: "
                  f"K4 {err['K4']:.3g}, K4-bwd {err['K4-bwd']:.3g}", flush=True)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from stylegan_v_tpu_torch.ops import (downfirdn2d_x2, downfirdn2d_x2_bwd,
                                          downfirdn2d_x2_bwd_plain, downfirdn2d_x2_plain)
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    k1 = phase_kernel(dev, "[3 kernel]", downfirdn2d_x2, downfirdn2d_x2_plain, D_SKIP_SHAPES)
    G, D = ffs256_models(dev)
    phase_slice(dev, G, D)
    phase_speed(dev, G, smi)
    phase_parity(dev)
    k1_bwd = phase_bwd(dev)
    _, no_aug = phase_train(dev, smi, G, D, augment=False)
    torch.cuda.empty_cache()
    phase_grads(dev)
    k4, k4_bwd = phase_warp(dev)
    torch.cuda.empty_cache()
    launches, _ = phase_train(dev, smi, G, D, augment=True, no_aug=no_aug)
    del G, D
    torch.cuda.empty_cache()
    phase_aug_parity(dev)
    warp = "stylegan_v_tpu/ops/grid_sample.py:33 (XLA gather; no Pallas kernel)"
    records = []
    for name, (err, ms, plain_ms), n, replaces in (
            ("downfirdn2d_x2", k1, launches[0], "stylegan_v_tpu/ops/pallas_kernels.py:100"),
            ("downfirdn2d_x2_bwd", k1_bwd, launches[1],
             "stylegan_v_tpu/ops/pallas_kernels.py:100 (its gradient, from jax.grad)"),
            ("affine_warp", k4, launches[2], warp),
            ("affine_warp_bwd", k4_bwd, launches[3], f"{warp} (its gradient, from jax.grad)")):
        records.append({"name": name, "route": "cuda",
                        "source": f"stylegan_v_tpu_torch/csrc/{name}.cu", "replaces": replaces,
                        "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
