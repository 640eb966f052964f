"""Where the time of synthesis and of the ADA training step goes on the card,
by kernel class, and how long each takes.

    python stylegan_v_tpu_torch/tools/profile_split.py [--repo DIR] [--json FILE]
        [--warp-mode auto|gather|shear] [--k2-calls] [--shear-calls]

Builds FFS-256's G and D from a seed (channel_base 16384, as chip_smoke.py
does) and measures, with TF32 off (the step's default):
  * synthesis: G forward of 32 videos x 8 frames (chip_smoke.py phase 5's
    batch), ms a batch by CUDA events over 5 warm calls, then one call
    under torch.profiler;
  * the ADA step without R1 at 16 videos x 3 frames, bgc with
    warp_upsample=2 at augment_p 0.5 (phase 11's; with --warp-mode shear
    phase 20 (c)'s, the shear executor), ms a step on the host clock around
    4 synchronised warm steps and frames/s, then one step under the
    profiler;
  * a projection step, 8 frames at 256^2 (chip_smoke.py phase 18 (a)'s):
    project.projection_loss's fallback loss and its gradient in (w,
    motion_z), ms a step on the host clock over 10 synchronised steps, then
    one step under the profiler.
For each profiled window it prints the kernels' device time, the window's
host time, the idle share (1 - kernel time / window) and the kernel time
by class: K2, K1 and K1-bwd, K4 and K4-bwd, K7, K7-bwd and K8 (the port's
kernels, by name), depthwise convolutions (the plain upfirdn2d's filter
passes), layout transposes, other convolutions and GEMMs, elementwise and
reductions, the rest; then K2's time by instantiation (its template arguments). The 2-D
pass of this design, named "2d <...>": dtype, whether the output rows are
odd in length, how it sums (0 the 2-D sum guarded by the filter's size, 1
the 2-D sum of 4x4 taps, 2 rows then columns), then up, down and phase for
y and x; at 32^2-256^2 D's pre-filter is 2d <bf16,true,2,1,1,0,1,1,0> and
its adjoint 2d <bf16,false,2,1,1,0,1,1,0>.
The separable pass of this design, both passes in one launch, "sep <...>":
dtype, the column and row taps held (12 exactly, 16 at most), then up, down
and phase for y and x; the ADA pipe's 2x up and its 2x down's adjoint are
sep <bf16,12,12,2,1,0,2,1,0>, its 2x down and its 2x up's adjoint sep
<bf16,12,12,1,2,0,1,2,0>. The row and column passes of an earlier design
(--repo a checkout from before the separable pass took one launch), and
every pass of one whose 2-D pass predates the persistent ring, "<...>":
dtype, odd rows, filter rows and columns held, then up, down and phase for
y and x; there the pipe's 2x up is <bf16,false,1,16,1,1,0,2,1,0> then
<bf16,false,16,1,2,1,0,1,1,0>.
The last line is the whole result as one JSON object.

--repo DIR imports the port from the checkout at DIR instead of this one,
so that two trees can be compared in one call on one card: run it as a
script (not with -m) for that. --k2-calls also runs that checkout's
chip_smoke.py phase 3b (K2 at every distinct call of one forward at 16 x 3
and its adjoint, against its plain version, timed beside it and the library
call with a cold L2) on the same G and D, and prints and returns its rows.
--shear-calls runs that checkout's chip_smoke.py phase 20 (a) and (b): the
shear executor's kernels at the step's canvas against their plain versions,
timed beside them, their library calls and their bounds, and the
anti-aliased warp at [16, 9, 256^2] bf16, shear against K4, forward and
forward + backward, with a profile of each.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CLASSES = (  # (class, substrings of the kernel name), the first match wins
    ("K2 upfirdn2d", ("upfirdn2d_kernel", "upfirdn2d_2d_kernel", "upfirdn2d_sep_kernel")),
    ("K1, K1-bwd", ("downfirdn2d_x2",)),
    ("K4, K4-bwd", ("affine_warp",)),
    ("K7, K7-bwd, K8", ("shear_resample", "shear_shift", "shear::line_kernel")),
    ("depthwise convs (plain upfirdn2d)", ("depthwise", "conv2d_grouped")),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convs and GEMMs", ("conv", "cudnn", "xmma", "gemm", "cutlass", "sm90_", "wgrad",
                         "dgrad", "fprop")),
    ("elementwise and reductions", ("elementwise", "reduce", "Reduce", "vectorized",
                                    "unrolled", "CatArray", "index", "fill", "copy",
                                    "softmax", "norm", "scatter", "gather")),
)


def classify(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def k2_instantiation(name: str) -> str:
    """K2's template arguments in a kernel name, "2d <...>" for this design's
    2-D pass, "sep <...>" for its separable pass and "<...>" for an earlier
    design's passes, or ""."""
    for kernel, label in (("upfirdn2d_2d_kernel<", "2d "), ("upfirdn2d_sep_kernel<", "sep "),
                          ("upfirdn2d_kernel<", "")):
        if kernel in name:
            args = name.split(kernel, 1)[1].split(">", 1)[0]
            args = args.replace("__nv_bfloat16", "bf16").replace("float", "f32")
            return f"{label}<{args.replace(' ', '')}>"
    return ""


def profile(fn):
    """fn() once under torch.profiler: (kernel ms, window ms, {class: ms},
    the ten longest kernels by total ms, {K2 instantiation: ms})."""
    import torch
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    split, by_name, k2 = {}, {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.device_time_total <= 0:
            continue
        cls = classify(e.name)
        split[cls] = split.get(cls, 0.0) + e.device_time_total / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
        if k2_instantiation(e.name):
            k = k2_instantiation(e.name)
            k2[k] = k2.get(k, 0.0) + e.device_time_total / 1e3
    total = sum(split.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return total, window, split, top, k2


def report(label, total, window, split, top, k2):
    print(f"{label}: kernels {total:.2f} ms of a {window:.2f} ms window, idle share "
          f"{1 - total / window:.3f}", flush=True)
    for cls, ms in sorted(split.items(), key=lambda kv: -kv[1]):
        print(f"  {cls}: {ms:.2f} ms ({ms / total:.3f})", flush=True)
    for args, ms in sorted(k2.items(), key=lambda kv: -kv[1]):
        print(f"  K2 {args}: {ms:.2f} ms", flush=True)
    for name, ms in top:
        print(f"    {ms:8.2f} ms  {name[:110]}", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--repo", default=None, help="import the port from this checkout")
    ap.add_argument("--json", default=None, help="also write the result here")
    ap.add_argument("--k2-calls", action="store_true",
                    help="also run the checkout's chip_smoke.py phase 3b")
    ap.add_argument("--shear-calls", action="store_true",
                    help="also run the checkout's chip_smoke.py phase 20 (a) and (b)")
    ap.add_argument("--warp-mode", default="auto", choices=("auto", "gather", "shear"),
                    help="the ADA step's warp executor (the port's auto is K4)")
    args = ap.parse_args(argv)
    if args.repo:
        if "stylegan_v_tpu_torch" in sys.modules:
            raise SystemExit("--repo needs a fresh process: run this file as a script")
        sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    from stylegan_v_tpu_torch.models import (Discriminator, DiscriminatorConfig, Generator,
                                             GeneratorConfig)
    from stylegan_v_tpu_torch.models.config import replace
    from stylegan_v_tpu_torch.training import (AUGPIPE_SPECS, AugmentConfig, LossConfig,
                                               OptimizerConfig, TrainingConfig,
                                               init_train_state, make_augment_pipe,
                                               make_train_step)
    from stylegan_v_tpu_torch.utils.misc import float32_precision
    import stylegan_v_tpu_torch as port

    if not torch.cuda.is_available():
        raise SystemExit("profile_split needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{smi.strip()}; the port from {os.path.dirname(port.__file__)}", flush=True)
    gen = torch.Generator().manual_seed(0)
    G = Generator(replace(GeneratorConfig(), channel_base=16384), generator=gen).to(dev).eval()
    D = Discriminator(replace(DiscriminatorConfig(), channel_base=16384),
                      generator=gen).to(dev).eval()
    out = {"device": smi.strip(), "repo": os.path.dirname(os.path.dirname(port.__file__))}

    if args.k2_calls or args.shear_calls:
        sys.path.insert(0, out["repo"])
        import chip_smoke
        cuda_build = sys.modules["stylegan_v_tpu_torch.ops.cuda_build"]
        cuda_build.build_libraries()
    if args.k2_calls:
        with float32_precision(False):
            err, head, sums, rows = chip_smoke.phase_k2(dev, G, D)
        out["k2_calls"] = {"max_abs_err": err, "sums": sums, "rows": rows}
        torch.cuda.empty_cache()
    if args.shear_calls:
        with float32_precision(False):
            (images, G_pipe), G_canvas = chip_smoke.shear_calls(dev)
            worst, sums, rows = chip_smoke.shear_kernels(dev, G_canvas)
            torch.cuda.empty_cache()
            whole = chip_smoke.shear_whole_warp(dev, smi.strip(), images, G_pipe)
        out["shear_calls"] = {"max_abs_err": worst, "sums": sums, "rows": rows,
                              "whole_warp": whole}
        del images
        torch.cuda.empty_cache()

    # synthesis, 32 x 8
    g = torch.Generator(device=dev).manual_seed(2)
    z = torch.randn(32, G.cfg.z_dim, generator=g, device=dev)
    t = torch.arange(8, dtype=torch.float32, device=dev)[None].repeat(32, 1)
    mz = G.synthesis.motion_encoder.sample_motion_z(32, g)
    with torch.no_grad(), float32_precision(False):
        for _ in range(2):
            G(z, None, t, motion_z=mz)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            G(z, None, t, motion_z=mz)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 5
        prof = profile(lambda: G(z, None, t, motion_z=mz))
    out["synthesis"] = {"ms_a_batch": ms, "frames_per_s": 256 / (ms * 1e-3),
                        "kernel_ms": prof[0], "window_ms": prof[1], "split_ms": prof[2],
                        "k2_ms": prof[4]}
    print(f"synthesis 32x8: {ms:.2f} ms a batch, {256 / (ms * 1e-3):.1f} frames/s", flush=True)
    report("synthesis 32x8, one batch", *prof)

    # the ADA step without R1, 16 x 3
    B, F, res = 16, 3, 256
    tcfg = TrainingConfig(batch_size=B, ada_target=0.6)
    lcfg = LossConfig(r1_gamma=0.0002 * res ** 2 / B, pl_weight=0.0, video_consistent_aug=True)
    opt = OptimizerConfig(0.0025)
    aug = make_augment_pipe(AugmentConfig(**AUGPIPE_SPECS["bgc"], warp_upsample=2,
                                          warp_mode=args.warp_mode))
    state = init_train_state(G, D, opt, opt, tcfg, augment_p=0.5)
    step = make_train_step(G, D, lcfg, tcfg, augment_fn=aug)
    g = torch.Generator(device=dev).manual_seed(4)
    tt = torch.randint(0, 128, (B, F), generator=g, device=dev).float().sort(dim=1).values
    tt = tt + torch.arange(F, device=dev) * 0.1
    batch = {"real_img": torch.randint(0, 255, (B, F, 3, res, res), generator=g, device=dev,
                                       dtype=torch.uint8),
             "real_c": torch.zeros(B, 0, device=dev), "real_t": tt,
             "gen_c": torch.zeros(B, 3, 0, device=dev),
             "gen_t": torch.stack([tt, tt + 1, tt + 2], dim=1)}
    box = [state]

    def one_step():
        box[0], _ = step(box[0], batch, generator=g, do_dr1=False)

    for _ in range(2):
        one_step()
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prof = profile(one_step)
    fps = [B * F / (v * 1e-3) for v in times]
    out["ada_step"] = {"warp_mode": args.warp_mode, "ms_per_step": times, "frames_per_s": fps,
                       "kernel_ms": prof[0], "window_ms": prof[1], "split_ms": prof[2],
                       "k2_ms": prof[4]}
    print(f"ADA step without R1, 16x3 at 256^2, warp_mode {args.warp_mode}: "
          f"{', '.join(f'{v:.1f}' for v in times)} ms, "
          f"{', '.join(f'{v:.1f}' for v in fps)} frames/s", flush=True)
    report("ADA step without R1, one step", *prof)
    del state, step, box, batch
    torch.cuda.empty_cache()

    # a projection step, 8 frames
    from stylegan_v_tpu_torch import project
    from stylegan_v_tpu_torch.models.motion import MotionMappingNetwork
    G.requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(18)
    frames_n = 8
    L = MotionMappingNetwork.required_traj_len(G.cfg, float(frames_n))
    target = torch.rand(frames_n, 3, res, res, generator=g, device=dev) * 2 - 1
    w = (0.5 * torch.randn(1, G.num_ws, G.cfg.w_dim, generator=g, device=dev)).requires_grad_()
    mzp = torch.randn(1, L, G.cfg.motion.z_dim, generator=g, device=dev).requires_grad_()
    loss_fn = project.projection_loss(G, target)

    def proj_step():
        torch.autograd.grad(loss_fn(w, mzp), [w, mzp])

    with float32_precision(False):
        for _ in range(2):
            proj_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            proj_step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 10
        prof = profile(proj_step)
    out["projection_step"] = {"ms": ms, "kernel_ms": prof[0], "window_ms": prof[1],
                              "split_ms": prof[2], "k2_ms": prof[4]}
    print(f"projection step, 8 frames at 256^2: {ms:.2f} ms a step", flush=True)
    report("projection step, one step", *prof)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
