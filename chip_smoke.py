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
              K4 affine_warp, K4-bwd affine_warp_bwd, K2 upfirdn2d, K7
              shear_pass, K7-bwd shear_resample_bwd, K8 shear_shift), one
              nvcc each for sm_90a, all started together.
  3. kernel:  K1 against its plain version at the six shapes of the
              Discriminator's resnet skips, at 2 videos x 3 frames and at the
              step's 16 x 3, float32 and bf16, plus an asymmetric filter at
              the first shape; CUDA-event times of the kernel, its plain
              version and its library call (F.conv2d, depthwise) in turns, in
              D's dtype at each shape, at 16 x 3 with a cold L2 (copies of
              the input rotated past 100 MB); GB/s and share of the HBM
              bound; the 16 x 3 sums are one D pass.
  3b. k2:     K2 (the general upfirdn2d resampler, one launch a call)
              against its plain version at every distinct K2 call of one
              forward at the step's 16 x 3 (G's up=2 convs and image skips,
              D's filters before its down=2 convs, the bgc pipe's separable
              12-tap 2x up and 2x down, recorded from that forward) and at
              each one's adjoint, float32 and bf16, one launch each;
              CUDA-event times of the kernel (a wrapper call, and launched
              directly through its C entry point), its plain version and the
              PyTorch call that computes each pass (F.conv2d or
              F.conv_transpose2d, depthwise, chained over a separable call's
              two passes) in turns, in the path's dtype, with a cold L2; GB/s
              and share of the HBM bound. Every bf16 4x4 call sums rows, then
              columns (its filter is an outer product), every float32 one in
              2-D; D's filters and their adjoints again with an asymmetric
              4x4 filter (the 2-D sum), and the separable calls of
              K2_OFF_PATH (the guarded instantiation), float32 and bf16,
              against the plain version.
  4. slice:   G(z, None, t) for 4 videos x 3 timestamps, then D on the
              frames, with weights from a seeded torch.Generator; the frames
              and logits must be finite, K1 must launch 6 times and K2 18
              (12 in G, 6 in D).
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
              autograd through K4 to second order; K2 at the pipe's
              separable calls (its 12-tap 2x up and 2x down and their
              adjoints at 16 x 9) as phase 3b's, one launch each.
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
              it on the card, the resumed run's start, K1/K1-bwd/K4/K4-bwd/K2
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
 15. ranks:   two ranks sharing the card over gloo (nccl refuses two ranks
              on one device), spawned: (a) phase 11's FFS-256 ADA step at
              16 x 3 global, 8 videos a rank, four steps (R1 first and
              last), with deterministic kernels; step 1's all-reduced Gmain
              and Dmain gradients against the one-process step on the same
              global batch and draws, every loss, stat and parameter finite,
              augment_p equal on both ranks, check_replica_consistency
              passing; (b) each rank's K1, K1-bwd, K4, K4-bwd, K2 launches per
              step against phase 11's; (c) ZeRO-1 on the first two steps,
              equal to (a)'s state after them to the bit, and the optimizer
              bytes per rank; (d) the
              loop through the entry point's spawn path (`num_gpus=2
              --device cuda:0 --dist-backend gloo`) on phase 13's zip,
              resumed from phase 13's last snapshot: a step and a snapshot,
              then resume=latest, a step, a snapshot and fvd2048_16f over
              two replicas; (e) nccl at world size 1
              through the entry point under torchrun's environment; (f)
              ms/step of the two ranks (they share one card: not a scaling
              number), the all-reduce's ms and peak memory per rank.
 16. legacy:  a reference-format .pkl (stylegan_v_tpu_torch/tools/ref_pickle.py)
              of seeded FFS-256 G, G_ema and D with phase 13's configs: (a)
              imported and loaded on the card, the state_dicts, G_ema's frames
              and D's logits equal to the source's to the bit; a TF-era pickle
              at FFS-256's widths into a video G (the renamed variables to the
              bit, the motion encoder fresh, card vs CPU); (b) the loop through
              the entry point with --resume <the .pkl> on phase 13's zip, 21
              ADA steps: step 0's weights equal the .pkl's, the counters
              fresh, K1/K1-bwd/K4/K4-bwd/K2 launches per step as phase 11's,
              ms/step; then one tick under torchrun (nproc 1, nccl); (c)
              `python -m stylegan_v_tpu_torch.generate` on the .pkl (clips/s),
              on phase 14's run dir by its metric jsonl, and with
              --moco-decomposition, each equal to generate_videos on the
              card; (d) `generate --frame-shards 2 --device cuda:0`, whose
              own spawn puts two ranks on the card (gloo): its JPEGs read
              back against the one-process frames through the same writer,
              in uint8, each rank's launches, and the gather's ms; (e) calc_metrics on the .pkl and on phase 13's last snapshot,
              calc_metrics_for_dataset on two frame zips, each equal to
              calc_metric in process (phase 14's detectors and counts); no
              kernel launch in (c)-(e), (d)'s ranks included.
 17. mocogan: configs/experiments.yaml's mocogan_baseline/b16_mnf16 at
              256^2 (model=mocogan: the LSTM motion G and the MoCoGAN D, image
              D + Conv3d/BatchNorm3d video D), 16 videos x 16 frames a step in
              accumulation rounds of training.batch_gpu videos, composed from
              configs/ as the entry point composes it: (a) one step with R1,
              three without, one more with R1 at augment_p 0.5, every loss,
              stat (the video ones too) and parameter finite, D's Adam groups
              at 1x and 0.1x (video_discr), K1/K1-bwd/K4/K4-bwd/K2 launches per
              step (phase 11's per round times the rounds), TF32 off in D,
              no batch-norm all_reduce (one process), ms/step, frames/s, peak
              memory; (b) K1 and K1-bwd against their
              plain versions at the image D's six skip inputs of the step
              (a round's 8 x 16 frames; phases 3 and 7's checks and times),
              K4 and K4-bwd at the pipe's 48-channel warp (phase 10's checks
              and times; the plan's whole/chunked/direct tile shares) and K2
              at its separable calls [8, 48, 268^2] -> 536^2 and [8, 48,
              524^2] -> 256^2 and their adjoints, beside
              phase 10's 9-channel times; (c) at 64^2 reduced width, card vs
              CPU with the same weights and draws (the video D's noise too):
              the LSTM G's frames, D's two logits, Gmain's dG and Dr1's dD,
              the gradients within 3x the CPU's own gradient move at the
              weight move that moves its outputs as far as the card's differ;
              (d) the loop through the entry point on phase 13's zip: 4 steps,
              a snapshot equal to the bit to the state, resume=latest for 4
              more, the resumed optimizer's groups, launches per run, both
              logit streams in stats.jsonl; (e) generate on (d)'s last
              snapshot against generate_videos, clips/s, fvd2048_16f at phase
              14's counts, no kernel launch.
 18. cli:     the remaining CLIs on phase 16's FFS-256 .pkl, each through its
              main(argv) as `python -m stylegan_v_tpu_torch.<name>` runs it:
              (a) project on 8 target frames at 256^2 from G_ema at a known
              (z, motion_z), the fallback loss for 100 steps with 4 motion
              trials (the last loss below the search's best, finite latents,
              K1 and K1-bwd launches per step as derived, ms a step), then 10
              steps of the LPIPS branch with a scripted stand-in vgg16.pt;
              (b) K1 and K1-bwd against their plain versions at the
              pyramid's shapes, [8, 3, 256^2] down to 64^2 float32 (phases 3
              and 7's checks and times), beside phases 3 and 7's; (c) at
              phase 6's reduced width, card vs CPU: the projection loss and
              its gradient in (w, motion_z), edit_loss and its gradient in
              ws; (d) clip_edit.edit for 30 steps with a stand-in CLIP tower
              and a scripted stand-in ArcFace: finite, the CLIP term falls,
              no launch; (e) export_model --selftest at batch 4 x 16 frames,
              the artifact in a fresh process that imports torch alone equal
              to this process's to the bit, two seeds two videos, clips/s;
              (f) frames_to_video_grid on phase 16's frame folders; (g)
              `python -m stylegan_v_tpu_torch.launch --jobs 2` on phase 13's
              zip, job 2 resuming job 1's snapshot, and batch_launch
              --print-only over configs/experiments.yaml. transformers is
              probed and printed, not used.
 19. moco-ranks: phase 17's slice over two ranks sharing the card over gloo,
              spawned as in phase 15: 16 videos x 16 frames a step globally
              in 2 rounds of 8, 4 videos a rank a round, the video D's batch
              norms over both ranks: (a) two steps with deterministic
              kernels (R1 first), step 1's all-reduced Gmain and
              Dmain gradients against the one-process step on the same
              global batch and draws (phase 17's step) within 3x their noise
              floor (phase 15's rule; checked at the phase's end), every
              loss, stat (the video ones too) and parameter finite,
              augment_p and D's Adam groups (1x, 0.1x) equal on both ranks,
              check_replica_consistency passing; (b) each rank's K1,
              K1-bwd, K4, K4-bwd, K2 launches per step equal to phase 17's, and
              its batch-norm all_reduces per step equal to the count derived
              from the code (MOCO_BN_COLLECTIVES); (c) ZeRO-1 on the first
              two steps equal to (a)'s state to the bit, optimizer bytes per
              rank; (d) the loop through the entry point's spawn path
              (`model=mocogan num_gpus=2 --device cuda:0 --dist-backend
              gloo`) on phase 13's zip, resumed from phase 17 (d)'s last
              snapshot: a step and a snapshot, then resume=latest, one step
              and a snapshot, both holding D's
              groups at 1x and 0.1x; (e) K1 and K1-bwd at one rank's image D
              skips (4 x 16 frames) and K4 and K4-bwd at [4, 48, 536, 536]
              against their plain versions, with phase 17 (b)'s checks and
              times; (f) ms/step of the two ranks (one card: not a scaling
              number), the gradient all-reduce's ms, the batch-norm
              all_reduces' count and ms a step, peak memory per rank.
 20. shear:   the ADA pipe's shear warp executor (warp_mode="shear",
              ops/shear_warp.py), run after phase 12 on phase 11's G and D;
              phases 3-12 launch none of its kernels, and 13-19 and 21 none either:
              (a) K7 (the fused pass: resample then shift in one launch, the
              reflect pad in its taps, pass V's rot90 samples read through
              their map), K7-bwd (its lists built on chip, pass V's rot90
              samples turned back in its store) and K8 (forward and
              adjoint) against their
              plain versions at both passes of the step's canvas ([16, 9,
              536^2] -> 524^2, the pipe's bgc maps and maps that take the
              rot90 branch, the clips and flips) and of a small odd case (C =
              3, 67^2 -> 61^2), float32 and bf16: K7 and K8 equal to them to
              the bit; each twice, equal to the bit; CUDA-event times in bf16
              at the canvas of each call, its plain version and its library
              call: for K7 the earlier route in library calls (the rot90
              select, F.pad's reflect, torch.bmm of the banded one-hot
              matrix, F.grid_sample on a grid of the shift's positions), for
              K7-bwd torch.bmm of the transposed matrix (then, in pass V,
              the rot90 samples turned back), for K8 and its adjoint
              F.grid_sample (bilinear, zeros, align_corners=True), each
              checked against the kernel; K7-bwd as the step calls it (on a
              fresh LineTaps, with rot) and launched straight through its C
              entry point; GB/s and share of the bound of the bytes this call's
              tables read; (b) the anti-aliased warp at [16, 9, 256^2] in
              bf16, shear against K4, forward and forward + backward, in
              turns, with each call's launches; (c) phase 11's ADA step with
              the shear pipe: five steps, finite, K1, K1-bwd, K4, K4-bwd, K2,
              K7, K7-bwd, K8 launches per step (K4 and K4-bwd 0), ms, frames/s
              and peak memory beside phase 11's; (d) phase 12's card vs CPU
              with the shear pipe. No path has a resample without its shift.
 21. demo:    the quality demo and profile_model, run after phase 19:
              (a) `python -m stylegan_v_tpu_torch.train_fvd_demo` in
              process through its main(argv), at the demo's 64^2 widths
              (channel_base 8192, 16 videos x 3 frames, bgc, gamma 1), on a
              32-video moving-pattern zip it writes, for 2 ticks of 10 steps
              with a snapshot and fvd2048_16f (16 real, 16 generated clips,
              the demo's random I3D) after each: both FVD rows finite and
              non-negative, every step's K1, K1-bwd, K4, K4-bwd, K2 launches
              equal to DEMO_LAUNCHES_PER_STEP (by Gpl, every 4th step at
              pl_weight 0 as in the JAX demo, and R1), the run's equal to the
              steps' plus 8 K2 a synthesis outside them, the step's ms from
              stats.jsonl; (b) profile_model's harness on phase 5's FFS-256 G
              at 256^2, 4 videos x 8 frames, 2 iterations: s/iter, frames/s,
              peak memory.
 22. gates:   the quality and stability gates, each through its entry
              point's functions, run last, in phase 21's directory: (a)
              `validate_detectors` on stand-in TorchScript files for the
              three detectors (tools/standin_detectors.py: the port's
              modules with seeded weights, traced, behind a scripted forward
              on raw uint8 with the reference kwargs) at the full
              fixture_inputs: the port on the card against the TorchScript
              on the CPU within max_rel 1e-3 and mean_rel 1e-4, the fixtures
              file's schema, no kernel launch; (b) `fvd_parity` in stub mode
              over phase 21's snapshot and a copy with G_ema moved by 0.05,
              against a reference-format jsonl: the report's fields, K2's 8 a
              synthesis; (c) `validate_shear_onchip` at 32^2 to 256^2 on the
              JAX script's draws: PASS at every size (PSNR > 28 dB, finite
              gradient), ms of the forward and of forward + backward, K7,
              K7-bwd, K8, K4 and K2 launches per resolution; (d)
              `soak_train --rounds 2`: phase 11's FFS-256 G and D and step,
              rounds of 15 main steps and one R1 step, finite, launches 15 x
              phase 11's per step without R1 and 1 x with, a round; (e)
              `diag_dynamics` for 10 steps on phase 21's zip, finite, its
              launches per step as derived at 64^2 without augment.

K2's launches are asserted wherever K1's are: per step from the derived
counts (LAUNCHES_PER_STEP, ADA_LAUNCHES_PER_STEP), per loop run with 12
more for each snapshot grid's synthesis, and on the paths that run G alone
(14, 16 (c)-(e), 17 (e), 18 (a), (d), (e)) as 12 for every synthesis
forward and every backward through one (SynthesisCalls).

Any failed check exits non-zero. Before the last two lines a `[timing]` line
gives each phase's seconds on the host's clock. The last two lines are the
kernel record (each kernel's launches in phase 11, worst error, time, plain and library
time, and its bound: bytes at 3.35 TB/s or float32 operations at 67 TFLOP/s,
whichever is larger; its launches per MoCoGAN step, K1's and K1-bwd's
numbers at the MoCoGAN image D's skips and K4's and K4-bwd's at 48 channels,
from phase 17; K1's and K1-bwd's launches per projection step and their
numbers at the projection's pyramid, from phase 18; each kernel's launches
per rank per MoCoGAN step over two ranks, K1's and K1-bwd's numbers at one
rank's image D skips and K4's and K4-bwd's at its 48-channel warp, from
phase 19; K2's numbers at G's r = 256 up-conv, with the sums over phase
3b's calls and every call's numbers; K7's, K7-bwd's and K8's launches in
phase 20 (c) and their numbers summed over one warp's two passes at the
step's canvas, K8's for its forward with its adjoint, the call the path
makes, beside, from phase 20 (a)) and {"ok": true,
"device": {...}}. There is no CPU path:
without a CUDA device the script fails.
"""
from __future__ import annotations

import copy
import functools
import json
import os
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
REPO = os.path.dirname(os.path.abspath(__file__))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


KERNELS = "K1, K1-bwd, K4, K4-bwd, K2"     # the order of _kernels() and of every count


def _kernels():
    """The five kernel wrappers, whose `launches` count their CUDA launches:
    K1, K1-bwd, K4, K4-bwd, K2 and K2."""
    from stylegan_v_tpu_torch.ops import (affine_warp, affine_warp_bwd, downfirdn2d_x2,
                                          downfirdn2d_x2_bwd, upfirdn2d_k2)
    return (downfirdn2d_x2, downfirdn2d_x2_bwd, affine_warp, affine_warp_bwd, upfirdn2d_k2)


SHEAR_KERNELS = "K7, K7-bwd, K8"   # the order of _shear_kernels() and of their counts


def _shear_kernels():
    """The shear warp's three kernel wrappers (phase 20), counted apart from
    _kernels(): the fused pass K7, K7-bwd and K8; only warp_mode="shear"
    launches them."""
    from stylegan_v_tpu_torch.ops import shear_pass, shear_resample_bwd, shear_shift
    return (shear_pass, shear_resample_bwd, shear_shift)


def k2_per_synthesis(synthesis) -> int:
    """K2 launches of one forward of a SynthesisNetwork, and of one backward
    through it: two a block above 4^2, its up=2 conv's filter pass and its
    image skip's upsample (12 at 256^2)."""
    from stylegan_v_tpu_torch.models.generator import SynthesisBlock
    return 2 * sum(1 for m in synthesis.modules()
                   if isinstance(m, SynthesisBlock) and m.in_channels > 0)


def k2_per_d(D) -> int:
    """K2 launches of one forward of D, and of one backward through it: one a
    block, the filter pass before its 3x3 down=2 conv (6 at 256^2); the
    block's resnet skip is K1's case."""
    from stylegan_v_tpu_torch.models.discriminator import DiscriminatorBlock
    return sum(1 for m in D.modules() if isinstance(m, DiscriminatorBlock))


class SynthesisCalls:
    """While entered, the K2 launches that G's synthesis accounts for:
    k2_per_synthesis for every SynthesisNetwork forward, and as many again
    for every backward through one (a hook on its output). A global module
    forward hook, so that models built inside a CLI count too."""

    def __enter__(self):
        import torch
        from stylegan_v_tpu_torch.models.generator import SynthesisNetwork
        self.forwards = self.backwards = self.k2 = 0

        def hook(module, args, out):
            if isinstance(module, SynthesisNetwork):
                n = k2_per_synthesis(module)
                self.forwards += 1
                self.k2 += n
                if isinstance(out, torch.Tensor) and out.requires_grad:
                    out.register_hook(lambda grad, n=n: self._backward(n))

        self.handle = torch.nn.modules.module.register_module_forward_hook(hook)
        return self

    def _backward(self, n):
        self.backwards += 1
        self.k2 += n

    def __exit__(self, *exc):
        self.handle.remove()


def loop_launches(per_step, steps, synthesis_k2, rounds):
    """The launches of a loop run of `steps` (R1 at every 16th index) from
    the counts per step, but K2's: the steps' K2 apart from G's synthesis
    (K2_SYNTHESIS_PER_STEP a round), plus synthesis_k2, the K2 that G's
    synthesis accounts for in the run (SynthesisCalls: the steps' and the
    snapshot grids')."""
    want = [sum(per_step[i % 16 == 0][j] for i in steps) for j in range(5)]
    want[4] += synthesis_k2 - K2_SYNTHESIS_PER_STEP * rounds * len(steps)
    return tuple(want)


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


def phase_kernel(dev, tag, kind, kernel, plain, sets=None):
    """K1 (kind "down") or K1-bwd ("up") against its plain version at each set
    of D skip shapes in `sets` ((label, [((N, C, H, W), D's dtype there)]);
    by default D's six skips at 2 x 3 and at 16 x 3), in float32 and bf16
    (the first shape of each set with an asymmetric filter too), with
    CUDA-event times of the kernel, its plain version and its library call in
    turns, in D's dtype at each shape; the last set with a cold L2. Returns
    the worst error and, summed over the last set's shapes (one D pass), the
    kernel, plain, library and bound times."""
    import torch
    from stylegan_v_tpu_torch.ops import setup_filter

    sym = setup_filter([1, 3, 3, 1])
    asym = (torch.arange(16, dtype=torch.float32).reshape(4, 4) - 5.0) / 40
    g = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    sets = sets or (("2x3", D_SKIP_SHAPES), ("16x3", D_SKIP_SHAPES_16X3))
    last = sets[-1][0]
    for batch, shapes in sets:
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
                xs = cold_copies(x) if batch == last else [x]
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
                if batch == last:
                    for k, v in (("ms", kern), ("plain_ms", plain_t), ("library_ms", lib),
                                 ("bound_ms", bound)):
                        sums[k] += v
                    sums["bound_by"] = by if sums.get("bound_by", by) == by else "mixed"
                else:
                    small["ms"] += kern
                    small["plain_ms"] += plain_t
                del xs, fns
        if batch != last:
            print(f"{tag} one D pass at {batch}: kernel {small['ms']:.4f} ms, plain "
                  f"{small['plain_ms']:.4f} ms", flush=True)
    print(f"{tag} one D pass at {last} (cold L2): kernel {sums['ms']:.4f} ms, plain "
          f"{sums['plain_ms']:.4f} ms, library {sums['library_ms']:.4f} ms, bound "
          f"{sums['bound_ms']:.4f} ms ({sums['bound_ms'] / sums['ms']:.1%} of it)", flush=True)
    return max_err, sums

# K2's calls on the main path, by their parameters (f's dims, up, down, padding)
K2_CALL_NAMES = {(2, (2, 2), (1, 1), (3, 2, 3, 2)): "G up=2 conv",
                 (2, (2, 2), (1, 1), (2, 1, 2, 1)): "G image skip",
                 (2, (1, 1), (1, 1), (2, 2, 2, 2)): "D down=2 conv's filter",
                 (1, (2, 2), (1, 1), (6, 5, 6, 5)): "augment 2x up",
                 (1, (1, 1), (2, 2), (-1, -1, -1, -1)): "augment 2x down"}


def k2_main_path_calls(dev, G, D):
    """Every distinct K2 call (x shape, dtype, upfirdn2d's arguments) of one
    forward at the step's 16 x 3: G's synthesis, D on its frames and the bgc
    pipe on the frames fused to [16, 9, 256^2], recorded where _UpFirDn2d
    calls upfirdn2d_k2; each with its name."""
    import importlib
    import torch
    from stylegan_v_tpu_torch.training import AUGPIPE_SPECS, AugmentConfig, make_augment_pipe

    U = importlib.import_module("stylegan_v_tpu_torch.ops.upfirdn2d")
    seen, orig = {}, U.upfirdn2d_k2

    def record(x, f, up, down, padding, flip_filter=False, gain=1.0):
        key = (tuple(x.shape), x.dtype, tuple(up), tuple(down), tuple(padding), flip_filter,
               gain, tuple(f.shape))
        seen.setdefault(key, (f, K2_CALL_NAMES.get((f.ndim, tuple(up), tuple(down),
                                                      tuple(padding)), "other")))
        return orig(x, f, up, down, padding, flip_filter, gain)

    (B, F, res), g = TRAIN_SHAPE, torch.Generator(device=dev).manual_seed(5)
    z = torch.randn(B, G.cfg.z_dim, generator=g, device=dev)
    t = torch.arange(F, dtype=torch.float32, device=dev)[None].repeat(B, 1)
    pipe = make_augment_pipe(AugmentConfig(**AUGPIPE_SPECS["bgc"], warp_upsample=2))
    U.upfirdn2d_k2 = record
    try:
        with torch.no_grad():
            frames = G(z, None, t, generator=g)
            D(frames, None, t)
            pipe(g, frames.reshape(B, F * 3, res, res), ADA_P)
    finally:
        U.upfirdn2d_k2 = orig
    return [(name, shape, dtype, (f, list(up), list(down), list(pad), flip, gain))
            for (shape, dtype, up, down, pad, flip, gain, _), (f, name) in seen.items()]


def chained(fns, x):
    """fns[-1](... fns[0](x))."""
    for fn in fns:
        x = fn(x)
    return x


def k2_library(p, x):
    """The one PyTorch call that computes K2's pass p on x, or None: F.conv2d
    where up is 1 and the padding symmetric on each axis (a negative one, a
    crop, as a view of x), F.conv_transpose2d where down is 1 and the
    padding is its crop. A yardstick only; the port never calls it."""
    import torch.nn.functional as F
    from stylegan_v_tpu_torch.ops.upfirdn2d_kernel import pass_out_hw
    (ux, uy), (dx, dy), (px0, px1, py0, py1) = p.up, p.down, p.pad
    C, (H, W), (fh, fw) = x.shape[1], x.shape[2:], p.k.shape
    k = p.k.to(x.device, x.dtype)
    if (ux, uy) == (1, 1) and px0 == px1 and py0 == py1:
        w = k[None, None].expand(C, 1, fh, fw).contiguous()
        cy, cx = max(-py0, 0), max(-px0, 0)
        return lambda x: F.conv2d(x[:, :, cy:x.shape[2] - cy, cx:x.shape[3] - cx], w,
                                  stride=(dy, dx), padding=(max(py0, 0), max(px0, 0)),
                                  groups=C)
    qy, qx = fh - 1 - py0, fw - 1 - px0     # y[o] = full[o + q] of the transposed conv
    if ((dx, dy) == (1, 1) and qy >= 0 and qx >= 0
            and ((H - 1) * uy + fh - 2 * qy, (W - 1) * ux + fw - 2 * qx) == pass_out_hw(p, H, W)):
        w = k.flip([0, 1])[None, None].expand(C, 1, fh, fw).contiguous()
        return lambda x: F.conv_transpose2d(x, w, stride=(uy, ux), padding=(qy, qx), groups=C)
    return None


def k2_direct(xs, args):
    """A function that launches the kernel of upfirdn2d_k2(x, *args) straight
    through K2's C entry point on xs[0], xs[1], ... in turn (one shape and
    alignment) into one output: the kernel's time without the wrapper's
    host path (the plan lookup, the output's allocation). It counts no
    launch."""
    import torch
    from stylegan_v_tpu_torch.ops import cuda_build, upfirdn2d_kernel as k2
    check(len({x.data_ptr() % 16 for x in xs}) == 1, "K2's timed inputs differ in alignment")
    L = k2._call_launch(xs[0], *args)
    fn = cuda_build.entry_point("upfirdn2d", k2._ARGTYPES)
    y = torch.empty(L.out_shape, dtype=xs[0].dtype, device=xs[0].device)
    code, n = cuda_build.DTYPE_CODES[xs[0].dtype], [0]

    def call():
        n[0] += 1
        x = xs[n[0] % len(xs)]
        err = fn(x.data_ptr(), y.data_ptr(), L.taps, code, L.variant, L.plan,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"K2's direct launch failed with CUDA error {err}")
    return call


def k2_call(dev, g, tag, name, shape, path_dtype, args, timed=True):
    """K2 at one call: one launch, against its plain version in float32 and
    bf16 (the worst error and whether every output is equal to the bit);
    then, where `timed`, in the path's dtype with a cold L2, CUDA-event
    times in turns of its plain version, the wrapper's call (`ms` and
    `share_of_bound`, as phase 3b has always timed a kernel: they hold the
    host's launch gaps where the host is slower than the kernel), the kernel
    launched straight through its C entry point (`kernel_ms` and
    `kernel_share_of_bound`, k2_direct: without the wrapper's host path) and
    the one PyTorch call a pass that computes it (chained over a separable
    call's two passes, where each has one); and the bound: the call's
    input and output bytes once at 3.35 TB/s (a separable call's
    intermediate is not the function's work), or the multiply-adds of its
    passes that land on source samples at the float32 rate. Returns (worst
    error, bitwise equal, the row or None)."""
    import torch
    from stylegan_v_tpu_torch.ops import upfirdn2d_k2, upfirdn2d_k2_plain
    from stylegan_v_tpu_torch.ops.upfirdn2d_kernel import passes

    max_err, equal = 0.0, True
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        before = upfirdn2d_k2.launches
        got = upfirdn2d_k2(x, *args)
        launched = upfirdn2d_k2.launches - before
        want = upfirdn2d_k2_plain(x, *args)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        tol = KERNEL_TOL[str(dtype).split(".")[-1]]
        check(launched == 1, f"{tag} {name} {list(shape)} {dtype}: {launched} launches, not 1")
        check(got.shape == want.shape and torch.allclose(got.float(), want.float(),
                                                         rtol=tol, atol=tol),
              f"{tag} {name} {list(shape)} {dtype}: max err {e}")
        max_err, equal = max(max_err, e), equal and torch.equal(got, want)
        if dtype == path_dtype:
            xp = x
    if not timed:
        return max_err, equal, None
    x, tol = xp, KERNEL_TOL[str(path_dtype).split(".")[-1]]
    flops, libs, y = 0, [], x
    for p in passes(*args):
        lib = k2_library(p, y)
        out = upfirdn2d_k2_plain(y, p.k, list(p.up), list(p.down), list(p.pad), True, 1.0)
        if lib is not None:
            e_lib = (lib(y).float() - out.float()).abs().max().item()
            check(e_lib <= tol * max(out.float().abs().max().item(), 1.0),
                  f"{tag} {name}: the library call differs from the plain pass by {e_lib}")
        libs.append(lib)
        flops += 2 * out.numel() * p.k.numel() // (p.up[0] * p.up[1])
        y = out
    nbytes = (x.numel() + y.numel()) * x.element_size()
    xs = cold_copies(x)
    fns = [rotating(lambda x: upfirdn2d_k2_plain(x, *args), xs),
           rotating(lambda x: upfirdn2d_k2(x, *args), xs), k2_direct(xs, args)]
    if all(lib is not None for lib in libs):
        fns.append(rotating(functools.partial(chained, libs), xs))
    for fn in fns:                                  # warm-up
        fn(), fn()
    times = in_turns(fns, 10)
    plain_t, call_t, kern = times[:3]
    lib_t = times[3] if len(times) > 3 else None
    bound, by = bound_ms(nbytes, flops)
    row = dict(name=name, shape=list(shape), dtype=str(path_dtype).split(".")[-1],
               passes=len(libs), ms=call_t, share_of_bound=bound / call_t, kernel_ms=kern,
               kernel_share_of_bound=bound / kern, plain_ms=plain_t, library_ms=lib_t,
               bound_ms=bound, bound_by=by, max_abs_err=max_err, equal_to_the_bit=equal)
    lib_s = f"{lib_t:.4f} ms" if lib_t is not None else "none"
    print(f"{tag} {name} {list(shape)} {row['dtype']} ({len(libs)} pass"
          f"{'es' if len(libs) > 1 else ''}, one launch): kernel {call_t:.4f} ms a call "
          f"({nbytes / (call_t * 1e-3) / 1e9:.0f} GB/s, {bound / call_t:.1%} of the "
          f"{bound:.4f} ms bound), {kern:.4f} ms launched directly ({bound / kern:.1%})  plain "
          f"{plain_t:.4f} ms  library {lib_s}; max_abs_err {max_err:.3g} (float32 and bf16), "
          f"equal to the bit: {equal}", flush=True)
    return max_err, equal, row


# Separable calls off the main path, each held to its plain version on the
# card: the guarded instantiation, whose axes come at run time (a lone row or
# column filter with a one-tap other axis, mixed axes, phase 1 at up 2, a
# 10-tap filter).
K2_OFF_PATH = [  # (name, x shape, filter, upfirdn2d's (up, down, padding, flip, gain))
    ("lone row [1, 7], up (2, 1)", (4, 16, 67, 71), ((1, 7), None),
     ([2, 1], [1, 1], [3, 2, 1, -1], False, 1.0)),
    ("lone column [9, 1], down (1, 2)", (4, 16, 131, 70), ((9, 1), None),
     ([1, 1], [1, 2], [-1, 2, 4, 4], False, 1.0)),
    ("12-tap, up (2, 1), down (1, 2)", (4, 16, 67, 90), (None, 12),
     ([2, 1], [1, 2], [5, 6, 6, 5], False, 1.0)),
    ("12-tap up 2, phase 1", (4, 16, 67, 69), (None, 12), ([2, 2], [1, 1], [5, 6, 5, 6],
                                                           False, 4.0)),
    ("10-tap down 2", (4, 16, 130, 139), (None, 10), ([1, 1], [2, 2], [3, 3, 3, 3], False, 1.0)),
]


def k2_off_path_args(filt, rest):
    import torch
    from stylegan_v_tpu_torch.ops import setup_filter
    from stylegan_v_tpu_torch.training.augment import _SYM6
    shape, taps = filt
    if shape is not None:
        f = torch.arange(1, shape[0] * shape[1] + 1, dtype=torch.float32).reshape(shape)
        f = f / f.sum()
    else:
        f = setup_filter(_SYM6) if taps == 12 else setup_filter(list(range(1, 6)) * 2)
    return (f, *rest)


def phase_k2(dev, G, D):
    """Phase 3b: K2 against its plain version at every distinct K2 call of one
    forward at 16 x 3 (G, D, the bgc pipe's separable 12-tap calls) and at
    each one's adjoint, one launch a call, float32 and bf16, timed in the
    path's dtype (k2_call); D's filters also with an asymmetric 4x4 filter,
    which takes the 2-D sum where the main path's bf16 calls sum rows, then
    columns; and the separable calls of K2_OFF_PATH. Returns the worst error,
    G's r = 256 up-conv call's row, the sums over the forward calls and over
    the adjoints, and every call's row."""
    import torch
    from stylegan_v_tpu_torch.ops import upfirdn2d_k2, upfirdn2d_k2_plain
    from stylegan_v_tpu_torch.ops.upfirdn2d import adjoint_args
    from stylegan_v_tpu_torch.ops.upfirdn2d_kernel import (FULL, ROWS_THEN_COLUMNS, pass_launch,
                                                           pass_out_hw, passes)

    tag = "[3b k2]"
    t_phase = time.perf_counter()
    entries = []
    for name, shape, dtype, args in k2_main_path_calls(dev, G, D):
        H, W = shape[2:]
        for p in passes(*args):
            H, W = pass_out_hw(p, H, W)
        entries.append((name, shape, dtype, args))
        entries.append((f"{name}, adjoint", (*shape[:2], H, W), dtype,
                        adjoint_args(*args, shape[2:], (H, W))))
    g = torch.Generator(device=dev).manual_seed(6)
    max_err, rows = 0.0, []
    for name, shape, path_dtype, args in entries:
        e, _, row = k2_call(dev, g, tag, name, shape, path_dtype, args)
        max_err = max(max_err, e)
        rows.append(row)
    sep = [r for r in rows if r["name"].startswith("augment")]
    check(len(sep) == 4 and all(r["passes"] == 2 for r in sep),
          f"{tag} the pipe's separable calls: {[(r['name'], r['shape']) for r in sep]}")
    off = []
    for name, shape, filt, rest in K2_OFF_PATH:
        args = k2_off_path_args(filt, rest)
        H, W = shape[2:]
        for p in passes(*args):
            H, W = pass_out_hw(p, H, W)
        e, equal, _ = k2_call(dev, g, tag, name, shape, torch.float32, args, timed=False)
        e2, equal2, _ = k2_call(dev, g, tag, f"{name}, adjoint", (*shape[:2], H, W),
                                torch.float32, adjoint_args(*args, shape[2:], (H, W)),
                                timed=False)
        off.append(f"{name} {max(e, e2):.3g}{' (to the bit)' if equal and equal2 else ''}")
        max_err = max(max_err, e, e2)
    print(f"{tag} separable calls off the main path and their adjoints, float32 and bf16, one "
          f"launch each, max_abs_err: " + "; ".join(off), flush=True)
    # D's pre-filter with an asymmetric 4x4 filter, not an outer product: the
    # 2-D sum, which no main-path call takes (they sum rows, then columns)
    asym = (torch.arange(16, dtype=torch.float32).reshape(4, 4) - 5.0) / 40
    n_asym = 0
    for name, shape, path_dtype, args in entries:
        p = passes(*args)[0]
        if p.k.ndim == 2 and p.k.shape == (4, 4):
            mode = pass_launch(p, shape, path_dtype, 0)[1].mode
            want = ROWS_THEN_COLUMNS if path_dtype == torch.bfloat16 else FULL
            check(mode == want, f"{tag} {name} {list(shape)} {path_dtype}: sums in mode {mode}, "
                                f"expected {want} (bf16 rows, then columns; float32 in 2-D)")
        if not name.startswith("D down=2 conv's filter"):
            continue
        a_args = (asym,) + tuple(args[1:])
        check(pass_launch(passes(*a_args)[0], shape, path_dtype, 0)[1].mode == FULL,
              f"{tag} the asymmetric filter does not take the 2-D sum")
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            got, want = upfirdn2d_k2(x, *a_args), upfirdn2d_k2_plain(x, *a_args)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL[str(dtype).split(".")[-1]]
            check(got.shape == want.shape and torch.allclose(got.float(), want.float(),
                                                             rtol=tol, atol=tol),
                  f"{tag} {name} {list(shape)} {dtype}, asymmetric filter: max err {e}")
            max_err = max(max_err, e)
            n_asym += 1
    check(n_asym == 24, f"{tag} {n_asym} asymmetric-filter checks, expected 24")
    print(f"{tag} D's pre-filter at its {n_asym // 4} shapes and their adjoints with an "
          f"asymmetric 4x4 filter (the 2-D sum), float32 and bf16: within the tolerance; every "
          f"bf16 4x4 main-path call sums rows, then columns, every float32 one in 2-D",
          flush=True)
    sums = {}
    for which in ("forward", "adjoint"):
        sel = [r for r in rows if r["name"].endswith("adjoint") == (which == "adjoint")]
        with_lib = [r for r in sel if r["library_ms"] is not None]
        sums[which] = {"calls": len(sel), "ms": sum(r["ms"] for r in sel),
                       "kernel_ms": sum(r["kernel_ms"] for r in sel),
                       "plain_ms": sum(r["plain_ms"] for r in sel),
                       "bound_ms": sum(r["bound_ms"] for r in sel),
                       "calls_with_library": len(with_lib),
                       "library_ms": sum(r["library_ms"] for r in with_lib),
                       "ms_where_library": sum(r["ms"] for r in with_lib)}
        m = sums[which]
        print(f"{tag} the {m['calls']} {which} calls of one forward at 16x3 (cold L2): kernel "
              f"{m['ms']:.4f} ms a call ({m['kernel_ms']:.4f} launched directly), plain "
              f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms ({m['bound_ms'] / m['ms']:.1%}"
              f" of the calls); the {m['calls_with_library']} with a library call: kernel "
              f"{m['ms_where_library']:.4f} ms, library {m['library_ms']:.4f} ms", flush=True)
    head = max((r for r in rows if r["name"] == "G up=2 conv"), key=lambda r: r["shape"][2])
    check(head["shape"] == [48, 128, 128, 128] and head["dtype"] == "bfloat16",
          f"{tag} G's largest up-conv call {head}")
    print(f"{tag} G's r = 256 up-conv [48, 128, 128^2] bf16: {head['share_of_bound']:.1%} of "
          f"its bound a call, {head['kernel_share_of_bound']:.1%} launched directly; phase 3b "
          f"took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return max_err, head, sums, rows


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
    from stylegan_v_tpu_torch.ops import downfirdn2d_x2, upfirdn2d_k2

    g = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn(4, G.cfg.z_dim, generator=g, device=dev)
    t = torch.tensor([[0.0, 5.0, 17.0], [3.0, 20.0, 60.0], [100.0, 101.0, 130.0],
                      [500.0, 700.0, 1000.0]], device=dev)
    downfirdn2d_x2.launches = upfirdn2d_k2.launches = 0
    with torch.no_grad():
        frames = G(z, None, t, generator=g)
        logits = D(frames, None, t)["image_logits"]
    torch.cuda.synchronize()
    launches, k2 = downfirdn2d_x2.launches, upfirdn2d_k2.launches
    k2_want = k2_per_synthesis(G.synthesis) + k2_per_d(D)
    check(tuple(frames.shape) == (12, 3, 256, 256) and frames.dtype == torch.float32,
          f"frames {tuple(frames.shape)} {frames.dtype}")
    check(bool(torch.isfinite(frames).all()), "non-finite frames")
    check(tuple(logits.shape) == (4,) and bool(torch.isfinite(logits).all()),
          f"logits {logits.tolist()}")
    check(launches == 6, f"downfirdn2d_x2 launched {launches} times, expected 6")
    check(k2 == k2_want == 18, f"upfirdn2d_k2 launched {k2} times, expected {k2_want} (18)")
    print(f"[4 slice] FFS-256 G->D: frames {list(frames.shape)} finite, std "
          f"{frames.std().item():.4f}; logits {[round(v, 4) for v in logits.tolist()]}; "
          f"downfirdn2d_x2 launches {launches}, upfirdn2d_k2 launches {k2} (G 12, D 6)",
          flush=True)
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
    from stylegan_v_tpu_torch.ops import downfirdn2d_x2, upfirdn2d_k2

    G, D, z, t, mz, _ = reduced_models()

    def run(G, D, device):
        with torch.no_grad():
            frames = G(z.to(device), None, t.to(device), motion_z=mz.to(device))
            return frames.cpu(), D(frames, None, t.to(device))["image_logits"].cpu()

    before = (downfirdn2d_x2.launches, upfirdn2d_k2.launches)
    ref_frames, ref_logits = run(G, D, torch.device("cpu"))
    check((downfirdn2d_x2.launches, upfirdn2d_k2.launches) == before,
          "the CPU run launched a kernel")
    frames, logits = run(copy.deepcopy(G).to(dev), copy.deepcopy(D).to(dev), dev)
    want = (before[0] + 3, before[1] + k2_per_synthesis(G.synthesis) + k2_per_d(D))
    check((downfirdn2d_x2.launches, upfirdn2d_k2.launches) == want,
          f"the card run launched K1, K2 {(downfirdn2d_x2.launches, upfirdn2d_k2.launches)} "
          f"times, expected {want}")
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
# K2 (csrc/upfirdn2d.cu, one launch a call) runs 12 calls in a G forward at
# 256^2 (k2_per_synthesis: 6 up=2 convs, 6 image skips) and 6 in a D forward
# (k2_per_d: the filter before each 3x3 down=2 conv); a backward through
# either runs as many again (the adjoint of a K2 call is a K2 call).
# Without R1: Gmain's G forward, D forward and backward, G backward (12 + 6 +
# 6 + 12), Dgen's G forward under no_grad and D forward and backward (12 + 6
# + 6), Dreal's D forward and backward (6 + 6): 72. Dr1 adds a D forward (6),
# the first-order grad into the frames (6) and that grad's backward, which
# runs a K2 call for each of those 12 nodes: 96. Of each step, 36 are G's
# (K2_SYNTHESIS_PER_STEP: two forwards and one backward).
LAUNCHES_PER_STEP = {False: (18, 18, 72), True: (30, 30, 96)}
K2_SYNTHESIS_PER_STEP = 36
K2_PER_SYNTHESIS_256 = 12
# With the ADA pipe (phase 11), K4 runs in every D call of the step: Gmain,
# Dgen and Dreal (3); K4-bwd in Gmain's backward into G (1): Dgen's frames come
# from G under no_grad and Dreal's from data, so no gradient runs back through
# their warps. Dr1 adds a K4 forward, the K4-bwd of the first-order grad into
# the real frames, and that grad's backward, which runs K4 again: 5 and 2. The
# warp's 12-tap filters never take K1's case, so K1 and K1-bwd stay as above.
# They are K2's: each warp has 2 K2 calls beside it (a 12-tap 2x up and 2x
# down, each its row and column pass in one launch), so the pipe adds 2 a K4
# and 2 a K4-bwd: 72 + 8 = 80 without R1, 96 + 14 = 110 with.
ADA_LAUNCHES_PER_STEP = {False: (18, 18, 3, 1, 80), True: (30, 30, 5, 2, 110)}
# With warp_mode="shear" (phase 20) each warp of the pipe is two passes, each
# one launch of the fused pass K7 (resample and shift): a forward launches 2
# K7; a backward, the transpose of each pass, 2 K8 (the shift's adjoint) and
# 2 K7-bwd; R1's backward of a backward is a forward again, 2 K7. So phase
# 11's 3 (5 with R1) K4 and 1 (2) K4-bwd a step become 6 (10) K7, 2 (4)
# K7-bwd and 2 (4) K8; K4 and K4-bwd launch no more, no path launches a
# resample without its shift (the port has none), and K1, K1-bwd and K2 stay
# phase 11's. In the order K1, K1-bwd, K4, K4-bwd, K2, K7, K7-bwd, K8:
SHEAR_LAUNCHES_PER_STEP = {
    r1: (k1, k1b, 0, 0, k2, 2 * k4, 2 * k4b, 2 * k4b)
    for r1, (k1, k1b, k4, k4b, k2) in ADA_LAUNCHES_PER_STEP.items()}
TRAIN_SHAPE = (16, 3, 256)     # videos, frames, resolution: bench.py:bench_train_step's
ADA_P = 0.5                    # the step's cost does not depend on p; at 0.5 transforms fire
WARP_BATCH = (16, 9, 256)      # the pipe's input at TRAIN_SHAPE: videos, 3 frames x RGB, size


def phase_train(dev, smi, G, D, augment, no_aug=None, warp_mode="auto", k4=None):
    """Phase 8 (augment=False) or 11 (the bgc pipe, warp_upsample=2), or 20 (c)
    (that pipe with warp_mode="shear"): five steps (R1, three without, R1) on G
    and D as they are; returns the launches of the run's kernels and (ms
    without R1, ms with R1, amortised ms, frames/s, peak GiB). `no_aug` and
    `k4` are phase 8's and phase 11's numbers, printed beside."""
    import torch
    from stylegan_v_tpu_torch.ops import (affine_warp, affine_warp_bwd, downfirdn2d_x2,
                                          downfirdn2d_x2_bwd, upfirdn2d_k2)
    from stylegan_v_tpu_torch.training import (AUGPIPE_SPECS, AugmentConfig, LossConfig,
                                               OptimizerConfig, TrainingConfig,
                                               init_train_state, make_augment_pipe,
                                               make_train_step)

    shear = warp_mode == "shear"
    kernels = [downfirdn2d_x2, downfirdn2d_x2_bwd] + ([affine_warp, affine_warp_bwd]
                                                      if augment else []) + [upfirdn2d_k2]
    kernels += list(_shear_kernels()) if shear else []
    expected = (SHEAR_LAUNCHES_PER_STEP if shear else
                ADA_LAUNCHES_PER_STEP if augment else LAUNCHES_PER_STEP)
    names = ", ".join(("K1", "K1-bwd") + (("K4", "K4-bwd") if augment else ()) + ("K2",)
                      + (("K7", "K7-bwd", "K8") if shear else ()))
    tag = "[20 shear] (c)" if shear else "[11 ada]" if augment else "[8 train]"
    (B, F, res), r1_every = TRAIN_SHAPE, 16
    tcfg = TrainingConfig(batch_size=B, ada_target=0.6)
    lcfg = LossConfig(r1_gamma=0.0002 * res ** 2 / B, pl_weight=0.0, video_consistent_aug=True)
    opt = OptimizerConfig(0.0025)
    aug = (make_augment_pipe(AugmentConfig(**AUGPIPE_SPECS["bgc"], warp_upsample=2,
                                           warp_mode=warp_mode)) if augment else None)
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
    what = (f"WITH ADA (bgc, warp_upsample=2{', warp_mode shear' if shear else ''}, "
            f"augment_p {ADA_P})" if augment else "NO augment")
    beside = ""
    if no_aug is not None:
        beside = (f"; phase 8 without augment: {no_aug[0]:.1f} / {no_aug[1]:.1f} ms, "
                  f"{no_aug[3]:.1f} frames/s")
    if k4 is not None:
        beside = (f"; phase 11 with K4 in this run: {k4[0]:.1f} / {k4[1]:.1f} ms, amortised "
                  f"{k4[2]:.1f} ms/step, {k4[3]:.1f} frames/s, peak {k4[4]:.2f} GiB")
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
    from stylegan_v_tpu_torch.ops import downfirdn2d_x2, downfirdn2d_x2_bwd, upfirdn2d_k2
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

    kernels = (downfirdn2d_x2, downfirdn2d_x2_bwd, upfirdn2d_k2)
    before = tuple(k.launches for k in kernels)
    want = grads(copy.deepcopy(G), copy.deepcopy(D), torch.device("cpu"))
    check(tuple(k.launches for k in kernels) == before, "the CPU run launched a kernel")
    got = grads(copy.deepcopy(G).to(dev), copy.deepcopy(D).to(dev), dev)
    ran = tuple(k.launches - b for k, b in zip(kernels, before))
    check(min(ran) > 0, f"the card run launched K1, K1-bwd, K2 {ran} times")
    msgs = []
    for name, g, w in (("Gmain dG", got[0], want[0]), ("Dr1 dD", got[1], want[1])):
        scale = max(v.abs().max().item() for v in w.values())
        err, worst = max((((g[k] - w[k]).abs().max().item()), k) for k in w)
        check(all(bool(torch.isfinite(v).all()) for v in g.values())
              and err <= PARITY_TOL * scale,
              f"card vs CPU {name}: max err {err} at {worst} > {PARITY_TOL} * {scale}")
        msgs.append(f"{name} max_abs_err {err:.3g} at {worst} (scale {scale:.3g})")
    print(f"[9 grads] reduced width, card (K1, K1-bwd, K2 launched {ran}) vs CPU, tol "
          f"{PARITY_TOL} x scale: " + "; ".join(msgs), flush=True)


def warp_calls(dev, batch=WARP_BATCH, upsamples=(2, 1)):
    """The K4 calls of the ADA pipe on `batch` (videos, fused channels, size;
    16 videos x 3 frames, 9 channels, by default), as (input shape, G_inv,
    out_h, out_w, dtype) for each of `upsamples` (warp_upsample), taken from
    the pipe itself run on the card with bgc draws at p = 1."""
    import torch
    from stylegan_v_tpu_torch.training import augment as taug

    (N, C, H), calls, warp = batch, [], taug.affine_grid_sample

    def recorded(x, G_inv, out_h, out_w, mode="reflect"):
        calls.append((tuple(x.shape), G_inv.detach().clone(), out_h, out_w, x.dtype))
        return warp(x, G_inv, out_h, out_w, mode)

    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.rand(N, C, H, H, generator=g, device=dev) * 2 - 1
    taug.affine_grid_sample = recorded
    try:
        for warp_upsample in upsamples:
            pipe = taug.make_augment_pipe(taug.AugmentConfig(**taug.AUGPIPE_SPECS["bgc"],
                                                             warp_upsample=warp_upsample))
            with torch.no_grad():
                pipe(g, x, torch.ones((), device=dev))
    finally:
        taug.affine_grid_sample = warp
    shapes = [(c[0], c[2], c[3]) for c in calls]
    # warp_upsample=2: reflect pad 6, 2x up, warp to the canvas less 3 a side; 1: direct
    big, out = 2 * (H + 12), 2 * (H + 6)
    want = {2: ((N, C, big, big), out, out), 1: ((N, C, H, H), H, H)}
    check(shapes == [want[u] for u in upsamples], f"the ADA pipe's warp calls: {shapes}")
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


K2_PIPE = {}   # K2's rows at the ADA pipe's separable calls (phase_warp), by its batch


def k2_pipe(dev, batch, tag):
    """K2 at the ADA pipe's separable calls on `batch` (videos, fused
    channels, size; warp_upsample=2): the 12-tap 2x up [N, C, (H + 12)^2] ->
    (2H + 24)^2, the 2x down [N, C, (2H + 12)^2] -> H^2 and their adjoints, as
    k2_call in the pipe's bf16; returns their rows."""
    import torch
    from stylegan_v_tpu_torch.ops import setup_filter
    from stylegan_v_tpu_torch.ops.upfirdn2d import adjoint_args
    from stylegan_v_tpu_torch.training.augment import _SYM6

    N, C, H = batch
    f = setup_filter(_SYM6)
    g = torch.Generator(device=dev).manual_seed(17)
    rows = []
    for name, size, out, args in (
            ("augment 2x up", H + 12, 2 * H + 24, (f, [2, 2], [1, 1], [6, 5, 6, 5], False, 4.0)),
            ("augment 2x down", 2 * H + 12, H, (f, [1, 1], [2, 2], [-1, -1, -1, -1], True, 1.0))):
        rows.append(k2_call(dev, g, tag, name, (N, C, size, size), torch.bfloat16, args)[2])
        rows.append(k2_call(dev, g, tag, f"{name}, adjoint", (N, C, out, out), torch.bfloat16,
                            adjoint_args(*args, (size, size), (out, out)))[2])
        torch.cuda.empty_cache()
    return rows


def phase_warp(dev, batch=WARP_BATCH, upsamples=(2, 1), tag="[10 warp]", autograd=True):
    """K4 and K4-bwd against their plain versions at the pipe's shapes on
    `batch` (warp_calls), K4 against its reference design to the bit, and,
    at warp_upsample=2, K2 at the pipe's separable calls (k2_pipe, its rows
    in K2_PIPE); returns
    each one's worst error and its time, the plain version's and the nearest
    PyTorch call's at the ADA step's call (the 536^2 canvas in the pipe's
    bf16), and for K4 its reference design's time there. `autograd`: then
    autograd through K4 to second order."""
    import math
    import torch
    import torch.nn.functional as F
    from stylegan_v_tpu_torch.ops import (affine_grid_sample, affine_grid_sample_bwd_plain,
                                          affine_grid_sample_plain, affine_warp,
                                          affine_warp_bwd)
    from stylegan_v_tpu_torch.ops.grid_sample import _warp_tile_boxes

    calls = warp_calls(dev, batch, upsamples)
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
                ch = _warp_tile_boxes(G, H, W, out_h, out_w, channels=C,
                                      itemsize=x.element_size()).channels
                staged[set_name] = "/".join(f"{float(share):.4f}" for share in (
                    (ch == C).mean(), ((ch > 0) & (ch < C)).mean(), (ch == 0).mean()))
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
            print(f"{tag} {[N, C, H, W]} -> {[out_h, out_w]} {dtype_name}: K4 "
                  f"{k4['kernel']:.4f} ms ({bound / k4['kernel']:.1%} of the {bound:.4f} ms "
                  f"bound) reference design {k4['per_pixel']:.4f} plain {k4['plain']:.4f}"
                  + (f" nearest {k4['nearest']:.4f}" if at_path else "")
                  + f"; K4-bwd {k4b['kernel']:.4f} ms ({bound / k4b['kernel']:.1%}) plain "
                  f"{k4b['plain']:.4f}" + (f" nearest {k4b['nearest']:.4f}" if at_path else "")
                  + f"; max_abs_err over {', '.join(sets)}: K4 {err['K4']:.3g}, K4-bwd "
                  f"{err['K4-bwd']:.3g}; K4 equal to the bit to its reference design, to the "
                  f"plain version {sum(equal_plain)} of {len(equal_plain)}; K4 tiles staged "
                  f"whole/chunked/direct by the plan (computed on the host, not measured) "
                  + ", ".join(f"{k} {v}" for k, v in staged.items())
                  + ("; K4-bwd repeats to the bit" if i == 0 else ""), flush=True)
    if 2 in upsamples:                 # K2 beside the warp: the pipe's separable calls
        K2_PIPE[f"{batch[0]}x{batch[1]}"] = k2_pipe(dev, batch, f"{tag} K2")
    if not autograd:
        return ((worst["K4"], *path["K4"]), (worst["K4-bwd"], *path["K4-bwd"]))
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


def phase_aug_parity(dev, warp_mode="auto"):
    """Card vs CPU at phase 6's width with the bgc pipe (warp_upsample=2) and
    the same draws: the pipe's output, Gmain's dG and Dr1's dD. The geometry
    runs in float32 on both (on the card the pipe's default is bf16). D's
    input takes the CPU run's augmented values on the card (the gradient still
    runs through the card's pipe), as phase 9 pins the frames. Phase 12, or
    with warp_mode="shear" phase 20 (d)."""
    import torch
    from stylegan_v_tpu_torch.ops import affine_warp, affine_warp_bwd, upfirdn2d_k2
    from stylegan_v_tpu_torch.training import (AUGPIPE_SPECS, AugmentConfig, GANLoss,
                                               LossConfig, make_augment_pipe)

    G, D, z, t, mz, gen = reduced_models()
    real = torch.rand(12, 3, 32, 32, generator=gen) * 2 - 1
    shear = warp_mode == "shear"
    tag = "[20 shear] (d)" if shear else "[12 augpar]"
    pipe = make_augment_pipe(AugmentConfig(**AUGPIPE_SPECS["bgc"], warp_upsample=2,
                                           geom_dtype="float32", warp_mode=warp_mode))
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

    kernels = (affine_warp, affine_warp_bwd, upfirdn2d_k2) + (_shear_kernels() if shear else ())
    before = tuple(k.launches for k in kernels)
    want = run(copy.deepcopy(G), copy.deepcopy(D), torch.device("cpu"))
    check(tuple(k.launches for k in kernels) == before, "the CPU run launched a kernel")
    for src in draws.values():
        src.replay()
    got = run(copy.deepcopy(G).to(dev), copy.deepcopy(D).to(dev), dev)
    ran = tuple(k.launches - b for k, b in zip(kernels, before))
    # the pipe 1 K4; Gmain 1 K4 + 1 K4-bwd; Dr1 1 K4 + 1 K4-bwd + 1 K4 (R1's backward).
    # K2: 2 beside each K4 and K4-bwd (12), G forward and backward (2 kG), D forward
    # and backward in Gmain, forward, first-order grad and its backward in Dr1 (6 kD)
    k2 = 12 + 2 * k2_per_synthesis(G.synthesis) + 6 * k2_per_d(D)
    # with the shear pipe: 2 K7 (the fused pass) for each of those 4 K4, 2 K8 and 2
    # K7-bwd for each of the 2 K4-bwd
    want_ran = (0, 0, k2, 8, 4, 4) if shear else (4, 2, k2)
    names = "K4, K4-bwd, K2" + (", K7, K7-bwd, K8" if shear else "")
    check(ran == want_ran,
          f"{tag} the card run launched {names} {ran} times, expected {want_ran}")
    msgs = []
    for name, g, w in (("pipe output", got[0], want[0]), ("Gmain dG", got[1], want[1]),
                       ("Dr1 dD", got[2], want[2])):
        scale = max(v.abs().max().item() for v in w.values())
        err, worst = max((((g[k] - w[k]).abs().max().item()), k) for k in w)
        check(all(bool(torch.isfinite(v).all()) for v in g.values())
              and err <= PARITY_TOL * scale,
              f"{tag} card vs CPU with ADA {name}: max err {err} at {worst} > {PARITY_TOL} * "
              f"{scale}")
        msgs.append(f"{name} max_abs_err {err:.3g} (scale {scale:.3g})")
    print(f"{tag} reduced width, bgc at p {ADA_P}, warp_mode {warp_mode}, card ({names} launched "
          f"{ran}) vs CPU, tol {PARITY_TOL} x scale: " + "; ".join(msgs), flush=True)


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


def _equal_trees(a, b, where="", tag="[13 loop]"):
    """Every tensor of a nest of dicts and lists equal to the bit; returns the count."""
    import torch
    if isinstance(a, torch.Tensor):
        check(isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b),
              f"{tag} {where} differs from the saved state")
        return 1
    if isinstance(a, dict):
        check(isinstance(b, dict) and set(a) == set(b), f"{tag} {where} keys differ")
        return sum(_equal_trees(a[k], b[k], f"{where}.{k}", tag) for k in a)
    if isinstance(a, (list, tuple)):
        check(len(a) == len(b), f"{tag} {where} lengths differ")
        return sum(_equal_trees(x, y, f"{where}[{i}]", tag)
                   for i, (x, y) in enumerate(zip(a, b)))
    check(a == b, f"{tag} {where}: {a} != {b}")
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

    # the loop's host packages: Pillow for the .jpg grids, cv2 for the .mp4, PyYAML
    # for the configs (the card had all three when probed)
    missing = [m for m in ("PIL", "cv2", "yaml") if importlib.util.find_spec(m) is None]
    check(not missing, f"[13 loop] the loop's host packages are missing: {missing}")
    kernels = _kernels()
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
    results, counts, synthesis, peaks, out = [], [], [], [], io.StringIO()
    try:
        for extra in ([], ["training.resume=latest", "training.kimg=2"]):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for k in kernels:
                k.launches = 0
            with contextlib.redirect_stdout(out), SynthesisCalls() as syn:
                results.append(entry.main(args + extra))    # the loop's log, in log.txt too
            torch.cuda.synchronize()
            counts.append(tuple(k.launches for k in kernels))
            synthesis.append(syn.k2)
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
    for (lo, hi), got, syn_k2 in zip(LOOP_RUNS, counts, synthesis):
        want = loop_launches(ADA_LAUNCHES_PER_STEP, range(lo, hi), syn_k2, 1)
        check(got == want, f"[13 loop] steps {lo}-{hi - 1} launched {KERNELS} {got} times, "
                           f"expected {want} (R1 at every 16th step index; K2 also 12 a "
                           f"snapshot grid's synthesis)")
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
          f"in memory and to its restore on the card ({n_saved} tensors); launches {KERNELS} "
          f"per run {counts[0]} and {counts[1]}; (cudnn, matmul) allow_tf32 in D "
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

    t_phase = time.perf_counter()
    i3d, inception, c3d = phase_detectors(dev, models)
    fns = {"i3d": (det.i3d_features_fn, i3d), "inception": (det.inception_features_fn, inception),
           "c3d_ucf101": (det.c3d_features_fn, c3d)}
    for name, (fn, model) in fns.items():
        metric_utils.register_detector(name, lambda fn=fn, model=model, **kw: fn(model, **kw),
                                       cache_tag=f"chip-smoke-random-{name}-s14")
    kernels = _kernels()
    for k in kernels:
        k.launches = 0
    syn = SynthesisCalls().__enter__()      # (b)-(e): the synthesis K2 accounts for
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
    syn.__exit__()
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

    # (g) the metric path launches K2 in G's synthesis only, none of the other kernels
    want = (0, 0, 0, 0, syn.k2)
    check(launches == want and syn.backwards == 0,
          f"[14 metrics] {KERNELS} launched {launches} times on the metric path, expected "
          f"{want} (K2: 12 a synthesis, {syn.forwards} synthesis calls)")
    print(f"[14 metrics] (g) {KERNELS} launches during (b)-(e): {launches}, K2 12 for each "
          f"of {syn.forwards} synthesis calls", flush=True)

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


PAR_RANKS = 2                  # phase 15: two ranks on cuda:0 over gloo
# Step 1's gradients, two ranks against one process: with deterministic
# kernels the one-process step repeats itself, but with G's and D's weights
# scaled by (1 + 1e-7 N(0, 1)) its gradients move by a few percent of their L2
# norm (bf16 layers and leaky-ReLU kinks), and the two ranks' by as much. So
# the two ranks' gradients must lie within PAR_FLOOR_FACTOR times that floor,
# measured in the same run; a wrong row, draw or reduction moves them by
# their whole norm.
PAR_FLOOR_FACTOR = 3.0


def _par_step(dev, world, zero1=False):
    """Phase 11's FFS-256 ADA step (bgc, warp_upsample=2, augment_p 0.5, TF32
    off) on fresh seeded weights, as one rank of `world`."""
    from stylegan_v_tpu_torch.training import (AUGPIPE_SPECS, AugmentConfig, LossConfig,
                                               OptimizerConfig, TrainingConfig,
                                               init_train_state, make_augment_pipe,
                                               make_train_step)
    G, D = ffs256_models(dev)
    B, F, res = TRAIN_SHAPE
    tcfg = TrainingConfig(batch_size=B, ada_target=0.6, zero1=zero1)
    lcfg = LossConfig(r1_gamma=0.0002 * res ** 2 / B, pl_weight=0.0, video_consistent_aug=True)
    opt = OptimizerConfig(0.0025)
    aug = make_augment_pipe(AugmentConfig(**AUGPIPE_SPECS["bgc"], warp_upsample=2))
    state = init_train_state(G, D, opt, opt, tcfg, augment_p=ADA_P, world=world)
    return state, make_train_step(G, D, lcfg, tcfg, augment_fn=aug, world=world)


def _par_batch(dev):
    """Phase 11's global batch of 16 videos x 3 frames at 256^2, seeded."""
    import torch
    B, F, res = TRAIN_SHAPE
    g = torch.Generator(device=dev).manual_seed(4)
    t = torch.randint(0, 128, (B, F), generator=g, device=dev).float().sort(dim=1).values
    t = t + torch.arange(F, device=dev) * 0.1
    return {"real_img": torch.randint(0, 255, (B, F, 3, res, res), generator=g, device=dev,
                                      dtype=torch.uint8),
            "real_c": torch.zeros(B, 0, device=dev), "real_t": t,
            "gen_c": torch.zeros(B, 3, 0, device=dev),
            "gen_t": torch.stack([t, t + 1, t + 2], dim=1)}


PAR_PLAN = (True, False, False, True)    # R1 first; steps 3 and 4 timed warm
# phase 19's: R1 first, whose step runs every phase; then step 2 (without R1),
# timed after a step that ran its work
MOCO_PAR_PLAN = (True, False)
PAR_SEEDS = (11, 12, 13, 14)             # each step's draws: a generator seeded alike everywhere


def grad_errors(got, want):
    """Per network: the largest absolute difference, the reference's largest
    magnitude (its scale) and the difference's L2 norm over the reference's."""
    import torch
    out = {}
    for name in ("G", "D"):
        diff = torch.cat([(a - b).reshape(-1) for a, b in zip(got[name], want[name])])
        ref = torch.cat([b.reshape(-1) for b in want[name]])
        out[name] = (float(diff.abs().max()), float(ref.abs().max()),
                     float(diff.norm() / ref.norm()))
    return out


class deterministic:
    """cuDNN's deterministic algorithms and PyTorch's deterministic kernels
    (warn only where an op has none), restored on exit."""

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cudnn.deterministic,
                      torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled())
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        import torch
        torch.backends.cudnn.deterministic = self.saved[0]
        torch.use_deterministic_algorithms(self.saved[1], warn_only=self.saved[2])


def _capture_grads(state):
    """Records each network's gradients at its optimizer's first step: Gmain's
    and Dmain's (the step's first G and D updates)."""
    grads = {}
    for name, opt, module in (("G", state.opt_G, state.G), ("D", state.opt_D, state.D)):
        def first(*a, _opt_step=opt.step, _name=name, _module=module, **k):
            if _name not in grads:
                grads[_name] = [p.grad.detach().float().cpu().clone()
                                for p in _module.parameters()]
            return _opt_step(*a, **k)
        opt.step = first
    return grads


def _par_reference_step(dev, perturb: bool = False):
    """Step 1 in one process on the global batch (deterministic kernels):
    Gmain's and Dmain's gradients and the stats; with `perturb`, from G's and
    D's weights scaled by (1 + 1e-7 N(0, 1))."""
    import torch
    state, step = _par_step(dev, None)
    if perturb:
        g = torch.Generator(device=dev).manual_seed(99)
        with torch.no_grad():
            for p in list(state.G.parameters()) + list(state.D.parameters()):
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g, device=dev))
    grads = _capture_grads(state)
    with deterministic():
        _, stats = step(state, _par_batch(dev),
                        generator=torch.Generator(device=dev).manual_seed(PAR_SEEDS[0]),
                        do_dr1=PAR_PLAN[0])
    return grads, {k: float(v) for k, v in stats.items()}


def par_reference(dev, tmp):
    """Phase 15 (a)'s yardstick: the one-process step on the global batch,
    step 1's Gmain and Dmain gradients and stats, saved for the ranks, and
    the noise floor of those gradients (module constant PAR_FLOOR_FACTOR)."""
    import os
    import torch
    grads, stats = _par_reference_step(dev)
    floor = grad_errors(_par_reference_step(dev, perturb=True)[0], grads)
    torch.save({"G": grads["G"], "D": grads["D"], "stats": stats},
               os.path.join(tmp, "par_reference.pt"))
    return floor, stats


def par_rank(rank, world_size, init_method, tmp, device):
    """Phase 15 (a)-(c) on one rank (spawned): the two-rank step against the
    one-process gradients, launches per step, timings, the consistency
    check, then ZeRO-1 on the same steps. Writes its findings as JSON."""
    import json as _json
    import os
    import torch
    import torch.distributed as dist
    from stylegan_v_tpu_torch.parallel import distributed as tdist
    from stylegan_v_tpu_torch.parallel.zero import opt_state_bytes_per_device
    from stylegan_v_tpu_torch.utils.summary import (check_replica_consistency,
                                                    train_state_tree, tree_content_hash)

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")   # cuBLAS repeats too
    dev = torch.device(device)
    world = tdist.init_distributed("gloo", rank, world_size, init_method, dev, timeout_s=300)
    # deterministic kernels: ZeRO-1's run repeats (a)'s to the bit
    det = deterministic()
    det.__enter__()
    try:
        kernels = _kernels()
        batch = _par_batch(dev)
        B = TRAIN_SHAPE[0]
        plan = None
        out = {"rank": rank}
        digests = {}
        for zero1 in (False, True):
            state, step = _par_step(dev, world, zero1)
            step1_stats = None
            if plan is None:
                plan = tdist.row_plan(B, 1, tdist.mbstd_group(state.D, B), world.size, world.rank)
                local = {k: v[torch.as_tensor(plan.batch, device=dev)]
                         for k, v in batch.items()}
            grads = _capture_grads(state)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            launches, ms = [], []
            # ZeRO-1 runs the first two steps, and is held to (a)'s state after them
            for i, (do_dr1, seed) in enumerate(zip(PAR_PLAN[:2] if zero1 else PAR_PLAN,
                                                   PAR_SEEDS)):
                for k in kernels:
                    k.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, stats = step(state, local, do_dr1=do_dr1,
                                    generator=torch.Generator(device=dev).manual_seed(seed))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                launches.append([k.launches for k in kernels])
                step1_stats = step1_stats or {k: float(v) for k, v in stats.items()}
                bad = [k for k, v in stats.items() if not bool(torch.isfinite(v).all())]
                check(not bad, f"[15 ranks] rank {rank}: non-finite stats {bad}")
                if i == 1:
                    digests[zero1] = tree_content_hash({"G": state.G.state_dict(),
                                                        "D": state.D.state_dict(),
                                                        "G_ema": state.G_ema.state_dict()})
            tag = "zero1" if zero1 else "plain"
            bad = [n for m in (state.G, state.D, state.G_ema)
                   for n, p in m.named_parameters() if not bool(torch.isfinite(p).all())]
            check(not bad, f"[15 ranks] rank {rank} ({tag}): non-finite parameters {bad[:5]}")
            check_replica_consistency(train_state_tree(state), world)
            p_all = [None] * world.size
            dist.all_gather_object(p_all, float(state.augment_p))
            out[tag] = {"ms": ms, "launches": launches, "augment_p": p_all,
                        "step1_stats": step1_stats,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "opt_bytes": opt_state_bytes_per_device(state),
                        "losses": {k: float(v) for k, v in stats.items()}}
            if not zero1:
                out["grad_err"] = grad_errors(
                    grads, torch.load(os.path.join(tmp, "par_reference.pt")))
                # the all-reduce of a step: each phase's flat gradient buffer
                flat = {n: [p.detach().clone() for p in m.parameters()]
                        for n, m in (("G", state.G), ("D", state.D))}
                ar = {}
                for n, ts in flat.items():
                    tdist.all_reduce_mean_(ts, world)        # warm
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(3):
                        tdist.all_reduce_mean_(ts, world)
                    torch.cuda.synchronize()
                    ar[n] = (time.perf_counter() - t0) / 3 * 1e3
                out["allreduce_ms"] = ar
                out["allreduce_bytes"] = {n: 4 * sum(t.numel() for t in ts)
                                          for n, ts in flat.items()}
            del state, step, grads
            torch.cuda.empty_cache()
        out["zero1_equal"] = digests[False] == digests[True]
        with open(os.path.join(tmp, f"par_rank{rank}.json"), "w") as f:
            _json.dump(out, f)
    finally:
        det.__exit__()
        tdist.destroy_distributed()


def phase_parallel(dev, smi, zip_path, tmp):
    """Phase 15 (below) and its time."""
    t_phase = time.perf_counter()
    par_steps(dev, smi, tmp)
    par_loop(dev, zip_path, tmp)
    par_nccl(dev, zip_path, tmp)
    print(f"[15 ranks] phase 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)


def par_steps(dev, smi, tmp):
    """Phase 15 (a)-(c) and their part of (f): two ranks sharing the card over
    gloo (nccl refuses two ranks on one device): (a) the FFS-256 ADA step at
    16 x 3 global, 8 videos a rank, four steps (R1 first and last) with
    deterministic kernels; step 1's all-reduced Gmain and Dmain gradients
    against the one-process step's within PAR_FLOOR_FACTOR times their noise
    floor, everything finite, augment_p equal on both ranks, the ranks'
    state consistent; (b) each rank's K1 / K1-bwd / K4 / K4-bwd / K2 launches per
    step against phase 11's; (c) ZeRO-1 on the first two steps, equal to
    (a)'s state after them to the bit; (f) the two-rank times (the ranks share one card: not a scaling
    number), the all-reduce's ms, peak memory per rank."""
    import json as _json
    import os
    import torch
    from stylegan_v_tpu_torch.parallel import distributed as tdist

    floor, ref_stats = par_reference(dev, tmp)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tdist.launch(par_rank, PAR_RANKS, args=(tmp, str(dev)))
    t_ranks = time.perf_counter() - t0
    ranks = [_json.load(open(os.path.join(tmp, f"par_rank{r}.json"))) for r in range(PAR_RANKS)]
    for r in ranks:
        for name, (err, scale, l2) in r["grad_err"].items():
            check(l2 <= PAR_FLOOR_FACTOR * floor[name][2],
                  f"[15 ranks] rank {r['rank']}: step 1's {name} gradient differs from the "
                  f"one-process step by {l2:.3g} of its L2 norm > {PAR_FLOOR_FACTOR} x the "
                  f"floor {floor[name][2]:.3g} (largest element {err:.3g}, scale {scale:.3g})")
        for tag in ("plain", "zero1"):
            p = r[tag]["augment_p"]
            check(len(set(p)) == 1, f"[15 ranks] augment_p differs across ranks: {p}")
            for do_dr1, got in zip(PAR_PLAN, r[tag]["launches"]):
                check(tuple(got) == ADA_LAUNCHES_PER_STEP[do_dr1],
                      f"[15 ranks] rank {r['rank']} ({tag}) launched K1, K1-bwd, K4, K4-bwd, K2 "
                      f"{got} in a step with R1={do_dr1}, expected "
                      f"{ADA_LAUNCHES_PER_STEP[do_dr1]}")
        check(r["zero1_equal"], f"[15 ranks] rank {r['rank']}: ZeRO-1's parameters differ "
                                "from plain Adam's")
    r0 = ranks[0]
    print(f"[15 ranks] (a) two ranks on {dev} over gloo, FFS-256 ADA step 16x3 global (8 "
          f"videos a rank): step 1's Gmain / Dmain gradients against the one-process step: "
          + ", ".join(f"rank {r['rank']} " + ", ".join(
              f"{n} {l2:.3g} of its L2 norm, largest element {e:.3g} (scale {s:.3g})"
              for n, (e, s, l2) in r["grad_err"].items()) for r in ranks)
          + "; the floor (one process, weights x (1 + 1e-7 N)): " + ", ".join(
              f"{n} {l2:.3g} of its L2 norm, largest element {e:.3g}"
              for n, (e, s, l2) in floor.items())
          + f" (bound {PAR_FLOOR_FACTOR} x the floor); step 1's stats, largest difference "
          f"from the one-process step's: "
          + ", ".join(f"{k} {abs(v - ref_stats[k]):.3g}"
                      for k, v in r0['plain']['step1_stats'].items())
          + f"; augment_p {r0['plain']['augment_p']}; losses on rank 0 after the steps "
          f"{r0['plain']['losses']}; consistency check passed", flush=True)
    print(f"[15 ranks] (b) K1, K1-bwd, K4, K4-bwd, K2 launches per step on each rank (R1 "
          f"{list(PAR_PLAN)}): " + "; ".join(f"rank {r['rank']} {r['plain']['launches']}"
                                             for r in ranks), flush=True)
    print(f"[15 ranks] (c) ZeRO-1 after two steps equal to (a) after two to the bit; "
          f"optimizer state per rank "
          + ", ".join(f"rank {r['rank']} {r['zero1']['opt_bytes'] / 2**20:.1f} MiB (plain Adam "
                      f"{r['plain']['opt_bytes'] / 2**20:.1f} MiB)" for r in ranks), flush=True)
    for r in ranks:
        ms = r["plain"]["ms"]
        ar = r["allreduce_ms"]
        print(f"[15 ranks] (f) rank {r['rank']}: {ms[2]:.1f} ms/step without R1, {ms[3]:.1f} "
              f"with R1 (first steps {ms[0]:.1f}, {ms[1]:.1f}; ZeRO-1's two steps "
              f"{r['zero1']['ms'][0]:.1f}, {r['zero1']['ms'][1]:.1f}); two ranks share one "
              f"card, so this is not a "
              f"scaling number; all-reduce of the flat gradients {ar['G']:.2f} ms for G "
              f"({r['allreduce_bytes']['G'] / 2**20:.1f} MiB), {ar['D']:.2f} ms for D "
              f"({r['allreduce_bytes']['D'] / 2**20:.1f} MiB): "
              f"{ar['G'] + ar['D']:.2f} ms a step without R1, {ar['G'] + 2 * ar['D']:.2f} "
              f"with; peak {r['plain']['peak_gib']:.2f} GiB (ZeRO-1 "
              f"{r['zero1']['peak_gib']:.2f}); on {smi}", flush=True)
    print(f"[15 ranks] (a)-(c) took {t_ranks:.1f} s with the spawn", flush=True)


def par_loop(dev, zip_path, tmp):
    """Phase 15 (d): the loop through the entry point's spawn path, two ranks
    on `dev` over gloo, on phase 13's zip: resumed from phase 13's last
    snapshot (2016 frames, past the run's 1 kimg), one step and a snapshot,
    then resume=latest: a step, a snapshot and fvd2048_16f over two replicas
    (the stub detector: the ranks are fresh processes), only rank 0
    writing."""
    import contextlib
    import io
    import json as _json
    import math
    import os
    from stylegan_v_tpu_torch import train as entry

    run = os.path.join(tmp, "run_ranks")
    cache = os.path.join(tmp, "cache_ranks")
    real, gen = METRIC_ITEMS
    start = os.path.join(tmp, "run", "network-snapshot-000002.pt")    # phase 13's last
    base = [f"dataset.path={zip_path}", "num_gpus=2", "training.batch_size=16",
            "training.kimg=1", "training.kimg_per_tick=0.5", "training.snap=2",
            f"project_release_dir={run}"]
    options = ["--device", str(dev), "--dist-backend", "gloo"]
    runs = ([f"training.resume={start}", "training.metrics=[]"],
            ["training.resume=latest", "training.metrics=[fvd2048_16f]",
             f"training.metric_kwargs.max_real_override={real}",
             f"training.metric_kwargs.num_gen_override={gen}",
             f"training.metric_kwargs.cache_dir={cache}"])
    t0 = time.perf_counter()
    os.environ["SGV_STUB_DETECTORS"] = "1"          # the spawned ranks' I3D: the stub
    # the ranks write their log to log.txt; their stdout (inherited) goes to a file
    sys.stdout.flush()
    t_runs = []
    saved = os.dup(1)
    try:
        with open(os.path.join(tmp, "ranks_stdout.txt"), "w") as f:
            os.dup2(f.fileno(), 1)
            for extra in runs:
                out = io.StringIO()
                t_run = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    entry.main(base + extra + options)
                t_runs.append(time.perf_counter() - t_run)
    finally:
        os.dup2(saved, 1)
        os.close(saved)
        del os.environ["SGV_STUB_DETECTORS"]
    t_loop = time.perf_counter() - t0
    log = open(os.path.join(run, "log.txt")).read()
    rows = [_json.loads(line) for line in open(os.path.join(run, "metric-fvd2048_16f.jsonl"))]
    stats_rows = [line for line in open(os.path.join(run, "stats.jsonl"))]
    snaps = sorted(n for n in os.listdir(run) if n.endswith(".pt"))
    ticks = [line for line in log.splitlines() if line.startswith("tick ")]
    meta = _json.load(open(os.path.join(run, "network-snapshot-000002.meta.json")))
    check(snaps == ["network-snapshot-000002.pt"] and meta["cur_nimg"] == 2016 + 2 * 48
          and f"Resuming from {start}" in log
          and f"Resuming from {os.path.join(run, snaps[0])}" in log
          and len(rows) == 1 and math.isfinite(rows[0]["results"]["fvd2048_16f"])
          and len(stats_rows) == len(ticks) == 2,
          f"[15 ranks] the two-rank loop: snapshots {snaps} at {meta['cur_nimg']}, metric "
          f"rows {rows}, {len(stats_rows)} stats rows for {len(ticks)} ticks")
    print(f"[15 ranks] (d) `python -m stylegan_v_tpu_torch.train num_gpus=2 --device {dev} "
          f"--dist-backend gloo` on phase 13's zip: resumed from phase 13's snapshot 000002, "
          f"a step and a snapshot, then resume=latest: a step, a snapshot and fvd2048_16f "
          f"over two replicas "
          f"({real} / {gen}, stub I3D) {rows[0]['results']['fvd2048_16f']:.4f}; one stats row "
          f"a tick ({len(stats_rows)}), rank 0 alone writing; in {t_loop:.1f} s (the runs "
          f"{t_runs[0]:.1f} and {t_runs[1]:.1f} s, with their spawns); the log's ticks: "
          f"{[' '.join(t.split()[:8]) for t in ticks]}", flush=True)


def par_nccl(dev, zip_path, tmp):
    """Phase 15 (e): nccl at world size 1 through the entry point, under
    torchrun's environment, then an all_reduce on an nccl group."""
    import contextlib
    import io
    import os
    import torch
    import torch.distributed as dist
    from stylegan_v_tpu_torch import train as entry
    from stylegan_v_tpu_torch.parallel import distributed as tdist

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(tdist.free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            # kimg 0.048 is one step of 48 frames (the setup takes int(kimg))
            result = entry.main([f"dataset.path={zip_path}", "training.batch_size=16",
                                 "training.kimg=0.048", "training.metrics=[]",
                                 f"project_release_dir={os.path.join(tmp, 'run_nccl')}"])
        os.environ["MASTER_PORT"] = str(tdist.free_port())
        world = tdist.init_distributed("nccl", 0, 1, "env://", dev)
        try:
            x = torch.full((4,), 3.0, device=dev)
            dist.all_reduce(x)
            torch.cuda.synchronize()
            backend = dist.get_backend()
        finally:
            tdist.destroy_distributed()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(result["state"].step == 1 and world.backend == backend == "nccl"
          and bool((x == 3.0).all()), f"[15 ranks] nccl at world size 1: {backend}, {x}")
    print(f"[15 ranks] (e) nccl at world size 1 through the entry point (torchrun's "
          f"environment): one step, then an all_reduce on the nccl group, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------- phase 16

LEGACY_CLIPS = 16                # (c): the timed generate, 16 clips of 16 frames at 256^2
LEGACY_SHARDS = (2, 16)          # (d): videos, frames over two ranks, two frame shards
# (d): the frame shards against one call of every frame may differ by this many
# times the two one-process runs' difference (in the ranks' blocks, in one call)
LEGACY_BATCH_FACTOR = 2
SMOKE_FVD = "fvd2048_16f_smoke"  # (e): fvd2048_16f at phase 14's counts (METRIC_ITEMS)
# (a): a TF-era StyleGAN2 pickle at FFS-256's widths (channel_base 16384 = 2 x fmap_base)
LEGACY_TF = dict(resolution=256, latent=512, fmap_base=8192, fmap_max=512, mapping_layers=8)


def legacy_modules(run):
    """FFS-256 G, G_ema and D on the CPU with the configs of phase 13's run
    (its first snapshot's meta), seeded, G_ema's w_avg nonzero."""
    import os
    import torch
    from stylegan_v_tpu_torch.io.checkpoint import meta_decode
    from stylegan_v_tpu_torch.models import Discriminator, Generator
    meta = json.load(open(os.path.join(run, "network-snapshot-000000.meta.json")))
    gcfg, dcfg = (meta_decode(meta["configs"][k]) for k in ("G", "D"))
    gen = torch.Generator().manual_seed(16)
    G, D, G_ema = (Generator(gcfg, generator=gen), Discriminator(dcfg, generator=gen),
                   Generator(gcfg, generator=gen))
    with torch.no_grad():
        G_ema.mapping.w_avg.normal_(generator=gen)
    return {"G": G.eval(), "G_ema": G_ema.eval(), "D": D.eval()}


def _equal_states(got, want, where):
    import torch
    check(set(got) == set(want), f"{where}: keys differ {sorted(set(got) ^ set(want))[:5]}")
    for k, v in want.items():
        check(torch.equal(got[k].cpu(), v.cpu()), f"{where}: {k} differs")


def legacy_load(dev, tmp, pkl, src):
    """Phase 16 (a): the reference .pkl and a TF-era pickle at FFS-256 widths,
    loaded on the card."""
    import os
    import numpy as np
    import torch
    from stylegan_v_tpu_torch import generate
    from stylegan_v_tpu_torch.io import legacy, legacy_tf
    from stylegan_v_tpu_torch.models import Discriminator, Generator, GeneratorConfig
    from stylegan_v_tpu_torch.models.config import replace
    from stylegan_v_tpu_torch.tools.ref_pickle import write_tf_pickle

    t0 = time.perf_counter()
    imported = legacy.import_reference_snapshot(pkl)
    G = generate.load_any_checkpoint(pkl, dev)           # the CLIs' load: G_ema, strict
    D = Discriminator(src["D"].cfg).to(dev).eval()
    legacy.load_port_state(D, imported["D"], require_all=True)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    for key in ("G", "G_ema", "D"):
        _equal_states(imported[key], src[key].state_dict(), f"[16 legacy] imported {key}")
    _equal_states(G.state_dict(), src["G_ema"].state_dict(), "[16 legacy] G_ema on the card")
    _equal_states(D.state_dict(), src["D"].state_dict(), "[16 legacy] D on the card")
    g = torch.Generator(device=dev).manual_seed(16)
    z = torch.randn(2, G.cfg.z_dim, generator=g, device=dev)
    t = torch.tensor([[0.0, 5.0, 11.0], [3.0, 40.0, 90.0]], device=dev)
    mz = G.synthesis.motion_encoder.sample_motion_z(2, g)
    source_G = copy.deepcopy(src["G_ema"]).to(dev)
    source_D = copy.deepcopy(src["D"]).to(dev)
    with deterministic(), torch.no_grad():
        frames = [m(z, None, t, motion_z=mz, noise_mode="const") for m in (source_G, G)]
        logits = [m(frames[0], None, t)["image_logits"] for m in (source_D, D)]
    check(bool(torch.isfinite(frames[1]).all()) and torch.equal(*frames)
          and torch.equal(*logits), "[16 legacy] frames or logits of the loaded G_ema and D "
                                    "differ from the source modules'")
    del source_G, source_D, G, D

    # a TF-era pickle at FFS-256's widths, into a video G whose motion encoder stays fresh
    t0 = time.perf_counter()
    tf_path = write_tf_pickle(os.path.join(tmp, "tf-snapshot.pkl"), np.random.RandomState(16),
                              **LEGACY_TF)
    t_write = time.perf_counter() - t0
    tf = LEGACY_TF
    cfg = replace(GeneratorConfig(), img_resolution=tf["resolution"], w_dim=tf["latent"],
                  z_dim=tf["latent"], channel_base=2 * tf["fmap_base"],
                  channel_max=tf["fmap_max"], mapping_layers=tf["mapping_layers"],
                  use_noise=True, input_type="const", num_bf16_res=0)
    G_tf = Generator(cfg, generator=torch.Generator().manual_seed(17)).to(dev).eval()
    fresh = {k: v.clone() for k, v in G_tf.state_dict().items()}
    t0 = time.perf_counter()
    legacy.import_reference_snapshot(tf_path, G_ema=G_tf)
    torch.cuda.synchronize()
    t_tf = time.perf_counter() - t0
    stub = legacy.load_network_pkl(tf_path)["G_ema"]
    want = legacy.port_state(legacy_tf.tf_to_torch_generator_state(
        legacy_tf.collect_tf_params(stub)))
    got = G_tf.state_dict()
    check(set(want) <= set(got), f"[16 legacy] TF names the port lacks: "
                                 f"{sorted(set(want) - set(got))[:5]}")
    _equal_states({k: got[k] for k in want}, want, "[16 legacy] TF G_ema")
    _equal_states({k: got[k] for k in fresh if k not in want},
                  {k: v for k, v in fresh.items() if k not in want}, "[16 legacy] TF fresh part")
    zt = torch.randn(1, cfg.z_dim, generator=g, device=dev)
    tt = torch.tensor([[0.0, 7.0]], device=dev)
    mzt = G_tf.synthesis.motion_encoder.sample_motion_z(1, g)
    with torch.no_grad():
        card = G_tf(zt, None, tt, motion_z=mzt, noise_mode="const")
        cpu = copy.deepcopy(G_tf).cpu()(zt.cpu(), None, tt.cpu(), motion_z=mzt.cpu(),
                                        noise_mode="const")
    scale = float(cpu.abs().max())
    err = float((card.cpu() - cpu).abs().max())
    check(bool(torch.isfinite(card).all()) and err <= PARITY_TOL * scale,
          f"[16 legacy] TF G_ema card vs CPU: max abs err {err:.3g}, scale {scale:.3g}")
    print(f"[16 legacy] (a) reference .pkl ({os.path.getsize(pkl) / 2**20:.1f} MiB: FFS-256 G, "
          f"G_ema, D, augment_pipe None) imported and loaded on the card in {t_load:.2f} s: "
          f"the three state_dicts equal the source's to the bit, G_ema's frames "
          f"{list(frames[1].shape)} and D's logits equal the source modules' on the card to "
          f"the bit; TF-era "
          f"pickle at FFS-256's widths ({os.path.getsize(tf_path) / 2**20:.1f} MiB, written in "
          f"{t_write:.2f} s) into a video G in {t_tf:.2f} s: {len(want)} tensors equal the "
          f"renamed TF variables to the bit, {len(fresh) - len(want)} (the motion encoder) "
          f"fresh; its frames card vs CPU max abs err {err:.3g} (scale {scale:.3g}, tol "
          f"{PARITY_TOL} x scale)", flush=True)
    del G_tf


def legacy_resume(dev, smi, zip_path, tmp, pkl, src):
    """Phase 16 (b): the loop resumed from the .pkl through the entry point
    (21 steps of phase 11's ADA step, launches per step), then one tick under
    torchrun on nccl."""
    import contextlib
    import io
    import os
    import torch
    from stylegan_v_tpu_torch import train as entry
    from stylegan_v_tpu_torch.parallel.distributed import free_port
    from stylegan_v_tpu_torch.training import loop as tloop

    kernels = _kernels()
    start, steps = {}, []
    make = tloop.make_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(state, batch, **kw):
            if not start:
                start.update({n: {k2: v.detach().cpu().clone() for k2, v in
                                  getattr(state, n).state_dict().items()}
                              for n in ("G", "G_ema", "D")})
                start.update(step=state.step, cur_nimg=state.cur_nimg,
                             adam=len(state.opt_G.state) + len(state.opt_D.state))
            before = [k.launches for k in kernels]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch, **kw)
            torch.cuda.synchronize()
            steps.append((kw.get("do_dr1", False), tuple(k.launches - b for k, b in
                                                         zip(kernels, before)),
                          (time.perf_counter() - t0) * 1e3))
            return out
        return run

    run_dir = os.path.join(tmp, "run_pkl")
    args = [f"dataset.path={zip_path}", "training.batch_size=16", "training.kimg=1",
            "training.kimg_per_tick=0.25", "training.snap=100", "training.metrics=[]",
            f"project_release_dir={run_dir}", "--resume", pkl]
    t0 = time.perf_counter()
    tloop.make_train_step = recording
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            result = entry.main(args)
    finally:
        tloop.make_train_step = make
    t_run = time.perf_counter() - t0
    for key in ("G", "G_ema", "D"):
        _equal_states(start[key], src[key].state_dict(), f"[16 legacy] step 0's {key}")
    check((start["step"], start["cur_nimg"], start["adam"]) == (0, 0, 0)
          and (result["start_step"], result["start_nimg"]) == (0, 0)
          and result["cur_nimg"] == 1008 and len(steps) == 21,
          f"[16 legacy] the resumed run: start {start['step']}, {start['cur_nimg']}, "
          f"{start['adam']} Adam states; ended at {result['cur_nimg']} after {len(steps)} steps")
    for i, (do_dr1, got, _) in enumerate(steps):
        check(got == ADA_LAUNCHES_PER_STEP[do_dr1] and do_dr1 == (i % 16 == 0),
              f"[16 legacy] step {i} (R1 {do_dr1}) launched K1, K1-bwd, K4, K4-bwd, K2 {got}, "
              f"expected {ADA_LAUNCHES_PER_STEP[do_dr1]}")
    check("Importing reference snapshot" in open(os.path.join(run_dir, "log.txt")).read(),
          "[16 legacy] the log does not say it imported the .pkl")
    ms = [m for r1, _, m in steps[2:] if not r1]
    ms_r1 = [m for r1, _, m in steps if r1]
    del result
    torch.cuda.empty_cache()

    # the same resume under torchrun, one process on nccl, for one tick
    run_tr = os.path.join(tmp, "run_pkl_torchrun")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes=1", "--nproc_per_node=1",
         "--master_addr=localhost", f"--master_port={free_port()}", "-m",
         "stylegan_v_tpu_torch.train", f"dataset.path={zip_path}", "training.batch_size=16",
         "training.kimg=0.048", "training.metrics=[]", f"project_release_dir={run_tr}",
         "--resume", pkl], env=env, capture_output=True, text=True, timeout=300)
    t_torchrun = time.perf_counter() - t0
    log = open(os.path.join(run_tr, "log.txt")).read() if proc.returncode == 0 else ""
    rows = open(os.path.join(run_tr, "stats.jsonl")).readlines() if log else []
    check(proc.returncode == 0 and "Importing reference snapshot" in log and len(rows) == 1
          and os.path.exists(os.path.join(run_tr, "network-snapshot-000000.pt")),
          f"[16 legacy] torchrun: rc {proc.returncode}, {len(rows)} stats rows; "
          f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    print(f"[16 legacy] (b) `python -m stylegan_v_tpu_torch.train ... --resume <the .pkl>` on "
          f"phase 13's zip, in process: step 0's G, G_ema and D equal the .pkl's to the bit, "
          f"step 0 / cur_nimg 0 / no Adam state; 21 ADA steps at 16x3 (R1 at 0 and 16) with "
          f"K1, K1-bwd, K4, K4-bwd, K2 launches per step as phase 11's; "
          f"{sum(ms) / len(ms):.1f} ms/step without R1 (mean of {len(ms)} synchronised steps "
          f"after the first two), {', '.join(f'{m:.1f}' for m in ms_r1)} ms with R1; the run "
          f"{t_run:.1f} s with its setup and a snapshot. `python -m torch.distributed.run "
          f"--nproc_per_node 1 -m stylegan_v_tpu_torch.train ... --resume <the .pkl>` on nccl: "
          f"one step, one tick, a snapshot, in {t_torchrun:.1f} s; on {smi}", flush=True)


def legacy_generate(dev, smi, tmp, pkl):
    """Phase 16 (c): `python -m stylegan_v_tpu_torch.generate` in process on the
    .pkl, on phase 14's run dir by its metric jsonl, and with
    --moco-decomposition, each against generate_videos on the card."""
    import contextlib
    import io
    import os
    import numpy as np
    import torch
    from stylegan_v_tpu_torch import generate
    from stylegan_v_tpu_torch.training.video_io import generate_videos
    from stylegan_v_tpu_torch.utils.misc import float32_precision

    def cli(argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), deterministic():
            videos = generate.main(argv + ["--device", str(dev)])
        return videos, time.perf_counter() - t0, out.getvalue()

    def in_process(argv, path, timed=False):
        """generate_videos on the CLI's draws, with deterministic kernels as the
        CLI ran; `timed`: then twice more as a user runs it, the second timed."""
        with contextlib.redirect_stdout(io.StringIO()):
            G = generate.load_any_checkpoint(path, dev)
        args = generate.parse_args(argv)
        z, c, ts, mz = generate.draw_inputs(args, G.cfg)

        def synthesise():
            with float32_precision(False):
                return generate_videos(G, z, c, ts, motion_z=mz, noise_mode=args.noise_mode,
                                       truncation_psi=args.truncation_psi,
                                       batch_size_num_frames=args.batch_size_num_frames,
                                       seed=args.seed)
        with deterministic():
            videos = synthesise()
        if not timed:
            return videos, None
        synthesise()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synthesise()
        torch.cuda.synchronize()
        return videos, time.perf_counter() - t0

    msgs = []
    out_pkl = os.path.join(tmp, "gen_pkl")
    argv = ["--network", pkl, "-o", out_pkl, "--num-videos", str(LEGACY_CLIPS),
            "--video-len", "16", "--save-as-frames"]
    got, t_cli, _ = cli(argv)
    want, t_syn = in_process(argv, pkl, timed=True)
    res = LOOP_DATA[2]
    check(got.shape == (LEGACY_CLIPS, 16, res, res, 3) and np.array_equal(got, want)
          and len(os.listdir(out_pkl)) == LEGACY_CLIPS
          and len(os.listdir(os.path.join(out_pkl, "video0000"))) == 16,
          "[16 legacy] generate on the .pkl: the frames differ from generate_videos'")
    msgs.append(f"on the .pkl, {LEGACY_CLIPS} clips x 16 frames as frame folders: equal to "
                f"generate_videos to the bit; {LEGACY_CLIPS / t_syn:.2f} clips/s of synthesis "
                f"(generate_videos warm, {t_syn:.3f} s on the host clock, synchronised; "
                f"{LEGACY_CLIPS * -(-16 // -(-16 // max(1, 100 // LEGACY_CLIPS)))}-frame calls"
                f"), the CLI {t_cli:.2f} s "
                f"with the load, deterministic "
                f"kernels and {LEGACY_CLIPS * 16} JPEGs")

    run = os.path.join(tmp, "run_metrics")            # phase 14 (f): snapshots and jsonl
    rows = [json.loads(line) for line in open(os.path.join(run, "metric-fvd2048_16f.jsonl"))]
    best = min(rows, key=lambda r: r["results"]["fvd2048_16f"])["snapshot"]
    path = os.path.join(run, best + ".pt")
    argv = ["--networks-dir", run, "-o", os.path.join(tmp, "gen_best"), "--num-videos", "4",
            "--video-len", "16"]
    got, _, printed = cli(argv)
    want, _ = in_process(argv, path)
    check(f"Loading {path}" in printed and np.array_equal(got, want),
          f"[16 legacy] generate --networks-dir picked {printed.splitlines()[:1]}, expected "
          f"{best} by its FVD")
    msgs.append(f"--networks-dir on phase 14's run picks {best} (FVD "
                f"{[r['results']['fvd2048_16f'] for r in rows]}), frames equal to the bit")

    argv = ["--network", pkl, "-o", os.path.join(tmp, "gen_moco"), "--num-videos", "4",
            "--video-len", "16", "--moco-decomposition"]
    got, _, _ = cli(argv)
    want, _ = in_process(argv, pkl)
    check(np.array_equal(got, want) and os.path.exists(os.path.join(tmp, "gen_moco",
                                                                    "grid.mp4")),
          "[16 legacy] generate --moco-decomposition differs from generate_videos")
    msgs.append("--moco-decomposition 2x2 grid.mp4, frames equal to the bit")
    print(f"[16 legacy] (c) `python -m stylegan_v_tpu_torch.generate`: " + "; ".join(msgs)
          + f"; on {smi}", flush=True)
    return LEGACY_CLIPS / t_syn


RANK_LAUNCHES = "SMOKE_RANK_LAUNCHES"   # (d): where each spawned rank writes its launches


def _write_rank_launches(syn):
    """At a spawned rank's exit: its K1, K1-bwd, K4, K4-bwd and K2 launches and
    the K2 that its synthesis accounts for (SynthesisCalls syn, entered when
    the rank imported this script), to a file of its own in
    $SMOKE_RANK_LAUNCHES."""
    import os
    syn.__exit__()
    with open(os.path.join(os.environ[RANK_LAUNCHES], f"{os.getpid()}.json"), "w") as f:
        json.dump([[k.launches for k in _kernels()], syn.k2], f)


if __name__ == "__mp_main__":          # a spawned rank imports this script under that name
    import os as _os
    if _os.environ.get(RANK_LAUNCHES):
        import atexit
        atexit.register(_write_rank_launches, SynthesisCalls().__enter__())


def read_frame_folders(out, V, T):
    """The frame folders a generate run wrote, decoded: uint8 [V, T, H, W, 3]."""
    import os
    import numpy as np
    import PIL.Image
    return np.stack([np.stack([np.asarray(PIL.Image.open(
        os.path.join(out, f"video{v:04d}", f"{t:06d}.jpg")).convert("RGB")) for t in range(T)])
        for v in range(V)])


def legacy_shards(dev, tmp, pkl):
    """Phase 16 (d): `generate --frame-shards 2 --device cuda:0` as a user runs
    it: main spawns its two ranks, both on the card over gloo, and rank 0
    writes the frame folders. They are held against the one-process synthesis
    of the same draws, written by the same JPEG writer and read back, in
    uint8. FFS-256 computes its top four resolutions in bf16, where cuDNN's
    kernels, and so the rounding, depend on the batch: the one-process run
    that must agree to a level is generate_videos in calls of the ranks'
    blocks (V x T/2 frames); against one call of all the frames the
    difference must stay within LEGACY_BATCH_FACTOR times that of the two
    one-process runs, the floor set by the batch alone. Each rank writes its
    kernel launches at exit (_write_rank_launches); the gather's time is rank
    0's log line."""
    import contextlib
    import io
    import os
    import re
    import numpy as np
    from stylegan_v_tpu_torch import generate
    from stylegan_v_tpu_torch.training.video_io import (generate_videos,
                                                        save_video_frames_as_frames_parallel)
    from stylegan_v_tpu_torch.utils.misc import float32_precision

    V, T = LEGACY_SHARDS
    out = os.path.join(tmp, "gen_shards")
    argv = ["--network", pkl, "-o", out, "--num-videos", str(V), "--video-len", str(T),
            "--frame-shards", "2", "--save-as-frames",
            "--device", f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu"]
    launches_dir = os.path.join(tmp, "shard_launches")
    os.makedirs(launches_dir)
    log_path = os.path.join(tmp, "gen_shards.log")
    sys.stdout.flush()
    saved = os.dup(1)                  # the spawned ranks print to this process's fd 1
    os.environ[RANK_LAUNCHES] = launches_dir
    t0 = time.perf_counter()
    try:
        with open(log_path, "w") as log:
            os.dup2(log.fileno(), 1)
            returned = generate.main(argv)
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)
        del os.environ[RANK_LAUNCHES]
    t_cli = time.perf_counter() - t0
    printed = open(log_path).read()
    gather = re.findall(r"Gathered \d+ x \d+ frames from 2 ranks in ([0-9.]+) ms", printed)
    rank_launches = [json.load(open(os.path.join(launches_dir, f)))
                     for f in sorted(os.listdir(launches_dir))]
    check(returned is None and len(gather) == 1 and len(rank_launches) == 2
          and all(n == [0, 0, 0, 0, k2] and k2 > 0 for n, k2 in rank_launches),
          f"[16 legacy] generate --frame-shards 2: returned {type(returned)}, launches a rank "
          f"{rank_launches}, printed {printed[-2000:]!r}")
    got = read_frame_folders(out, V, T)

    with contextlib.redirect_stdout(io.StringIO()):
        G = generate.load_any_checkpoint(pkl, dev)
    args = generate.parse_args(argv)
    z, c, ts, mz = generate.draw_inputs(args, G.cfg)

    def one_process(frames_a_call):
        with float32_precision(False):
            videos = generate_videos(G, z, c, ts, motion_z=mz, noise_mode=args.noise_mode,
                                     truncation_psi=args.truncation_psi,
                                     batch_size_num_frames=frames_a_call, seed=args.seed)
        where = os.path.join(tmp, f"gen_one_{frames_a_call}")
        for v in range(V):
            save_video_frames_as_frames_parallel(videos[v], os.path.join(where,
                                                                         f"video{v:04d}"))
        return read_frame_folders(where, V, T).astype(np.int16)

    blocks, whole = one_process(V * T // 2), one_process(V * T)
    got = got.astype(np.int16)
    diff, diff_whole, floor = (np.abs(a - b) for a, b in
                               ((got, blocks), (got, whole), (blocks, whole)))
    res = LOOP_DATA[2]
    check(got.shape == blocks.shape == (V, T, res, res, 3) and diff.max() <= 1
          and diff_whole.max() <= max(1, LEGACY_BATCH_FACTOR * floor.max()),
          f"[16 legacy] --frame-shards 2: worst uint8 difference {diff.max()} from the "
          f"one-process run in the ranks' blocks, {diff_whole.max()} from it in one call "
          f"(the two one-process runs: {floor.max()})")
    print(f"[16 legacy] (d) `generate --frame-shards 2 --device {argv[-1]}`, its two ranks "
          f"spawned by the CLI on the card (gloo), {V} videos x {T} frames, each rank {V} x "
          f"{T // 2}; its JPEGs read back against the one-process synthesis of the same draws "
          f"through the same writer: in the ranks' blocks {int((diff > 0).sum())} of "
          f"{diff.size} uint8 values differ, worst by {int(diff.max())}; in one call of "
          f"{V * T} frames {int((diff_whole > 0).sum())} differ, worst by "
          f"{int(diff_whole.max())}, where the two one-process runs differ in "
          f"{int((floor > 0).sum())}, worst by {int(floor.max())} (bf16 at the top four "
          f"resolutions); K1, K1-bwd, K4, K4-bwd, K2 launches in each rank {rank_launches}; "
          f"rank 0's all_gather of the frames (float32 via the host) {gather[0]} ms; the CLI "
          f"{t_cli:.1f} s with the spawn", flush=True)


def register_smoke_metrics(dev, models):
    """Phase 14's random detectors under the reference's names, on the card, and
    SMOKE_FVD: fvd2048_16f at phase 14's counts (METRIC_ITEMS)."""
    from stylegan_v_tpu_torch.metrics import detectors as det
    from stylegan_v_tpu_torch.metrics import frechet_video_distance as fvd_lib
    from stylegan_v_tpu_torch.metrics import metric_main, metric_utils

    fns = {"i3d": det.i3d_features_fn, "inception": det.inception_features_fn,
           "c3d_ucf101": det.c3d_features_fn}
    for (name, fn), model in zip(fns.items(), models):
        model = copy.deepcopy(model).to(dev)
        metric_utils.register_detector(name, lambda fn=fn, model=model, **kw: fn(model, **kw),
                                       cache_tag=f"chip-smoke-random-{name}-s16")
    real, gen = METRIC_ITEMS
    if not metric_main.is_valid_metric(SMOKE_FVD):
        def fvd2048_16f_smoke(opts):
            return {SMOKE_FVD: fvd_lib.compute_fvd(opts, max_real=real, num_gen=gen,
                                                   num_frames=16)}
        metric_main.register_metric(fvd2048_16f_smoke)


def legacy_metrics(dev, zip_path, tmp, pkl, models):
    """Phase 16 (e): calc_metrics on the .pkl and on phase 13's last snapshot and
    calc_metrics_for_dataset on two frame datasets, against calc_metric in
    process on the same G, counts and detectors (phase 14's)."""
    import contextlib
    import io
    import math
    import os
    from stylegan_v_tpu_torch import calc_metrics, calc_metrics_for_dataset, generate
    from stylegan_v_tpu_torch.metrics import metric_main
    from stylegan_v_tpu_torch.models.config import SamplingConfig

    register_smoke_metrics(dev, models)
    real, gen = METRIC_ITEMS

    def row(run_dir):
        return json.loads(open(os.path.join(run_dir, f"metric-{SMOKE_FVD}.jsonl"))
                          .readlines()[-1])["results"][SMOKE_FVD]

    def agree(a, b):
        return math.isfinite(a) and abs(a - b) <= 1e-6 * max(abs(b), 1e-6)

    home = os.environ.get("HOME")
    os.environ["HOME"] = os.path.join(tmp, "home")          # the CLIs' stats cache
    msgs, t0 = [], time.perf_counter()
    try:
        for tag, network in (("pkl", pkl),
                             ("snapshot", os.path.join(tmp, "run", "network-snapshot-000002.pt"))):
            run_dir = os.path.join(tmp, f"cm_{tag}")
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                calc_metrics.main(["--network", network, "--data", zip_path, "--mirror",
                                   "--metrics", SMOKE_FVD, "--run-dir", run_dir,
                                   "--device", str(dev)])
            t_cli = time.perf_counter() - t1
            G = generate.load_any_checkpoint(network, dev)
            kw = dict(path=zip_path, sampling=G.cfg.sampling, xflip=True,
                      max_num_frames=G.cfg.sampling.max_num_frames,
                      resolution=G.cfg.img_resolution)
            want = metric_main.calc_metric(SMOKE_FVD, G=G, dataset_kwargs=kw,
                                           device=dev).results[SMOKE_FVD]
            got = row(run_dir)
            check(agree(got, want), f"[16 legacy] calc_metrics on the {tag}: {got!r}, "
                                    f"calc_metric {want!r}")
            msgs.append(f"calc_metrics on the {tag} {got!r} (calc_metric {want!r}, "
                        f"{t_cli:.2f} s)")
        t1 = time.perf_counter()
        other = write_ppm_zip(os.path.join(tmp, "other256.zip"), seed=1)
        t_other = time.perf_counter() - t1
        common = dict(sampling=SamplingConfig(max_num_frames=1024), max_num_frames=1024,
                      xflip=False, resolution=LOOP_DATA[2])
        values = []
        for tag, fake in (("same", zip_path), ("other", other)):
            run_dir = os.path.join(tmp, f"cmd_{tag}")
            with contextlib.redirect_stdout(io.StringIO()):
                calc_metrics_for_dataset.main(["--real-data", zip_path, "--fake-data", fake,
                                               "--metrics", SMOKE_FVD, "--run-dir", run_dir,
                                               "--resolution", str(LOOP_DATA[2]),
                                               "--device", str(dev)])
            want = metric_main.calc_metric(
                SMOKE_FVD, dataset_kwargs=dict(path=zip_path, **common),
                gen_dataset_kwargs=dict(path=fake, **common), generator_as_dataset=True,
                device=dev).results[SMOKE_FVD]
            got = row(run_dir)
            check(agree(got, want) or (tag == "same" and abs(got - want) <= 1e-6),
                  f"[16 legacy] calc_metrics_for_dataset ({tag}): {got!r}, calc_metric {want!r}")
            values.append(got)
        check(abs(values[0]) <= 1e-3 * values[1] and values[1] > 0,
              f"[16 legacy] dataset against itself {values[0]!r}, against another {values[1]!r}")
        msgs.append(f"calc_metrics_for_dataset phase 13's zip against itself {values[0]!r}, "
                    f"against a second zip (seed 1, written in {t_other:.1f} s) {values[1]!r}, "
                    f"each equal to calc_metric's")
    finally:
        if home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = home
    print(f"[16 legacy] (e) {SMOKE_FVD} ({real} real, {gen} generated clips, phase 14's random "
          f"detectors): " + "; ".join(msgs) + f"; in {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase_legacy(dev, smi, zip_path, tmp, models):
    """Phase 16: a reference .pkl written from seeded FFS-256 modules with
    phase 13's configs; (a) load, (b) resume, (c) generate, (d) frame shards,
    (e) metrics; no kernel launch in (c)-(e). Returns the .pkl's path and
    (c)'s clips/s of synthesis."""
    import os
    from stylegan_v_tpu_torch.tools.ref_pickle import write_reference_pickle

    t_phase = time.perf_counter()
    src = legacy_modules(os.path.join(tmp, "run"))
    pkl = write_reference_pickle(os.path.join(tmp, "network-snapshot-ffs256.pkl"),
                                 cur_nimg=123456, **src)
    parts = {}
    t0 = time.perf_counter()
    legacy_load(dev, tmp, pkl, src)
    parts["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    legacy_resume(dev, smi, zip_path, tmp, pkl, src)
    parts["b"] = time.perf_counter() - t0
    kernels = _kernels()
    for k in kernels:
        k.launches = 0
    returned = {}
    with SynthesisCalls() as syn:
        for tag, fn, args in (("c", legacy_generate, (dev, smi, tmp, pkl)),
                              ("d", legacy_shards, (dev, tmp, pkl)),
                              ("e", legacy_metrics, (dev, zip_path, tmp, pkl, models))):
            t0 = time.perf_counter()
            returned[tag] = fn(*args)
            parts[tag] = time.perf_counter() - t0
    launches = tuple(k.launches for k in kernels)
    want = (0, 0, 0, 0, syn.k2)
    check(launches == want and syn.backwards == 0,
          f"[16 legacy] {KERNELS} launched {launches} times in (c)-(e), expected {want} (K2: "
          f"12 for each of {syn.forwards} synthesis calls)")
    print(f"[16 legacy] {KERNELS} launches during (c)-(e) in this process (and in (d)'s "
          f"ranks, above, K2 alone, 12 a synthesis): "
          f"{launches}, K2 12 for each of {syn.forwards} synthesis calls; the parts took "
          + ", ".join(f"({k}) {v:.1f} s" for k, v in parts.items())
          + f"; phase 16 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return pkl, returned["c"]


# ---------------------------------------------------------------- phase 17
# The MoCoGAN slice: configs/experiments.yaml's mocogan_baseline/b16_mnf16 at
# 256^2 with clips of 16 consecutive frames, composed as the entry point
# composes it (stylegan_v_tpu_torch/tools/moco_memory.py: OVERRIDES, SHAPE).
MOCO_SHAPE = (16, 16, 256)       # videos, frames, resolution of a step
MOCO_BATCH_GPU = 8               # videos a round: the largest that fits 80 GB (PERF.md 4)
MOCO_ROUNDS = MOCO_SHAPE[0] // MOCO_BATCH_GPU
# Each round runs phase 11's D calls: the image D is the same resnet D (six K1
# skips a call; with one frame a "video" it fuses nothing), the pipe one K4 a
# call, and the video D launches no kernel. So per step: phase 11's counts
# times the rounds.
MOCO_LAUNCHES_PER_STEP = {r1: tuple(MOCO_ROUNDS * n for n in ADA_LAUNCHES_PER_STEP[r1])
                          for r1 in (False, True)}
MOCO_WARP_BATCH = (MOCO_BATCH_GPU, 3 * MOCO_SHAPE[1], MOCO_SHAPE[2])   # 48 fused channels
MOCO_LOOP_RUNS = ((0, 4), (4, 8))   # the loop's two runs: 1024 and 2048 frames at 256 a step
# (c): card vs CPU gradients within MOCO_FLOOR_FACTOR times the CPU's own
# gradient move, the largest of MOCO_FLOOR_SEEDS draws, when every weight moves
# by m of itself (weights x (1 + m N(0, 1))), with m for each draw the move at
# which the CPU's frames and logits move as far from the CPU's own as the
# card's differ from them (found from a move of MOCO_PROBE_MOVE, to which the
# outputs' move is proportional): the card's sums round otherwise, by that
# much, and each of the video D's leaky-ReLU kinks (after batch norms, whose
# outputs crowd zero) that flips moves a gradient element by ~1e-3 of scale.
MOCO_FLOOR_FACTOR, MOCO_PROBE_MOVE, MOCO_FLOOR_SEEDS = 3.0, 1e-6, 3
MOCO_CLIPS = 8                   # (e): generate, 8 clips of 16 frames


def moco_setup():
    """The slice's TrainSetup at MOCO_BATCH_GPU videos a round."""
    from stylegan_v_tpu_torch.tools import moco_memory
    return moco_memory.slice_setup(MOCO_BATCH_GPU)


def moco_step(dev, smi):
    """Phase 17 (a): five steps (R1, three without, R1) of the slice's step on
    seeded weights, at augment_p = 0.5; returns the launches of each kernel a
    step without and with R1 as measured, (ms without R1, ms with R1,
    amortised ms, frames/s, peak GiB), and the image D's skip inputs in the
    step, ((N, C, H, W), dtype name) in block order (phase_kernel's shapes)."""
    import torch
    from stylegan_v_tpu_torch.models import MoCoGANDiscriminator
    from stylegan_v_tpu_torch.models.discriminator import DiscriminatorBlock
    from stylegan_v_tpu_torch.parallel.distributed import all_reduce_sum
    from stylegan_v_tpu_torch.tools import moco_memory
    from stylegan_v_tpu_torch.utils.misc import float32_precision

    tag = "[17 moco (a)]"
    setup = moco_setup()
    gcfg, tcfg = setup.gen_cfg, setup.train_cfg
    check(gcfg.motion.gen_strategy == "autoregressive" and not gcfg.motion.fourier
          and setup.disc_source == "mocogan" and setup.loss_cfg.video_consistent_aug
          and tcfg.batch_chip == MOCO_BATCH_GPU and tcfg.D_reg_interval == 16
          and setup.augment_cfg is not None and setup.augment_cfg.warp_upsample == 2
          and gcfg.img_resolution == MOCO_SHAPE[2],
          f"{tag} the composed setup is not the slice's: {setup}")
    state, step = moco_memory.slice_step(setup, dev, augment_p=ADA_P)
    D = state.D
    scales = D.lr_scale_map
    groups = state.opt_D.param_groups
    video = {id(p) for n, p in D.named_parameters() if n.startswith("video_discr.")}
    check(len(groups) == 2 and groups[1]["lr"] == groups[0]["lr"] * scales["video_discr"]
          and {id(p) for p in groups[1]["params"]} == video,
          f"{tag} D's Adam groups: {[(g['lr'], len(g['params'])) for g in groups]}")
    kernels = _kernels()
    B, F, res = MOCO_SHAPE
    batch = moco_memory.slice_batch(dev)
    g = torch.Generator(device=dev).manual_seed(18)
    tf32 = (torch.backends.cudnn, torch.backends.cuda.matmul)
    seen, skips = set(), {}

    def skip_input(module, args):       # the first input each skip takes; args unchanged
        skips.setdefault(module, (tuple(args[0].shape), str(args[0].dtype).split(".")[-1]))

    hooks = [D.register_forward_hook(lambda *_: seen.add(tuple(t.allow_tf32 for t in tf32)))]
    hooks += [m.skip.register_forward_pre_hook(skip_input) for m in D.image_discr.modules()
              if isinstance(m, DiscriminatorBlock) and hasattr(m, "skip")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    all_reduce_sum.calls = 0
    times, measured = {True: [], False: []}, {}
    before_video = [p.detach().clone() for p in groups[1]["params"]]
    try:
        for do_dr1 in (True, False, False, False, True):
            before = [k.launches for k in kernels]
            t0 = time.perf_counter()
            state, stats = step(state, batch, generator=g, do_dr1=do_dr1)
            torch.cuda.synchronize()
            times[do_dr1].append(time.perf_counter() - t0)
            got = measured[do_dr1] = tuple(k.launches - n for k, n in zip(kernels, before))
            check(got == MOCO_LAUNCHES_PER_STEP[do_dr1],
                  f"{tag} step (do_dr1={do_dr1}) launched K1, K1-bwd, K4, K4-bwd, K2 {got} times, "
                  f"expected {MOCO_LAUNCHES_PER_STEP[do_dr1]}")
            bad = [k for k, v in stats.items() if not bool(torch.isfinite(v).all())]
            check(not bad, f"{tag} non-finite stats {bad}")
            check({"Loss/G/loss_video", "Loss/scores/fake_video",
                   "Loss/scores/real_video"} <= set(stats), f"{tag} stats {sorted(stats)}")
    finally:
        for h in hooks:
            h.remove()
    check(seen == {(False, False)}, f"{tag} (cudnn, matmul) allow_tf32 inside D: {seen}")
    check(all_reduce_sum.calls == 0, f"{tag} one process issued {all_reduce_sum.calls} "
                                     "batch-norm all_reduces")
    skips = list(skips.values())
    check(len(skips) == MOCO_LAUNCHES_PER_STEP[False][0] // (3 * MOCO_ROUNDS)
          and all(n == MOCO_BATCH_GPU * F for (n, *_), _ in skips),
          f"{tag} the image D's skip inputs {skips}")
    check(isinstance(D, MoCoGANDiscriminator) and state.step == 5
          and state.cur_nimg == 5 * B * F, f"{tag} step {state.step}, {state.cur_nimg} frames")
    moved = max(float((p.detach() - b).abs().max())
                for p, b in zip(groups[1]["params"], before_video))
    check(moved > 0, f"{tag} the video branch did not move")
    for name, module in (("G", state.G), ("D", state.D), ("G_ema", state.G_ema)):
        bad = [n for n, p in module.named_parameters() if not bool(torch.isfinite(p).all())]
        check(not bad, f"{tag} non-finite {name} parameters {bad[:5]}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms_main = sum(times[False][1:]) / len(times[False][1:]) * 1e3
    ms_r1 = times[True][1] * 1e3
    ms_step = (15 * ms_main + ms_r1) / 16
    fps = B * F / (ms_step * 1e-3)
    # The video D alone at a round's input, TF32 off as in the step: its
    # forward, and its forward with the backward into the input and the
    # weights (each of a round's Gmain, Dgen and Dreal calls takes one of the two)
    vd, convs, flops = D.video_discr, [], [0]
    x = torch.randn(MOCO_BATCH_GPU, 3, F, res, res, generator=g, device=dev, requires_grad=True)
    for m in vd.modules():
        if hasattr(m, "out_shape"):            # the video D's Conv3d layers
            convs.append(m.register_forward_hook(lambda m, i, o: flops.__setitem__(
                0, flops[0] + 2 * o.numel() * m.weight[0].numel())))
    with float32_precision(False):
        with torch.no_grad():
            vd(x, g)
        for h in convs:
            h.remove()

        def forward():
            with torch.no_grad():
                vd(x, g)

        def forward_backward():
            torch.autograd.backward(vd(x, g).sum(), inputs=[x] + list(vd.parameters()))

        forward_backward()
        ms_fwd, ms_fwd_bwd = in_turns([forward, forward_backward], 3)
    video_ms = MOCO_ROUNDS * 3 * ms_fwd_bwd
    print(f"{tag} the Conv3d video D alone at {list(x.shape)}, float32 without TF32: forward "
          f"{ms_fwd:.1f} ms ({flops[0] / 1e12:.3f} TFLOP, {flops[0] / ms_fwd / 1e9:.1f} "
          f"TFLOP/s), forward and backward {ms_fwd_bwd:.1f} ms (CUDA events, in turns); "
          f"{MOCO_ROUNDS} rounds x 3 calls = {video_ms:.0f} ms, {video_ms / ms_main:.2f} of the "
          f"step without R1", flush=True)
    print(f"{tag} MoCoGAN step (LSTM G at channel_base {gcfg.channel_base}, image D + Conv3d "
          f"video D), {B}x{F} at {res}^2 "
          f"in {MOCO_ROUNDS} rounds of {MOCO_BATCH_GPU} videos (the pipe on "
          f"{list(MOCO_WARP_BATCH[:2])} x {res}^2), bgc ADA at p {ADA_P}: {ms_main:.1f} ms "
          f"without R1 (first {times[False][0] * 1e3:.1f}), {ms_r1:.1f} ms with R1 (first "
          f"{times[True][0] * 1e3:.1f}); amortised at R1 every 16: {ms_step:.1f} ms/step, "
          f"{fps:.1f} frames/s; peak {peak:.2f} GiB; D's Adam groups lr "
          f"{[g['lr'] for g in groups]} (video_discr {scales['video_discr']}x); losses "
          f"{', '.join(f'{k} {v.item():.4f}' for k, v in stats.items())}; {KERNELS} "
          f"launches per step {measured[False]} without R1, "
          f"{measured[True]} with (phase 11's {ADA_LAUNCHES_PER_STEP[False]}, "
          f"{ADA_LAUNCHES_PER_STEP[True]}); the image D's skip inputs {skips}; allow_tf32 "
          f"inside D {sorted(seen)}; on {smi}", flush=True)
    return measured, (ms_main, ms_r1, ms_step, fps, peak), skips


def reduced_mocogan():
    """(c)'s reduced-width MoCoGAN on the CPU: the LSTM G and the MoCoGAN D at
    64^2 (the video D's least size), 4 videos x 3 frames, num_t_paddings=6."""
    import torch
    from stylegan_v_tpu_torch.models import (DiscriminatorConfig, Generator, GeneratorConfig,
                                             MoCoGANDiscriminator, MotionConfig, SamplingConfig,
                                             TimeEncConfig)
    sampling = SamplingConfig(num_frames_per_video=3, max_num_frames=16)
    gcfg = GeneratorConfig(
        w_dim=64, z_dim=64, img_resolution=64, channel_base=1024, channel_max=64,
        num_bf16_res=0, mapping_layers=2, input_type="const",
        motion=MotionConfig(z_dim=32, v_dim=32, motion_z_distance=1,
                            gen_strategy="autoregressive", fourier=False),
        time_enc=TimeEncConfig(cond_type="concat_w", dim=32), sampling=sampling)
    dcfg = DiscriminatorConfig(img_resolution=64, channel_base=1024, channel_max=64,
                               num_bf16_res=0, mbstd_group_size=4, mapping_layers=2,
                               sampling=sampling)
    gen = torch.Generator().manual_seed(23)
    G = Generator(gcfg, generator=gen)          # training mode: cuDNN's LSTM backward needs it
    D = MoCoGANDiscriminator(dcfg, video_discr_num_t_paddings=6, generator=gen)
    z = torch.randn(4, gcfg.z_dim, generator=gen)
    t = torch.tensor([[0.0, 1.0, 2.0], [3.0, 5.0, 9.0], [0.0, 7.0, 14.0], [2.5, 4.0, 6.5]])
    mz = G.synthesis.motion_encoder.sample_motion_z(4, gen)
    real = torch.rand(12, 3, 64, 64, generator=gen) * 2 - 1
    return G, D, z, t, mz, real


def moco_run(G, D, inputs, draws, frames, device):
    """(c)'s forward and gradients on `device`: the LSTM G's frames and D's two
    logits on the real frames, Gmain's gradient of G (D's input takes the first
    run's frames' values, `frames["cpu"]`, as phase 9 pins them) and Dr1's of
    D; each gradient as a list in parameters() order, on the CPU."""
    import torch
    from stylegan_v_tpu_torch.training import GANLoss, LossConfig

    z, t, mz, real = (x.to(device) for x in inputs)
    with torch.no_grad():
        img = G(z, None, t, motion_z=mz)
        out = D(real, None, t, noise=draws["d"])
    loss = GANLoss(G, D, LossConfig(r1_gamma=1.0))
    synthesis = loss.run_synthesis

    def pinned(*args, **kwargs):
        x = synthesis(*args, **kwargs)
        if "cpu" not in frames:
            frames["cpu"] = x.detach()
            return x
        return x + (frames["cpu"].to(device) - x).detach()

    loss.run_synthesis = pinned
    l, _ = loss.gmain(z, None, t, mz, d_noise=draws["gmain"])
    gG = torch.autograd.grad(l, list(G.parameters()), allow_unused=True)
    l, _ = loss.dreal_dr1(real, None, t, do_main=False, do_r1=True, r1_gamma=1.0,
                          d_noise=draws["dr1"])
    gD = torch.autograd.grad(l, list(D.parameters()), allow_unused=True)
    grads = [[(g if g is not None else torch.zeros_like(p)).cpu()
              for p, g in zip(m.parameters(), gs)] for m, gs in ((G, gG), (D, gD))]
    outs = {"frames": img.cpu(), **{k: v.cpu() for k, v in out.items()}}
    return outs, dict(zip(("G", "D"), grads))


def forward_move(got, want):
    """The largest of (max |got - want|) / (want's largest magnitude) over
    (c)'s outputs: frames, image_logits, video_logits."""
    return max(float((got[k] - w).abs().max()) / float(w.abs().max()) for k, w in want.items())


def moco_parity(dev):
    """Phase 17 (c): card against CPU at reduced width with the same weights and
    draws (RecordedDraws: the video D's noise too): the LSTM G's frames and D's
    two logits within PARITY_TOL of scale; Gmain's dG and Dr1's dD within
    MOCO_FLOOR_FACTOR times the CPU's own gradient move at the weight move
    that moves the CPU's outputs as far as the card's differ from them (the
    constants' comment), and at least PARITY_TOL."""
    import torch
    from stylegan_v_tpu_torch.ops import downfirdn2d_x2, downfirdn2d_x2_bwd

    tag = "[17 moco (c)]"
    G, D, z, t, mz, real = reduced_mocogan()
    inputs = (z, t, mz, real)
    draws = {k: RecordedDraws(seed) for k, seed in (("d", 24), ("gmain", 25), ("dr1", 26))}
    frames = {}

    def replay():
        for d in draws.values():
            d.replay()

    def counts():
        return downfirdn2d_x2.launches, downfirdn2d_x2_bwd.launches

    before = counts()
    want, want_g = moco_run(copy.deepcopy(G), copy.deepcopy(D), inputs, draws, frames,
                            torch.device("cpu"))
    check(counts() == before, f"{tag} the CPU run launched a kernel")
    replay()
    got, got_g = moco_run(copy.deepcopy(G).to(dev), copy.deepcopy(D).to(dev), inputs, draws,
                          frames, dev)
    ran = tuple(a - b for a, b in zip(counts(), before))
    check(min(ran) > 0, f"{tag} the card run launched K1, K1-bwd {ran} times")
    card_move = forward_move(got, want)

    def cpu_moved(seed, move):
        replay()
        Gp, Dp = copy.deepcopy(G), copy.deepcopy(D)
        noise = torch.Generator().manual_seed(99 + seed)
        with torch.no_grad():
            for p in list(Gp.parameters()) + list(Dp.parameters()):
                p.mul_(1 + move * torch.randn(p.shape, generator=noise))
        return moco_run(Gp, Dp, inputs, draws, frames, torch.device("cpu"))

    floor, moves = {"G": 0.0, "D": 0.0}, []
    before = counts()
    for seed in range(MOCO_FLOOR_SEEDS):
        move = MOCO_PROBE_MOVE * card_move / forward_move(cpu_moved(seed, MOCO_PROBE_MOVE)[0],
                                                          want)
        moves.append(move)
        for name, err in grad_errors(cpu_moved(seed, move)[1], want_g).items():
            floor[name] = max(floor[name], err[0] / err[1])
    check(counts() == before, f"{tag} the CPU runs launched a kernel")
    msgs = []
    for k, w in want.items():
        scale = float(w.abs().max())
        err = float((got[k] - w).abs().max())
        check(bool(torch.isfinite(got[k]).all()) and err <= PARITY_TOL * scale,
              f"{tag} card vs CPU {k}: max err {err} > {PARITY_TOL} * {scale}")
        msgs.append(f"{k} {tuple(w.shape)} max_abs_err {err:.3g} (scale {scale:.3g})")
    for name, err in grad_errors(got_g, want_g).items():
        what = "Gmain dG" if name == "G" else "Dr1 dD"
        rel, rel_floor = err[0] / err[1], floor[name]
        tol = max(PARITY_TOL, MOCO_FLOOR_FACTOR * rel_floor)
        check(rel <= tol, f"{tag} card vs CPU {what}: max err {err[0]} = {rel:.3g} of scale "
                          f"{err[1]} > {tol:.3g}")
        msgs.append(f"{what} max_abs_err {err[0]:.3g} = {rel:.3g} of scale {err[1]:.3g}, "
                    f"{err[2]:.3g} of its L2 norm (the CPU's own, the largest of "
                    f"{MOCO_FLOOR_SEEDS} draws: {rel_floor:.3g}; tol {tol:.3g})")
    print(f"{tag} 64^2 reduced width, LSTM G on cuDNN, the video D's noise replayed; card "
          f"(K1, K1-bwd launched {ran}) vs CPU: " + "; ".join(msgs) + f"; the card's outputs "
          f"differ by {card_move:.3g} of scale, which the CPU's move as weights x (1 + m N(0, "
          f"1)) at m = {', '.join(f'{m:.3g}' for m in moves)} matches", flush=True)


def moco_loop(dev, smi, zip_path, tmp, step_ms):
    """Phase 17 (d): the loop through the entry point on phase 13's zip, model=
    mocogan with the slice's overrides: 4 steps (2 ticks, a snapshot), then
    resume=latest for 4 more; returns the run dir."""
    import contextlib
    import io
    import math
    import os
    import torch
    from stylegan_v_tpu_torch import train as entry
    from stylegan_v_tpu_torch.io.checkpoint import load_snapshot, snapshot_payload
    from stylegan_v_tpu_torch.models import MoCoGANDiscriminator
    from stylegan_v_tpu_torch.tools import moco_memory

    tag = "[17 moco (d)]"
    kernels = _kernels()
    tf32 = (torch.backends.cudnn, torch.backends.cuda.matmul)
    seen = set()

    def d_hook(module, *_):
        if isinstance(module, MoCoGANDiscriminator):
            seen.add(tuple(t.allow_tf32 for t in tf32))

    run = os.path.join(tmp, "run_moco")
    args = [f"dataset.path={zip_path}"] + moco_memory.OVERRIDES + [
        f"training.batch_gpu={MOCO_BATCH_GPU}", "training.kimg=1", "training.kimg_per_tick=0.5",
        "training.snap=2", "training.metrics=[]", f"project_release_dir={run}"]
    hook = torch.nn.modules.module.register_module_forward_hook(d_hook)
    results, counts, synthesis, secs, out = [], [], [], [], io.StringIO()
    try:
        for extra in ([], ["training.resume=latest", "training.kimg=2"]):
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), SynthesisCalls() as syn:
                results.append(entry.main(args + extra))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts.append(tuple(k.launches for k in kernels))
            synthesis.append(syn.k2)
            if not extra:       # the first run's last snapshot, to the bit
                payload, meta = load_snapshot(os.path.join(run, "network-snapshot-000001.pt"))
                check(meta["cur_nimg"] == 1024, f"{tag} snapshot 000001 at {meta['cur_nimg']}")
                n_saved = _equal_trees(snapshot_payload(results[0]["state"]), payload,
                                       "snapshot 000001", tag)
                results[0]["step"] = results[0].pop("state").step
    finally:
        hook.remove()
    first, second = results
    state = second["state"]
    check((first["cur_nimg"], first["step"]) == (1024, 4)
          and (second["start_nimg"], second["start_step"]) == (1024, 4)
          and (second["cur_nimg"], state.step) == (2048, 8),
          f"{tag} runs ended at {first['cur_nimg']}, resumed at {second['start_nimg']}, ended "
          f"at {second['cur_nimg']}")
    groups = state.opt_D.param_groups
    check(isinstance(state.D, MoCoGANDiscriminator) and len(groups) == 2
          and groups[1]["lr"] == groups[0]["lr"] * 0.1,
          f"{tag} the resumed D's Adam groups: {[g['lr'] for g in groups]}")
    for (lo, hi), got, syn_k2 in zip(MOCO_LOOP_RUNS, counts, synthesis):
        want = loop_launches(MOCO_LAUNCHES_PER_STEP, range(lo, hi), syn_k2, MOCO_ROUNDS)
        check(got == want, f"{tag} steps {lo}-{hi - 1} launched {KERNELS} {got} times, "
                           f"expected {want} (R1 at every 16th step index; K2 also 12 a "
                           f"snapshot grid's synthesis)")
    check(seen == {(False, False)}, f"{tag} (cudnn, matmul) allow_tf32 in D: {seen}")
    files = set(os.listdir(run))
    check({f"network-snapshot-{k:06d}.pt" for k in (1, 2)} <= files,
          f"{tag} snapshots {sorted(f for f in files if f.endswith('.pt'))}")
    rows = [json.loads(line) for line in open(os.path.join(run, "stats.jsonl"))]
    check(len(rows) == 4, f"{tag} {len(rows)} stats rows, expected 2 ticks a run")
    for row in rows:
        check({"Loss/G/loss_video", "Loss/scores/fake_video", "Loss/scores/real_video"}
              <= set(row), f"{tag} stats keys {sorted(row)}")
        check(all(math.isfinite(v["mean"]) for k, v in row.items() if k != "timestamp"),
              f"{tag} a non-finite stat in {row}")
    ms = [r["Timing/Gmain_Dmain"]["mean"] * 1e3 for r in rows[2:] if "Timing/Gmain_Dmain" in r]
    print("\n".join(f"{tag} {line}" for line in out.getvalue().splitlines()
                    if line.startswith("tick ")))
    print(f"{tag} `python -m stylegan_v_tpu_torch.train` model=mocogan on phase 13's zip, "
          f"{MOCO_SHAPE[0]}x{MOCO_SHAPE[1]} at {MOCO_SHAPE[2]}^2, batch_gpu {MOCO_BATCH_GPU}: "
          f"4 steps ({secs[0]:.1f} s with the setup and snapshots), snapshot 000001 equal to "
          f"the bit to the state in memory ({n_saved} tensors), resumed from latest at step 4 "
          f"for 4 more ({secs[1]:.1f} s); the resumed D's Adam groups lr "
          f"{[g['lr'] for g in groups]}; launches K1, K1-bwd, K4, K4-bwd, K2 per run {counts[0]} "
          f"and {counts[1]}; allow_tf32 in D {sorted(seen)}; loader-fed Timing/Gmain_Dmain "
          f"{', '.join(f'{m:.1f}' for m in ms)} ms in the resumed ticks (pre-staged (a): "
          f"{step_ms:.1f} ms); on {smi}", flush=True)
    return run


def moco_sample(dev, smi, zip_path, tmp, run, models):
    """Phase 17 (e): `python -m stylegan_v_tpu_torch.generate` on (d)'s last
    snapshot against generate_videos on the card, with clips/s; SMOKE_FVD from
    that snapshot, finite; no kernel launch."""
    import contextlib
    import io
    import math
    import os
    import numpy as np
    import torch
    from stylegan_v_tpu_torch import generate
    from stylegan_v_tpu_torch.metrics import metric_main
    from stylegan_v_tpu_torch.training.video_io import generate_videos
    from stylegan_v_tpu_torch.utils.misc import float32_precision

    tag = "[17 moco (e)]"
    kernels = _kernels()
    for k in kernels:
        k.launches = 0
    syn = SynthesisCalls().__enter__()
    path = os.path.join(run, "network-snapshot-000002.pt")
    argv = ["--network", path, "-o", os.path.join(tmp, "gen_moco"), "--num-videos",
            str(MOCO_CLIPS), "--video-len", "16"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), deterministic():
        got = generate.main(argv + ["--device", str(dev)])
    t_cli = time.perf_counter() - t0
    with contextlib.redirect_stdout(io.StringIO()):
        G = generate.load_any_checkpoint(path, dev)
    args = generate.parse_args(argv)
    z, c, ts, mz = generate.draw_inputs(args, G.cfg)

    def synthesise():
        with float32_precision(False):
            return generate_videos(G, z, c, ts, motion_z=mz, noise_mode=args.noise_mode,
                                   truncation_psi=args.truncation_psi,
                                   batch_size_num_frames=args.batch_size_num_frames,
                                   seed=args.seed)
    with deterministic():
        want = synthesise()
    res = MOCO_SHAPE[2]
    check(G.cfg.motion.gen_strategy == "autoregressive"
          and got.shape == (MOCO_CLIPS, 16, res, res, 3) and np.array_equal(got, want),
          f"{tag} generate on the MoCoGAN snapshot differs from generate_videos")
    synthesise()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    synthesise()
    torch.cuda.synchronize()
    t_syn = time.perf_counter() - t0
    register_smoke_metrics(dev, models)
    t0 = time.perf_counter()
    fvd = metric_main.calc_metric(
        SMOKE_FVD, G=G, dataset_kwargs=dict(path=zip_path, sampling=G.cfg.sampling,
                                            max_num_frames=G.cfg.sampling.max_num_frames,
                                            resolution=res),
        device=dev).results[SMOKE_FVD]
    t_fvd = time.perf_counter() - t0
    check(math.isfinite(fvd), f"{tag} {SMOKE_FVD} {fvd!r}")
    launches = tuple(k.launches for k in kernels)
    syn.__exit__()
    want = (0, 0, 0, 0, syn.k2)
    check(launches == want and syn.backwards == 0,
          f"{tag} {KERNELS} launched {launches} times in generate and the metric, expected "
          f"{want} (K2: 12 for each of {syn.forwards} synthesis calls)")
    print(f"{tag} generate on snapshot 000002 (LSTM G_ema), {MOCO_CLIPS} clips x 16 frames at "
          f"{res}^2: equal to generate_videos to the bit; {MOCO_CLIPS / t_syn:.2f} clips/s of "
          f"synthesis (warm, {t_syn:.3f} s), the CLI {t_cli:.2f} s with the load; {SMOKE_FVD} "
          f"({METRIC_ITEMS[0]} real, {METRIC_ITEMS[1]} generated clips, phase 14's random "
          f"detectors) {fvd!r} in {t_fvd:.1f} s; launches {launches}; on {smi}", flush=True)


def phase_mocogan(dev, smi, zip_path, tmp, models, k4_9ch):
    """Phase 17: MoCoGAN with the LSTM G at FFS-256, (a)-(e); `k4_9ch` is
    phase 10's (K4, K4-bwd) record at 9 channels, printed beside (b)'s.
    Returns (a)'s launches per step, (b)'s K1 and K1-bwd records (phase_kernel's)
    at the image D's skips and (b)'s K4 and K4-bwd records at 48 channels."""
    import torch
    from stylegan_v_tpu_torch.ops import (downfirdn2d_x2, downfirdn2d_x2_bwd,
                                          downfirdn2d_x2_bwd_plain, downfirdn2d_x2_plain)
    from stylegan_v_tpu_torch.utils.misc import float32_precision

    t_phase, parts = time.perf_counter(), {}
    t0 = time.perf_counter()
    launches, step, skips = moco_step(dev, smi)     # the step's own TF32 default
    parts["a"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sets = ((f"{MOCO_BATCH_GPU}x{MOCO_SHAPE[1]}", skips),)
    with float32_precision(False):
        k1 = phase_kernel(dev, "[17 moco (b)] K1", "down", downfirdn2d_x2,
                          downfirdn2d_x2_plain, sets)
        torch.cuda.empty_cache()
        k1_bwd = phase_kernel(dev, "[17 moco (b)] K1-bwd", "up", downfirdn2d_x2_bwd,
                              downfirdn2d_x2_bwd_plain, sets)
        torch.cuda.empty_cache()
        k4, k4_bwd = phase_warp(dev, MOCO_WARP_BATCH, upsamples=(2,), tag="[17 moco (b)]",
                                autograd=False)
    for name, rec, nine in (("K4", k4, k4_9ch[0]), ("K4-bwd", k4_bwd, k4_9ch[1])):
        print(f"[17 moco (b)] {name} at the MoCoGAN pipe's warp {list(MOCO_WARP_BATCH[:2])} x "
              f"536^2 -> 524^2 bf16: {rec[1]:.4f} ms, {rec[4] / rec[1]:.3f} of its "
              f"{rec[4]:.4f} ms bound (plain {rec[2]:.4f} ms); at phase 10's [16, 9]: "
              f"{nine[1]:.4f} ms, {nine[4] / nine[1]:.3f} of {nine[4]:.4f} ms", flush=True)
    parts["b"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with float32_precision(False):
        moco_parity(dev)
    parts["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = moco_loop(dev, smi, zip_path, tmp, step[0])   # the loop's own TF32 default
    parts["d"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with float32_precision(False):
        moco_sample(dev, smi, zip_path, tmp, run, models)
    parts["e"] = time.perf_counter() - t0
    print(f"[17 moco] the parts took " + ", ".join(f"({k}) {v:.1f} s" for k, v in parts.items())
          + f"; phase 17 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, k1, k1_bwd, k4, k4_bwd


# ---------------------------------------------------------------- phase 18
# The remaining CLIs (stylegan_v_tpu_torch/{project,clip_edit,export_model,
# frames_to_video_grid,launch,batch_launch}.py) on phase 16's FFS-256 .pkl.
PROJ_SHAPE = (8, 256)            # (a): target frames (one video) and resolution
PROJ_STEPS, PROJ_TRIALS, PROJ_LPIPS_STEPS = 100, 4, 10
# (a): K1 and K1-bwd launches per projection step, derived from the code. The
# fallback loss takes three 2x downsamples of the frames (the K1 case of
# upfirdn2d: a 4x4 filter, down 2, padding 1, even sizes): 3 K1, and 3 K1-bwd
# in the backward. G's upsamples are not the K1 case, and their gradient is
# upfirdn2d's own (_UpFirDn2d.backward calls _UpFirDn2d, never the K1 route),
# so G's backward adds none. Once a run: the target's pyramid, 3 K1; each
# motion trial's loss, 3 K1. The LPIPS objective launches none.
PROJ_LAUNCHES_PER_STEP = (3, 3)
# (b): K1's inputs in the pyramid, [8, 3, 256^2] down to [8, 3, 64^2] (K1-bwd
# takes their outputs, 128^2 down to 32^2), float32 as the loss runs them
PYRAMID_SHAPES = [((PROJ_SHAPE[0], 3, PROJ_SHAPE[1] >> i, PROJ_SHAPE[1] >> i), "float32")
                  for i in range(3)]
EDIT_STEPS, EDIT_FRAMES = 30, 8  # (d)
EXPORT_SHAPE = (4, 16)           # (e): batch, video length of the artifact
EXPORT_TIMED_CALLS = 5
# (g): each launched job's overrides on phase 13's zip: job 1 trains 1 kimg (21
# steps of 16 videos x 3 frames), job 2 resumes at its end and takes one step
LAUNCH_ARGS = ["training.batch_size=16", "training.kimg=1", "training.metrics=[]"]


def stand_in_vgg():
    """(a)'s stand-in for the reference's vgg16.pt: its call signature (img
    0..255 NCHW, resize_images=, return_lpips=), a seeded conv, ReLU, mean
    and a normalised 8-dim feature (tests/test_project_cli.py's FakeVGG)."""
    import torch

    class StandInVGG(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 8, 4, stride=4)
            gen = torch.Generator().manual_seed(18)
            with torch.no_grad():
                for p in self.parameters():
                    p.copy_(0.2 * torch.randn(p.shape, generator=gen))

        def forward(self, x, resize_images: bool = False, return_lpips: bool = True):
            y = torch.nn.functional.relu(self.conv(x / 255.0)).mean(dim=(2, 3))
            return y / torch.sqrt(torch.sum(y * y, dim=1, keepdim=True) + 1e-8)
    return StandInVGG().eval()


def stand_in_clip(seed):
    """(c), (d): a stand-in for CLIP's image tower behind clip_edit's
    preprocessing (area resize to 224, CLIP's normalisation): a seeded 16x16
    stride-16 conv, ReLU, mean and a linear map to 16 dims."""
    import torch
    import torch.nn.functional as F
    from stylegan_v_tpu_torch.clip_edit import CLIP_MEAN, CLIP_STD

    class StandInClip(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 8, 16, stride=16)
            self.fc = torch.nn.Linear(8, 16)
            gen = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for p in self.parameters():
                    p.copy_(0.2 * torch.randn(p.shape, generator=gen))
            self.register_buffer("mean", torch.tensor(CLIP_MEAN).view(1, 3, 1, 1))
            self.register_buffer("std", torch.tensor(CLIP_STD).view(1, 3, 1, 1))

        def forward(self, x):
            img = F.interpolate(x * 0.5 + 0.5, size=(224, 224), mode="area")
            return self.fc(F.relu(self.conv((img - self.mean) / self.std)).mean(dim=(2, 3)))
    return StandInClip().eval().requires_grad_(False)


def stand_in_arcface(path):
    """(c), (d): a scripted stand-in for the ir_se50 ArcFace export at `path`:
    a seeded 16x16 stride-16 conv and a mean, [N, 3, 112, 112] -> [N, 8]."""
    import torch

    class StandInArcFace(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 8, 16, stride=16)
            gen = torch.Generator().manual_seed(21)
            with torch.no_grad():
                for p in self.parameters():
                    p.copy_(0.2 * torch.randn(p.shape, generator=gen))

        def forward(self, x):
            return self.conv(x).mean(dim=(2, 3))
    torch.jit.script(StandInArcFace().eval()).save(path)
    return path


def cli_project(dev, smi, tmp, pkl):
    """Phase 18 (a): `python -m stylegan_v_tpu_torch.project` in process on the
    .pkl, targets from its G_ema at a known (z, motion_z): the fallback loss
    for PROJ_STEPS steps with launches asserted, then the LPIPS branch with a
    scripted stand-in vgg16.pt. Returns ms a step of the fallback loss and
    K1's and K1-bwd's launches a step as counted in its run."""
    import contextlib
    import io
    import os
    import numpy as np
    import PIL.Image
    import torch
    from stylegan_v_tpu_torch import generate, project
    from stylegan_v_tpu_torch.utils.misc import float32_precision

    tag = "[18 cli (a)]"
    frames_n, res = PROJ_SHAPE
    with contextlib.redirect_stdout(io.StringIO()):
        G = generate.load_any_checkpoint(pkl, dev)
    check(G.cfg.img_resolution == res, f"{tag} the .pkl's G is {G.cfg.img_resolution}^2")
    g = torch.Generator(device=dev).manual_seed(18)
    z = torch.randn(1, G.cfg.z_dim, generator=g, device=dev)
    mz = G.synthesis.motion_encoder.sample_motion_z(1, g, max_t=float(frames_n))
    t = torch.arange(frames_n, dtype=torch.float32, device=dev)[None]
    with torch.no_grad(), float32_precision(False):
        frames = G(z, None, t, motion_z=mz, noise_mode="none")
    target = os.path.join(tmp, "proj_target")
    os.makedirs(target)
    u8 = (frames * 127.5 + 128).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    for i, im in enumerate(u8):
        PIL.Image.fromarray(im).save(os.path.join(target, f"{i:06d}.png"))
    del G, frames
    kernels = _kernels()

    def run(out_dir, steps, extra):
        for k in kernels:
            k.launches = 0
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed), SynthesisCalls() as syn:
            result = project.main(["--network", pkl, "--target-dir", target, "-o", out_dir,
                                   "--num-steps", str(steps), "--num-frames", str(frames_n),
                                   "--motion-init-trials", str(PROJ_TRIALS), "--seed", "18",
                                   "--device", str(dev)] + extra)
        torch.cuda.synchronize()
        launches = tuple(k.launches for k in kernels)
        check(launches[4] == syn.k2 and syn.backwards == steps,
              f"{tag} {extra or 'fallback'}: K2 launched {launches[4]} times, G's synthesis "
              f"accounts for {syn.k2} ({syn.forwards} forwards, {syn.backwards} backwards, "
              f"12 each) in {steps} steps")
        lat = np.load(os.path.join(out_dir, "projected_latents.npz"))
        losses = result["losses"]
        check(len(losses) == steps and np.isfinite(losses).all()
              and np.isfinite(lat["w"]).all() and np.isfinite(lat["motion_z"]).all()
              and os.path.exists(os.path.join(out_dir, "projected.mp4")),
              f"{tag} {extra or 'fallback'}: non-finite losses or latents, or no mp4")
        check(losses[-1] < result["init_loss"],
              f"{tag} {extra or 'fallback'}: the last loss {losses[-1]} is not below the "
              f"motion search's best {result['init_loss']}")
        return result, launches, printed.getvalue()

    empty = os.path.join(tmp, "proj_no_detectors")
    os.makedirs(empty)
    t0 = time.perf_counter()
    result, launches, printed = run(os.path.join(tmp, "proj_out"), PROJ_STEPS,
                                    ["--detector-dir", empty])
    t_cli = time.perf_counter() - t0
    check("vgg16.pt not found" in printed, f"{tag} the fallback loss did not run: {printed[:200]}")
    per_run = 3 + 3 * PROJ_TRIALS
    want = (per_run + PROJ_LAUNCHES_PER_STEP[0] * PROJ_STEPS,
            PROJ_LAUNCHES_PER_STEP[1] * PROJ_STEPS, 0, 0, launches[4])
    check(launches == want, f"{tag} K1, K1-bwd, K4, K4-bwd, K2 launched {launches} times, expected "
                            f"{want} ({per_run} K1 for the target's pyramid and the motion "
                            f"trials, then {PROJ_LAUNCHES_PER_STEP} a step)")
    ms_step = result["seconds"] / PROJ_STEPS * 1e3

    det = os.path.join(tmp, "proj_detectors")
    os.makedirs(det)
    torch.jit.script(stand_in_vgg()).save(os.path.join(det, "vgg16.pt"))
    lp, lp_launches, lp_printed = run(os.path.join(tmp, "proj_out_lpips"), PROJ_LPIPS_STEPS,
                                      ["--detector-dir", det])
    check("Using VGG16-LPIPS perceptual loss" in lp_printed and lp_launches[:4] == (0,) * 4,
          f"{tag} LPIPS branch: launches {lp_launches}, output {lp_printed[:200]}")
    print(f"{tag} `python -m stylegan_v_tpu_torch.project` on the .pkl, {frames_n} target "
          f"frames at {res}^2 from its G_ema, fallback loss: motion search best of "
          f"{PROJ_TRIALS} {result['init_loss']:.5f}, loss after {PROJ_STEPS} steps "
          f"{result['losses'][-1]:.5f} (step 1 {result['losses'][1]:.5f}), latents finite; "
          f"K1, K1-bwd, K4, K4-bwd, K2 launches {launches} = {per_run} + {PROJ_STEPS} x "
          f"{PROJ_LAUNCHES_PER_STEP} as derived; {ms_step:.2f} ms a step (host clock over the "
          f"steps, synchronised at the end), the CLI {t_cli:.1f} s with the load; LPIPS with a "
          f"scripted stand-in vgg16.pt: {lp['init_loss']:.5f} -> {lp['losses'][-1]:.5f} in "
          f"{PROJ_LPIPS_STEPS} steps ({lp['seconds'] / PROJ_LPIPS_STEPS * 1e3:.2f} ms a step), "
          f"no launch; on {smi}", flush=True)
    return ms_step, ((launches[0] - per_run) / PROJ_STEPS, launches[1] / PROJ_STEPS)


def cli_kernels(dev, k1_pass, k1_bwd_pass):
    """Phase 18 (b): K1 and K1-bwd against their plain versions at the
    pyramid's shapes (phases 3 and 7's checks, times, library call and bound),
    printed beside phase 3 and 7's one D pass at 16 x 3."""
    from stylegan_v_tpu_torch.ops import (downfirdn2d_x2, downfirdn2d_x2_bwd,
                                          downfirdn2d_x2_bwd_plain, downfirdn2d_x2_plain)
    from stylegan_v_tpu_torch.utils.misc import float32_precision
    sets = ((f"{PROJ_SHAPE[0]}x3 pyramid", PYRAMID_SHAPES),)
    with float32_precision(False):
        k1 = phase_kernel(dev, "[18 cli (b)] K1", "down", downfirdn2d_x2, downfirdn2d_x2_plain,
                          sets)
        k1_bwd = phase_kernel(dev, "[18 cli (b)] K1-bwd", "up", downfirdn2d_x2_bwd,
                              downfirdn2d_x2_bwd_plain, sets)
    for name, rec, d_pass, phase in (("K1", k1, k1_pass, 3), ("K1-bwd", k1_bwd, k1_bwd_pass, 7)):
        m, d = rec[1], d_pass[1]
        print(f"[18 cli (b)] {name} over the projection's three pyramid levels (one side a "
              f"step): {m['ms']:.4f} ms, {m['bound_ms'] / m['ms']:.3f} of its "
              f"{m['bound_ms']:.4f} ms bound, plain {m['plain_ms']:.4f} ms, library "
              f"{m['library_ms']:.4f} ms, worst error {rec[0]:.3g}; phase {phase}'s D pass at "
              f"16 x 3: {d['ms']:.4f} ms, {d['bound_ms'] / d['ms']:.3f} of "
              f"{d['bound_ms']:.4f} ms", flush=True)
    return k1, k1_bwd


def cli_parity(dev, tmp):
    """Phase 18 (c): at phase 6's reduced width, card against CPU at the same
    weights, targets and draws: the projection loss and its gradient in (w,
    motion_z); edit_loss and its gradient in ws, with the stand-in CLIP and
    ArcFace; each within PARITY_TOL of its scale."""
    import os
    import torch
    import torch.nn.functional as F
    from stylegan_v_tpu_torch import clip_edit, project
    from stylegan_v_tpu_torch.models.motion import MotionMappingNetwork
    from stylegan_v_tpu_torch.utils.misc import float32_precision

    tag = "[18 cli (c)]"
    G, _, _, _, _, gen = reduced_models()
    G.requires_grad_(False)
    frames_n = 4
    L = MotionMappingNetwork.required_traj_len(G.cfg, float(frames_n))
    target = torch.rand(frames_n, 3, 32, 32, generator=gen) * 2 - 1
    w = 0.5 * torch.randn(1, G.num_ws, G.cfg.w_dim, generator=gen)
    mz = torch.randn(1, L, G.cfg.motion.z_dim, generator=gen)
    ws0 = 0.5 * torch.randn(1, G.num_ws, G.cfg.w_dim, generator=gen)
    ws = ws0 + 0.1 * torch.randn(ws0.shape, generator=gen)
    text = F.normalize(torch.randn(16, generator=gen), dim=0)
    t = torch.arange(frames_n, dtype=torch.float32)[None]
    embed = stand_in_clip(22)
    arc_path = stand_in_arcface(os.path.join(tmp, "arcface_parity.pt"))
    kernels = _kernels()[:2]

    def run(device):
        Gd = copy.deepcopy(G).to(device)
        wd, mzd = w.to(device).requires_grad_(True), mz.to(device).requires_grad_(True)
        loss = project.projection_loss(Gd, target.to(device))(wd, mzd)
        gw, gmz = torch.autograd.grad(loss, [wd, mzd])
        e, arc = copy.deepcopy(embed).to(device), clip_edit.make_arcface_embed(arc_path, device)
        td, mzt = t.to(device), mz.to(device)

        def synth(x):
            return Gd.synthesis(x, t=td, motion_z=mzt, noise_mode="none")
        ws0d, wsd = ws0.to(device), ws.to(device).requires_grad_(True)
        with torch.no_grad():
            base = synth(ws0d)
            base_id = arc(base)
        eloss, terms = clip_edit.edit_loss(synth, wsd, ws0d, e, text.to(device), base, base_id,
                                           arc, 0.008, 0.5)
        gws, = torch.autograd.grad(eloss, [wsd])
        out = {"projection loss": loss, "d/dw": gw, "d/dmotion_z": gmz, "edit loss": eloss,
               "clip term": terms[0], "l2 term": terms[1], "id term": terms[2], "d/dws": gws}
        return {k: v.detach().cpu() for k, v in out.items()}

    before = tuple(k.launches for k in kernels)
    with float32_precision(False):
        want = run(torch.device("cpu"))
        check(tuple(k.launches for k in kernels) == before,
              f"{tag} the CPU run launched a kernel")
        got = run(dev)
        torch.cuda.synchronize()
    ran = tuple(k.launches - b for k, b in zip(kernels, before))
    check(ran == (6, 3), f"{tag} the card run launched K1, K1-bwd {ran} times, expected (6, 3): "
                         "the target's pyramid and the frames', and the frames' backward")
    msgs = []
    for k, v in want.items():
        scale = float(v.abs().max())
        err = float((got[k] - v).abs().max())
        check(bool(torch.isfinite(got[k]).all()) and err <= PARITY_TOL * scale,
              f"{tag} card vs CPU {k}: max err {err} > {PARITY_TOL} * {scale}")
        msgs.append(f"{k} {err:.3g} (scale {scale:.3g})")
    print(f"{tag} 32^2 reduced width, card (K1, K1-bwd launched {ran}) vs CPU, max abs err "
          f"within {PARITY_TOL} x scale: " + "; ".join(msgs), flush=True)


def cli_edit(dev, smi, tmp, pkl):
    """Phase 18 (d): clip_edit.edit on the .pkl's G_ema on the card for
    EDIT_STEPS steps, the stand-in CLIP and a scripted stand-in ArcFace:
    finite, the CLIP term falls, no kernel launch."""
    import contextlib
    import io
    import os
    import numpy as np
    import torch
    import torch.nn.functional as F
    from stylegan_v_tpu_torch import clip_edit, generate
    from stylegan_v_tpu_torch.utils.misc import float32_precision

    tag = "[18 cli (d)]"
    with contextlib.redirect_stdout(io.StringIO()):
        G = generate.load_any_checkpoint(pkl, dev)
    embed = stand_in_clip(19).to(dev)
    text = F.normalize(torch.randn(16, generator=torch.Generator().manual_seed(20)), dim=0)
    arc = clip_edit.make_arcface_embed(stand_in_arcface(os.path.join(tmp, "arcface.pt")), dev)
    kernels = _kernels()
    for k in kernels:
        k.launches = 0
    with float32_precision(False), contextlib.redirect_stdout(io.StringIO()), \
            SynthesisCalls() as syn:
        result = clip_edit.edit(G, embed, text.to(dev), arc, num_steps=EDIT_STEPS,
                                num_frames=EDIT_FRAMES, seed=18)
    torch.cuda.synchronize()
    launches = tuple(k.launches for k in kernels)
    hist = np.asarray(result["history"])
    check(hist.shape == (EDIT_STEPS, 4) and np.isfinite(hist).all()
          and bool(torch.isfinite(result["ws"]).all())
          and bool(torch.isfinite(result["frames"]).all()), f"{tag} non-finite edit")
    check(hist[-1, 1] < hist[0, 1], f"{tag} the CLIP term did not fall: {hist[:, 1].tolist()}")
    want = (0, 0, 0, 0, syn.k2)
    check(launches == want and syn.backwards == EDIT_STEPS,
          f"{tag} {KERNELS} launched {launches} times, expected {want} (the stand-ins: no K1 "
          f"case; K2 12 for each of {syn.forwards} synthesis forwards and {syn.backwards} "
          f"backwards)")
    print(f"{tag} clip_edit.edit on the .pkl's G_ema, {EDIT_FRAMES} frames at "
          f"{G.cfg.img_resolution}^2, stand-in CLIP tower and scripted stand-in ArcFace, "
          f"{EDIT_STEPS} steps: CLIP term {hist[0, 1]:.5f} -> {hist[-1, 1]:.5f}, l2 "
          f"{hist[-1, 2]:.5f}, id {hist[-1, 3]:.5f}, max |ws - ws_orig| "
          f"{float((result['ws'] - result['ws_orig']).abs().max()):.4f}; "
          f"{result['seconds'] / EDIT_STEPS * 1e3:.2f} ms a step; launches {launches}; on {smi}",
          flush=True)


FRESH_ARTIFACT = """
import json, sys, torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.use_deterministic_algorithms(True, warn_only=True)
program = torch.export.load(sys.argv[1]).module()
inputs = torch.load(sys.argv[2])
z, t = inputs["z"].to(sys.argv[5]), inputs["t"].to(sys.argv[5])
seeds = [torch.tensor(s, dtype=torch.int32, device=sys.argv[5]) for s in inputs["seeds"]]
with torch.no_grad():
    frames = [program(z, t, s).cpu() for s in seeds]
    for _ in range(2):
        program(z, t, seeds[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(int(sys.argv[4])):
        program(z, t, seeds[0])
    end.record()
    end.synchronize()
torch.save(frames, sys.argv[3])
print(json.dumps({"ms": start.elapsed_time(end) / int(sys.argv[4]),
                  "ours": sorted(m for m in sys.modules if m.startswith("stylegan_v_tpu"))}))
"""


def cli_export(dev, smi, tmp, pkl, gen_rate):
    """Phase 18 (e): `python -m stylegan_v_tpu_torch.export_model --selftest` in
    process on the .pkl; the artifact loaded in a fresh process that imports
    torch alone equal to the in-process artifact's frames, two seeds two
    videos, clips/s of the loaded artifact beside phase 16's generate."""
    import contextlib
    import io
    import os
    import numpy as np
    import torch
    from stylegan_v_tpu_torch import export_model
    from stylegan_v_tpu_torch.utils.misc import float32_precision

    tag = "[18 cli (e)]"
    B, T = EXPORT_SHAPE
    out = os.path.join(tmp, "ffs256.pt2")
    kernels = _kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        meta = export_model.main(["--ckpt", pkl, "--out", out, "--batch", str(B),
                                  "--video-len", str(T), "--selftest", "--device", str(dev)])
    t_export = time.perf_counter() - t0
    res = PROJ_SHAPE[1]
    check(meta["output"] == [B, T, 3, res, res] and meta["device"] == str(dev),
          f"{tag} sidecar {meta}")
    rng = np.random.RandomState(18)
    inputs = {"z": torch.from_numpy(rng.randn(B, meta["inputs"]["z"][1]).astype(np.float32)),
              "t": torch.arange(T, dtype=torch.float32)[None].repeat(B, 1), "seeds": [5, 6]}
    torch.save(inputs, os.path.join(tmp, "export_inputs.pt"))
    program = torch.export.load(out).module()
    with torch.no_grad(), deterministic(), float32_precision(False):
        here = [program(inputs["z"].to(dev), inputs["t"].to(dev),
                        torch.tensor(s, dtype=torch.int32, device=dev)).cpu()
                for s in inputs["seeds"]]
    launches = tuple(k.launches for k in kernels)
    # the trace and the artifact's calls run the ATen route; the selftest's
    # direct forward, one synthesis at 256^2, runs K2
    want = (0, 0, 0, 0, K2_PER_SYNTHESIS_256)
    check(launches == want and meta["fir_route"] == export_model.FIR_ROUTE == "aten",
          f"{tag} export and its calls launched {KERNELS} {launches}, expected {want}; the "
          f"sidecar's fir_route {meta.get('fir_route')!r}")
    check(all(bool(torch.isfinite(f).all()) for f in here)
          and float((here[0] - here[1]).abs().max()) > 1e-3,
          f"{tag} the artifact's frames are not finite, or two seeds gave one video")
    del program
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    frames_path = os.path.join(tmp, "export_frames.pt")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", FRESH_ARTIFACT, out,
                           os.path.join(tmp, "export_inputs.pt"), frames_path,
                           str(EXPORT_TIMED_CALLS), str(dev)], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=600)
    t_fresh = time.perf_counter() - t0
    check(proc.returncode == 0, f"{tag} the torch-only process failed: {proc.stderr[-3000:]}")
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    fresh = torch.load(frames_path)
    check(not info["ours"], f"{tag} the torch-only process imported {info['ours']}")
    err = max(float((a - b).abs().max()) for a, b in zip(fresh, here))
    check(all(torch.equal(a, b) for a, b in zip(fresh, here)),
          f"{tag} the torch-only process's frames differ from this process's: max err {err}")
    clips = B / (info["ms"] * 1e-3)
    print(f"{tag} `python -m stylegan_v_tpu_torch.export_model --selftest` on the .pkl, batch "
          f"{B} x {T} frames: {os.path.getsize(out) / 2**20:.1f} MiB ExportedProgram of ATen "
          f"ops, traced and saved in {t_export:.1f} s with the selftest (max abs err "
          f"{meta['selftest_max_abs_err']:.3g}, tol 0.05 with bf16 blocks); loaded in a process "
          f"that imports torch alone ({t_fresh:.1f} s with its start): frames equal to this "
          f"process's to the bit at seeds 5 and 6, which differ by "
          f"{float((here[0] - here[1]).abs().max()):.3f}; {clips:.2f} clips/s of {T} frames "
          f"({info['ms']:.2f} ms a call, CUDA events over {EXPORT_TIMED_CALLS}) against phase "
          f"16's generate {gen_rate:.2f} clips/s; launches {launches}; on {smi}", flush=True)
    return clips


def cli_grid(tmp):
    """Phase 18 (f): frames_to_video_grid on phase 16 (c)'s frame folders, the
    mp4 read back with the grid's frame count and size."""
    import contextlib
    import io
    import os
    import cv2
    from stylegan_v_tpu_torch import frames_to_video_grid

    tag = "[18 cli (f)]"
    src, out = os.path.join(tmp, "gen_pkl"), os.path.join(tmp, "grid.mp4")
    with contextlib.redirect_stdout(io.StringIO()):
        grid = frames_to_video_grid.main(["-s", src, "-o", out, "--num_videos", "9"])
    cap = cv2.VideoCapture(out)
    shapes = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        shapes.append(frame.shape)
    cap.release()
    check(len(shapes) == grid.shape[0] == 16 and set(shapes) == {grid.shape[1:]},
          f"{tag} grid.mp4 read back {len(shapes)} frames {set(shapes)}, expected 16 of "
          f"{grid.shape[1:]}")
    print(f"{tag} `python -m stylegan_v_tpu_torch.frames_to_video_grid` on 9 of phase 16's "
          f"frame folders: grid.mp4 reads back {len(shapes)} frames of {shapes[0]}", flush=True)


def cli_launch(dev, zip_path, tmp):
    """Phase 18 (g): `python -m stylegan_v_tpu_torch.launch --allow-dirty --jobs 2`
    on phase 13's zip (job 1: 1 kimg, 21 steps; job 2 resumes at its end and
    takes one step), in a release dir whose code snapshot holds phase 2's
    kernel libraries, then batch_launch --print-only over
    configs/experiments.yaml."""
    import contextlib
    import io
    import os
    import shutil
    import yaml
    from stylegan_v_tpu_torch import batch_launch, launch

    tag = "[18 cli (g)]"
    run = os.path.join(tmp, "run_launch")
    # the release dir's code snapshot, made by launch's own copy, with the
    # libraries phase 2 built beside it: launch keeps a code snapshot it
    # finds, so the jobs load the kernels instead of building all eight again
    # (nvcc, about 40 s); their sources are the same, so are their names
    launch.snapshot_code(os.path.join(run, "code"))
    shutil.copytree(os.path.join(REPO, "stylegan_v_tpu_torch", "_build"),
                    os.path.join(run, "code", "stylegan_v_tpu_torch", "_build"),
                    ignore=shutil.ignore_patterns("*.lock", "*.tmp"))
    cmd = [sys.executable, "-m", "stylegan_v_tpu_torch.launch", f"dataset.path={zip_path}",
           *LAUNCH_ARGS, f"project_release_dir={run}", "--jobs", "2", "--allow-dirty",
           "--device", str(dev)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
    t_launch = time.perf_counter() - t0
    with open(os.path.join(tmp, "launch_output.txt"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    check(proc.returncode == 0 and "[launch] job 1 exited with 0" in proc.stdout
          and "[launch] job 2 exited with 0" in proc.stdout,
          f"{tag} launch failed ({proc.returncode}): {(proc.stdout + proc.stderr)[-3000:]}")
    sh = open(os.path.join(run, "training_cmd.sh")).read().splitlines()
    jobs = [line for line in sh if "-m stylegan_v_tpu_torch.train --cfg-path" in line]
    check(len(jobs) == 2 and jobs[1] == jobs[0] + " training.resume=latest",
          f"{tag} training_cmd.sh: {sh}")
    log = open(os.path.join(run, "log.txt")).read()
    snap = os.path.join(run, "network-snapshot-000001.pt")
    meta = json.load(open(os.path.join(run, "network-snapshot-000001.meta.json")))
    check(log.count("Resuming from") == 1 and f"Resuming from {snap}" in log
          and meta["cur_nimg"] == 22 * 16 * 3,
          f"{tag} job 2 did not resume job 1's snapshot: cur_nimg {meta['cur_nimg']}")

    sweep = yaml.safe_load(open(os.path.join(REPO, "configs", "experiments.yaml")))
    lines = 0
    for group, spec in sweep.items():
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            cmds = batch_launch.main(["--group", group, "--datasets", "ffs,sky_timelapse",
                                      "--print-only", "--device", str(dev)])
        got = printed.getvalue().strip().splitlines()
        check(len(cmds) == len(got) == 2 * len(spec["experiments"])
              and all(c[1:3] == ["-m", "stylegan_v_tpu_torch.launch"] for c in cmds),
              f"{tag} batch_launch --group {group}: {got}")
        lines += len(got)
    print(f"{tag} `python -m stylegan_v_tpu_torch.launch --allow-dirty --jobs 2` on phase 13's "
          f"zip in {t_launch:.1f} s: training_cmd.sh holds both jobs, job 2 resumed "
          f"network-snapshot-000001 (1008 frames) and ended at {meta['cur_nimg']}; "
          f"batch_launch --print-only over configs/experiments.yaml's {len(sweep)} groups x 2 "
          f"datasets: {lines} launch lines", flush=True)


def phase_cli(dev, smi, zip_path, tmp, pkl, gen_rate, k1_pass, k1_bwd_pass):
    """Phase 18: the remaining CLIs on phase 16's .pkl, (a)-(g), each CLI with
    its own TF32 default (off), (b) and (c) with TF32 off. Returns (b)'s K1
    and K1-bwd records (phase_kernel's) at the pyramid's shapes, and (a)'s
    K1 and K1-bwd launches a projection step as counted."""
    import torch

    t_phase, parts = time.perf_counter(), {}
    probe = package_version("transformers")
    print(f"[18 cli] transformers on this machine: {probe} (phase 18 does not use it: "
          f"stand-ins take CLIP's place)", flush=True)
    steps = (("a", cli_project, (dev, smi, tmp, pkl)),
             ("b", cli_kernels, (dev, k1_pass, k1_bwd_pass)),
             ("c", cli_parity, (dev, tmp)),
             ("d", cli_edit, (dev, smi, tmp, pkl)),
             ("e", cli_export, (dev, smi, tmp, pkl, gen_rate)),
             ("f", cli_grid, (tmp,)),
             ("g", cli_launch, (dev, zip_path, tmp)))
    returned = {}
    for tag, fn, args in steps:
        t0 = time.perf_counter()
        returned[tag] = fn(*args)
        parts[tag] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print(f"[18 cli] the parts took " + ", ".join(f"({k}) {v:.1f} s" for k, v in parts.items())
          + f"; phase 18 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return returned["b"], returned["a"][1]


# ---------------------------------------------------------------- phase 19
# MoCoGAN over two ranks sharing the card over gloo (nccl refuses two ranks on
# one device): phase 17's slice, 16 videos x 16 frames a step globally in
# MOCO_ROUNDS rounds of MOCO_BATCH_GPU global videos, MOCO_RANK_VIDEOS a rank a
# round, spawned as phase 15's ranks are.
MOCO_RANK_VIDEOS = MOCO_BATCH_GPU // PAR_RANKS
MOCO_RANK_WARP = (MOCO_RANK_VIDEOS, 3 * MOCO_SHAPE[1], MOCO_SHAPE[2])   # [4, 48] at 256^2
MOCO_RANK_SEEDS = (31, 32, 33, 34)       # each step's draws: a generator seeded alike everywhere
# The video D's batch-norm all_reduces a rank issues in a step, derived from the
# code (models/mocogan.py:_BatchNorm3d, training/train_step.py): each of a
# round's Gmain, Dgen and Dreal D calls runs the video D forward, two
# all_reduces a batch norm (the sum, then the squared deviations around the
# global mean), and its backward, one for each; Dr1 runs the forward alone (R1
# differentiates the image logits only). The video D has five batch norms at
# 256^2 (bn1 ... bn5).
MOCO_NORMS = 5
MOCO_BN_COLLECTIVES = {r1: MOCO_ROUNDS * (3 * 2 * (2 * MOCO_NORMS) + (2 * MOCO_NORMS if r1 else 0))
                       for r1 in (False, True)}


def _moco_local(dev, world, D):
    """This rank's rows of the slice's global batch, and its plan."""
    import torch
    from stylegan_v_tpu_torch.parallel import distributed as tdist
    from stylegan_v_tpu_torch.tools import moco_memory
    B = MOCO_SHAPE[0]
    plan = tdist.row_plan(B, MOCO_ROUNDS, tdist.mbstd_group(D, MOCO_BATCH_GPU, world.size),
                          world.size, world.rank)
    batch = moco_memory.slice_batch(dev)
    return {k: v[torch.as_tensor(plan.batch, device=dev)] for k, v in batch.items()}, plan


def _moco_reference_step(dev, perturb: bool = False):
    """Step 1 of phase 19 in one process on the global batch (phase 17's step,
    deterministic kernels): Gmain's and Dmain's gradients and the stats; with
    `perturb`, from G's and D's weights scaled by (1 + 1e-7 N(0, 1))."""
    import torch
    from stylegan_v_tpu_torch.tools import moco_memory
    state, step = moco_memory.slice_step(moco_setup(), dev, augment_p=ADA_P)
    if perturb:
        g = torch.Generator(device=dev).manual_seed(99)
        with torch.no_grad():
            for p in list(state.G.parameters()) + list(state.D.parameters()):
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g, device=dev))
    grads = _capture_grads(state)
    with deterministic():
        _, stats = step(state, moco_memory.slice_batch(dev),
                        generator=torch.Generator(device=dev).manual_seed(MOCO_RANK_SEEDS[0]),
                        do_dr1=MOCO_PAR_PLAN[0])
    return grads, {k: float(v) for k, v in stats.items()}


def moco_reference(dev, tmp):
    """Phase 19 (a)'s yardstick: the one-process step on the global batch, step
    1's Gmain and Dmain gradients and stats, saved for the ranks, and the noise
    floor of those gradients (phase 15's, PAR_FLOOR_FACTOR)."""
    import os
    import torch
    grads, stats = _moco_reference_step(dev)
    torch.cuda.empty_cache()
    floor = grad_errors(_moco_reference_step(dev, perturb=True)[0], grads)
    torch.save({"G": grads["G"], "D": grads["D"], "stats": stats},
               os.path.join(tmp, "moco_reference.pt"))
    torch.cuda.empty_cache()
    return floor, stats


def _bn_collectives_ms(shapes, world, dev, repeats: int = 3) -> float:
    """The ms of one step's video D batch-norm all_reduces alone: the recorded
    tensor shapes, all_reduce_sum'd in turn, after a synchronize."""
    import torch
    from stylegan_v_tpu_torch.parallel import distributed as tdist
    xs = [torch.ones(s, device=dev) for s in shapes]
    for x in xs[:4]:
        tdist.all_reduce_sum(x, world)                 # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        for x in xs:
            tdist.all_reduce_sum(x, world)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / repeats * 1e3


def moco_rank(rank, world_size, init_method, tmp, device):
    """Phase 19 (a)-(c) on one rank (spawned): two steps of the slice (R1
    first) against the one-process gradients, launches and batch-norm
    all_reduces per step, times, the consistency check, then ZeRO-1 on the
    first two steps. Writes its findings as JSON."""
    import json as _json
    import os
    import torch
    import torch.distributed as dist
    from stylegan_v_tpu_torch.models.discriminator import DiscriminatorBlock
    from stylegan_v_tpu_torch.parallel import distributed as tdist
    from stylegan_v_tpu_torch.parallel.zero import opt_state_bytes_per_device
    from stylegan_v_tpu_torch.tools import moco_memory
    from stylegan_v_tpu_torch.utils.summary import (check_replica_consistency,
                                                    train_state_tree, tree_content_hash)

    tag = f"[19 moco-ranks] rank {rank}"
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")   # cuBLAS repeats too
    dev = torch.device(device)
    world = tdist.init_distributed("gloo", rank, world_size, init_method, dev, timeout_s=300)
    det = deterministic()      # ZeRO-1's run repeats the plain run to the bit
    det.__enter__()
    try:
        kernels = _kernels()
        out = {"rank": rank}
        digests = {}
        shapes, skips = [], {}
        forward = tdist._AllReduceSum.forward

        def recording(ctx, x):          # the batch norms' all_reduce shapes, nothing else
            shapes.append(tuple(x.shape))
            return forward(ctx, x)

        def skip_input(module, args):   # the first input each skip takes; args unchanged
            skips.setdefault(module, (tuple(args[0].shape), str(args[0].dtype).split(".")[-1]))

        for zero1 in (False, True):
            setup = moco_memory.slice_setup(MOCO_BATCH_GPU, [f"training.zero1={zero1}"])
            state, step = moco_memory.slice_step(setup, dev, augment_p=ADA_P)
            local, plan = _moco_local(dev, world, state.D)
            grads = _capture_grads(state)
            hooks = [] if zero1 else [
                m.skip.register_forward_pre_hook(skip_input)
                for m in state.D.image_discr.modules()
                if isinstance(m, DiscriminatorBlock) and hasattr(m, "skip")]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            launches, collectives, ms, step1_stats = [], [], [], None
            # ZeRO-1 runs the first two steps, and is held to the plain state after them
            r1_plan = MOCO_PAR_PLAN[:2] if zero1 else MOCO_PAR_PLAN
            for i, (do_dr1, seed) in enumerate(zip(r1_plan, MOCO_RANK_SEEDS)):
                for k in kernels:
                    k.launches = 0
                tdist.all_reduce_sum.calls = 0
                if i == 1 and not zero1:
                    tdist._AllReduceSum.forward = staticmethod(recording)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    state, stats = step(state, local, do_dr1=do_dr1,
                                        generator=torch.Generator(device=dev).manual_seed(seed))
                    torch.cuda.synchronize()
                finally:
                    tdist._AllReduceSum.forward = staticmethod(forward)
                ms.append((time.perf_counter() - t0) * 1e3)
                launches.append([k.launches for k in kernels])
                collectives.append(tdist.all_reduce_sum.calls)
                step1_stats = step1_stats or {k: float(v) for k, v in stats.items()}
                bad = [k for k, v in stats.items() if not bool(torch.isfinite(v).all())]
                check(not bad, f"{tag}: non-finite stats {bad}")
                check({"Loss/G/loss_video", "Loss/scores/fake_video",
                       "Loss/scores/real_video"} <= set(stats), f"{tag}: stats {sorted(stats)}")
                if i == 1:
                    digests[zero1] = tree_content_hash({"G": state.G.state_dict(),
                                                        "D": state.D.state_dict(),
                                                        "G_ema": state.G_ema.state_dict()})
            for h in hooks:
                h.remove()
            name = "zero1" if zero1 else "plain"
            bad = [n for m in (state.G, state.D, state.G_ema)
                   for n, p in m.named_parameters() if not bool(torch.isfinite(p).all())]
            check(not bad, f"{tag} ({name}): non-finite parameters {bad[:5]}")
            check_replica_consistency(train_state_tree(state), world)
            p_all = [None] * world.size
            dist.all_gather_object(p_all, float(state.augment_p))
            out[name] = {"ms": ms, "launches": launches, "collectives": collectives,
                         "augment_p": p_all, "step1_stats": step1_stats,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "opt_bytes": opt_state_bytes_per_device(state),
                         "lrs": [g["lr"] for g in state.opt_D.param_groups],
                         "losses": {k: float(v) for k, v in stats.items()}}
            if not zero1:
                out["grad_err"] = grad_errors(
                    grads, torch.load(os.path.join(tmp, "moco_reference.pt")))
                out["skips"] = list(skips.values())
                out["rows"] = plan.rows.tolist()
                # a step's collectives alone: the flat gradient all-reduce of each
                # network, and the batch norms' all_reduces of a step without R1
                flat = {n: [p.detach().clone() for p in m.parameters()]
                        for n, m in (("G", state.G), ("D", state.D))}
                ar = {}
                for n, ts in flat.items():
                    tdist.all_reduce_mean_(ts, world)        # warm
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(3):
                        tdist.all_reduce_mean_(ts, world)
                    torch.cuda.synchronize()
                    ar[n] = (time.perf_counter() - t0) / 3 * 1e3
                out["allreduce_ms"] = ar
                out["allreduce_bytes"] = {n: 4 * sum(t.numel() for t in ts)
                                          for n, ts in flat.items()}
                out["bn_shapes"] = shapes
                out["bn_ms"] = _bn_collectives_ms(shapes, world, dev)
                del flat
            del state, step, grads
            torch.cuda.empty_cache()
        out["zero1_equal"] = digests[False] == digests[True]
        with open(os.path.join(tmp, f"moco_rank{rank}.json"), "w") as f:
            _json.dump(out, f)
    finally:
        det.__exit__()
        tdist.destroy_distributed()


def moco_ranks_steps(dev, smi, tmp):
    """Phase 19 (a)-(c) and their part of (f): (a) the slice's step over two
    ranks sharing the card, 4 videos a rank a round, two steps (R1 first)
    with deterministic kernels; step 1's all-reduced Gmain and Dmain
    gradients against the one-process step's on the same global batch and
    draws (phase 17's step) within PAR_FLOOR_FACTOR times their noise floor,
    everything finite, augment_p equal on both ranks, the ranks' state (the
    video D's and D's Adam groups' lr included) consistent; (b) each rank's
    K1 / K1-bwd / K4 / K4-bwd / K2 launches per step against phase 17's and its
    batch-norm all_reduces against MOCO_BN_COLLECTIVES; (c) ZeRO-1 on the
    first two steps, equal to (a)'s state after them to the bit; (f) the
    two-rank times (one card: not a scaling number), the gradient
    all-reduce's ms, the batch-norm all_reduces' ms, peak memory per rank.
    Returns the ranks' findings and the gradient check, which the phase
    makes last."""
    import json as _json
    import os
    from stylegan_v_tpu_torch.parallel import distributed as tdist

    tag = "[19 moco-ranks]"
    t0 = time.perf_counter()
    floor, ref_stats = moco_reference(dev, tmp)
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    tdist.launch(moco_rank, PAR_RANKS, args=(tmp, str(dev)))
    t_ranks = time.perf_counter() - t0
    ranks = [_json.load(open(os.path.join(tmp, f"moco_rank{r}.json"))) for r in range(PAR_RANKS)]
    lr = ranks[0]["plain"]["lrs"][0]
    for r in ranks:
        for name in ("plain", "zero1"):
            p = r[name]["augment_p"]
            check(len(set(p)) == 1, f"{tag} augment_p differs across ranks: {p}")
            check(r[name]["lrs"] == [lr, lr * 0.1], f"{tag} rank {r['rank']} ({name}): D's "
                                                    f"Adam groups {r[name]['lrs']}")
            for do_dr1, got, bn in zip(MOCO_PAR_PLAN, r[name]["launches"],
                                       r[name]["collectives"]):
                check(tuple(got) == MOCO_LAUNCHES_PER_STEP[do_dr1],
                      f"{tag} rank {r['rank']} ({name}) launched K1, K1-bwd, K4, K4-bwd, K2 {got} "
                      f"in a step with R1={do_dr1}, expected phase 17's "
                      f"{MOCO_LAUNCHES_PER_STEP[do_dr1]}")
                check(bn == MOCO_BN_COLLECTIVES[do_dr1],
                      f"{tag} rank {r['rank']} ({name}) issued {bn} batch-norm all_reduces in a "
                      f"step with R1={do_dr1}, derived {MOCO_BN_COLLECTIVES[do_dr1]}")
        check(r["zero1_equal"], f"{tag} rank {r['rank']}: ZeRO-1's parameters differ from "
                                "plain Adam's")
        check(len(r["bn_shapes"]) == MOCO_BN_COLLECTIVES[False],
              f"{tag} rank {r['rank']}: {len(r['bn_shapes'])} recorded batch-norm all_reduces")
        check(all(n == MOCO_RANK_VIDEOS * MOCO_SHAPE[1] for (n, *_), _ in r["skips"])
              and len(r["skips"]) == len(ranks[0]["skips"]),
              f"{tag} rank {r['rank']}: the image D's skip inputs {r['skips']}")
    r0 = ranks[0]
    print(f"{tag} (a) two ranks on {dev} over gloo, phase 17's slice {MOCO_SHAPE[0]}x"
          f"{MOCO_SHAPE[1]} at {MOCO_SHAPE[2]}^2 global in {MOCO_ROUNDS} rounds of "
          f"{MOCO_BATCH_GPU} videos ({MOCO_RANK_VIDEOS} a rank, rows {[r['rows'] for r in ranks]}"
          f"): step 1's Gmain / Dmain gradients against the one-process step: "
          + ", ".join(f"rank {r['rank']} " + ", ".join(
              f"{n} {l2:.3g} of its L2 norm, largest element {e:.3g} (scale {s:.3g})"
              for n, (e, s, l2) in r["grad_err"].items()) for r in ranks)
          + "; the floor (one process, weights x (1 + 1e-7 N)): " + ", ".join(
              f"{n} {l2:.3g} of its L2 norm, largest element {e:.3g}"
              for n, (e, s, l2) in floor.items())
          + f"; step 1's stats, largest difference from the one-process step's: "
          + ", ".join(f"{k} {abs(v - ref_stats[k]):.3g}"
                      for k, v in r0['plain']['step1_stats'].items())
          + f"; augment_p {r0['plain']['augment_p']}; D's Adam groups lr {r0['plain']['lrs']}; "
          f"losses on rank 0 after the steps {r0['plain']['losses']}; consistency check "
          f"passed", flush=True)
    print(f"{tag} (b) K1, K1-bwd, K4, K4-bwd, K2 launches per step on each rank (R1 "
          f"{list(MOCO_PAR_PLAN)}): " + "; ".join(f"rank {r['rank']} {r['plain']['launches']}"
                                                  for r in ranks)
          + f" (phase 17's {MOCO_LAUNCHES_PER_STEP[False]}, {MOCO_LAUNCHES_PER_STEP[True]}); "
          f"batch-norm all_reduces per step " + "; ".join(
              f"rank {r['rank']} {r['plain']['collectives']}" for r in ranks)
          + f" (derived {MOCO_BN_COLLECTIVES[False]} without R1, {MOCO_BN_COLLECTIVES[True]} "
          f"with), [C]-sized: {sorted(set(tuple(s) for s in r0['bn_shapes']))}", flush=True)
    print(f"{tag} (c) ZeRO-1 after two steps equal to (a) after two to the bit; optimizer "
          f"state per rank " + ", ".join(
              f"rank {r['rank']} {r['zero1']['opt_bytes'] / 2**20:.1f} MiB (plain Adam "
              f"{r['plain']['opt_bytes'] / 2**20:.1f} MiB)" for r in ranks), flush=True)
    for r in ranks:
        ms, ar = r["plain"]["ms"], r["allreduce_ms"]
        print(f"{tag} (f) rank {r['rank']}: {ms[1]:.1f} ms/step without R1, {ms[0]:.1f} with "
              f"R1 (the first step; ZeRO-1's two steps "
              f"{r['zero1']['ms'][0]:.1f}, {r['zero1']['ms'][1]:.1f}); two ranks share one "
              f"card, so this is not a scaling number; the gradient all-reduce {ar['G']:.2f} ms "
              f"for G ({r['allreduce_bytes']['G'] / 2**20:.1f} MiB), {ar['D']:.2f} ms for D "
              f"({r['allreduce_bytes']['D'] / 2**20:.1f} MiB): {ar['G'] + ar['D']:.2f} ms a "
              f"step without R1, {ar['G'] + 2 * ar['D']:.2f} with; the batch norms' "
              f"{len(r['bn_shapes'])} all_reduces of a step without R1 alone "
              f"{r['bn_ms']:.2f} ms; peak {r['plain']['peak_gib']:.2f} GiB (ZeRO-1 "
              f"{r['zero1']['peak_gib']:.2f}); on {smi}", flush=True)
    print(f"{tag} (a)-(c) took {t_ranks:.1f} s with the spawn, the one-process yardstick "
          f"{t_ref:.1f} s", flush=True)

    def grads_within_the_floor():
        for r in ranks:
            for name, (err, scale, l2) in r["grad_err"].items():
                check(l2 <= PAR_FLOOR_FACTOR * floor[name][2],
                      f"{tag} rank {r['rank']}: step 1's {name} gradient differs from the "
                      f"one-process step by {l2:.3g} of its L2 norm > {PAR_FLOOR_FACTOR} x the "
                      f"floor {floor[name][2]:.3g} (largest element {err:.3g}, scale {scale:.3g})")
    return ranks, grads_within_the_floor


def moco_ranks_loop(dev, zip_path, tmp):
    """Phase 19 (d): the loop through the entry point's spawn path, model=
    mocogan over two ranks on `dev` over gloo, phase 17's overrides, on phase
    13's zip: resumed from phase 17 (d)'s last snapshot (step 8, 2048 frames,
    past the run's 1 kimg), one step and a snapshot, then resume=latest for
    one more step and a snapshot; only rank 0 writes; the snapshots' D Adam
    groups 1x and 0.1x, and both ranks' groups equal (the consistency check
    before each snapshot hashes them)."""
    import contextlib
    import io
    import json as _json
    import math
    import os
    from stylegan_v_tpu_torch import train as entry
    from stylegan_v_tpu_torch.io.checkpoint import load_snapshot
    from stylegan_v_tpu_torch.tools import moco_memory

    tag = "[19 moco-ranks (d)]"
    run = os.path.join(tmp, "run_moco_ranks")
    start = os.path.join(tmp, "run_moco", "network-snapshot-000002.pt")   # phase 17 (d)'s
    base = [f"dataset.path={zip_path}"] + moco_memory.OVERRIDES + [
        f"training.batch_gpu={MOCO_BATCH_GPU}", "num_gpus=2", "training.kimg=1",
        "training.kimg_per_tick=0.5", "training.snap=2", "training.metrics=[]",
        f"project_release_dir={run}", "--device", str(dev), "--dist-backend", "gloo"]
    t_runs, lrs = [], []
    sys.stdout.flush()
    saved = os.dup(1)            # the ranks' stdout (inherited) goes to a file
    try:
        with open(os.path.join(tmp, "moco_ranks_stdout.txt"), "w") as f:
            os.dup2(f.fileno(), 1)
            for extra in ([f"training.resume={start}"], ["training.resume=latest"]):
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    entry.main(base + extra)
                t_runs.append(time.perf_counter() - t0)
                payload, meta = load_snapshot(os.path.join(run, "network-snapshot-000002.pt"))
                lrs.append(([g["lr"] for g in payload["opt_D"]["param_groups"]],
                            payload["step"], meta["cur_nimg"]))
    finally:
        os.dup2(saved, 1)
        os.close(saved)
    log = open(os.path.join(run, "log.txt")).read()
    rows = [_json.loads(line) for line in open(os.path.join(run, "stats.jsonl"))]
    ticks = [line for line in log.splitlines() if line.startswith("tick ")]
    check([(s, n) for _, s, n in lrs] == [(9, 2304), (10, 2560)],
          f"{tag} snapshots at (step, frames) {[(s, n) for _, s, n in lrs]}")
    check(all(len(g) == 2 and g[1] == g[0] * 0.1 for g, _, _ in lrs),
          f"{tag} the snapshots' D Adam groups {[g for g, _, _ in lrs]}")
    check(f"Resuming from {start}" in log
          and f"Resuming from {os.path.join(run, 'network-snapshot-000002.pt')}" in log
          and "2 ranks (gloo), 8 videos a rank a step" in log
          and len(rows) == len(ticks) == 2,
          f"{tag} {len(rows)} stats rows for {len(ticks)} ticks; the log: {log[-2000:]}")
    for k in ("Loss/G/loss_video", "Loss/scores/fake_video", "Loss/scores/real_video"):
        # a value a step from each rank: ticks of one step each
        check([row[k]["num"] for row in rows] == [2, 2], f"{tag} {k} in the stats rows {rows}")
    for row in rows:
        check(all(math.isfinite(v["mean"]) for k, v in row.items() if k != "timestamp"),
              f"{tag} a non-finite stat in {row}")
    print(f"{tag} `python -m stylegan_v_tpu_torch.train` model=mocogan num_gpus=2 --device "
          f"{dev} --dist-backend gloo on phase 13's zip, batch_gpu {MOCO_BATCH_GPU}: resumed "
          f"from phase 17 (d)'s snapshot 000002, a step and a snapshot, then resume=latest "
          f"for one step and a snapshot; the "
          f"snapshots' D Adam groups lr {[g for g, _, _ in lrs]}, equal on both ranks "
          f"(consistency check); one stats row a tick ({len(rows)}, both logit streams from both "
          f"ranks); in {t_runs[0]:.1f} and {t_runs[1]:.1f} s with their spawns; the log's "
          f"ticks: {[' '.join(t.split()[:8]) for t in ticks]}", flush=True)


def phase_moco_ranks(dev, smi, zip_path, tmp):
    """Phase 19: MoCoGAN over two ranks at FFS-256, (a)-(f); the gradient check
    of (a) last. Returns each kernel's launches per rank per step without and
    with R1 as measured on rank 0 ((b): both ranks were checked), and (e)'s
    records: K1's and K1-bwd's (phase_kernel's) at one rank's image D skips,
    K4's and K4-bwd's (phase_warp's) at one rank's 48-channel warp."""
    import torch
    from stylegan_v_tpu_torch.ops import (downfirdn2d_x2, downfirdn2d_x2_bwd,
                                          downfirdn2d_x2_bwd_plain, downfirdn2d_x2_plain)
    from stylegan_v_tpu_torch.utils.misc import float32_precision

    t_phase, parts = time.perf_counter(), {}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks, grads_within_the_floor = moco_ranks_steps(dev, smi, tmp)  # the step's own TF32 default
    parts["a-c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moco_ranks_loop(dev, zip_path, tmp)                      # the loop's own TF32 default
    parts["d"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    skips = [(tuple(s), d) for s, d in ranks[0]["skips"]]
    sets = ((f"{MOCO_RANK_VIDEOS}x{MOCO_SHAPE[1]}", skips),)
    tag = "[19 moco-ranks (e)]"
    with float32_precision(False):
        k1 = phase_kernel(dev, f"{tag} K1", "down", downfirdn2d_x2, downfirdn2d_x2_plain, sets)
        torch.cuda.empty_cache()
        k1_bwd = phase_kernel(dev, f"{tag} K1-bwd", "up", downfirdn2d_x2_bwd,
                              downfirdn2d_x2_bwd_plain, sets)
        torch.cuda.empty_cache()
        k4, k4_bwd = phase_warp(dev, MOCO_RANK_WARP, upsamples=(2,), tag=tag, autograd=False)
    parts["e"] = time.perf_counter() - t0
    grads_within_the_floor()
    launches = {r1: tuple(ranks[0]["plain"]["launches"][MOCO_PAR_PLAN.index(r1)])
                for r1 in (False, True)}
    print(f"[19 moco-ranks] the parts took " + ", ".join(f"({k}) {v:.1f} s"
                                                         for k, v in parts.items())
          + f"; phase 19 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, k1, k1_bwd, k4, k4_bwd


# ---------------------------------------------------------------- phase 20

SHEAR_ODD = (12, 3, 67, 61)     # (a)'s small case: samples, channels, canvas, output size


def shear_bytes(kind, taps, shift, axis, x, y):
    """The bytes that K7 ("K7", the fused pass), K7-bwd ("K7-bwd") or K8
    ("K8") must move from x into y, with `taps` and `shift` their tables: the
    input elements that this call's tables read, once, and y once. K7 reads,
    for each line across the axis, the source elements behind the stage-1
    lines start .. start + out_len of that line's shift (the rest of stage 1
    is never shifted into the output); K8 the lines start .. start + out_len
    of each of its lines."""
    import torch
    C = x.shape[1]
    if kind == "K7":
        B, Lz = taps.i0.shape
        start = shift.start.long()[:, :, None]                   # [B, lines, 1]
        j = torch.arange(Lz, device=x.device)
        used = (j >= start) & (j <= start + y.shape[2 + axis])   # [B, lines, Lz]
        # one bin past the source for the lines not used
        seen = torch.zeros(B, start.shape[1], taps.in_len + 1, dtype=torch.bool, device=x.device)
        for i in (taps.i0, taps.i1):
            seen.scatter_(2, torch.where(used, i.long()[:, None, :], taps.in_len), True)
        read = int(seen[..., :taps.in_len].sum()) * C
        del used, seen
    elif kind == "K7-bwd":
        read = x.numel()
    else:
        L, n = x.shape[2 + axis], y.shape[2 + axis]
        start = shift.start.long()
        read = int(((start + n).clamp(max=L - 1) - start.clamp(min=0) + 1).clamp(min=0).sum()) * C
    return (read + y.numel()) * x.element_size()


def onehot_matrix(taps, C, dtype):
    """The JAX formulation's banded one-hot matrix S [N C, out, L] of taps, a
    copy a plane, in dtype: the library yardstick's operand."""
    import torch
    B, n = taps.i0.shape
    S = torch.zeros(B, n, taps.in_len, device=taps.i0.device)
    S.scatter_add_(2, taps.i0.long()[..., None], taps.w0[..., None])
    S.scatter_add_(2, taps.i1.long()[..., None], taps.w1[..., None])
    return S.to(dtype).repeat_interleave(C, dim=0)


def shift_grid(shift, axis, in_shape, out_len):
    """The grid [N, out_r, out_s, 2] on which F.grid_sample (bilinear, zeros,
    align_corners=True) computes K8 with `shift` from in_shape [N, C, R, S]
    to out_len along `axis`: each output reads position start + i + w1 of
    its line (w0 = 1 - w1 for the forward's tables and the adjoint's), at
    the line's own coordinate across it; float32, built in float64."""
    import torch
    from stylegan_v_tpu_torch.ops.shear_warp import ROWS
    R, S = in_shape[2:]
    dev = shift.start.device
    i = torch.arange(out_len, dtype=torch.float64, device=dev)
    pos = shift.start.double()[:, :, None] + shift.w1.double()[:, :, None] + i  # [N, lines, out]
    if axis == ROWS:                     # lines are the columns: x = s, y = pos
        y = pos.transpose(1, 2)
        x = torch.arange(S, dtype=torch.float64, device=dev).expand_as(y)
    else:                                # lines are the rows: x = pos, y = r
        x = pos
        y = torch.arange(R, dtype=torch.float64, device=dev)[:, None].expand_as(x)
    return torch.stack([2 * x / (S - 1) - 1, 2 * y / (R - 1) - 1], dim=-1).float()


def earlier_route(x, ps):
    """K7's library yardstick for the pass `ps` (a WarpPass) of x: the
    executor's earlier route in library calls, the rot90 select
    (torch.where), F.pad's reflect, torch.bmm of the banded one-hot matrix
    over the padded axis (a copy a plane, built before), and F.grid_sample
    (bilinear, zeros, align_corners=True) of the float32 intermediate on a
    grid of the shift's positions (built before; a bf16 grid cannot place a
    line past 256), cast back to x's dtype."""
    import torch
    import torch.nn.functional as F
    from stylegan_v_tpu_torch.ops.shear_warp import ROWS, rot90_select
    N, C, R, S = x.shape
    padded, m = ps.taps.padded(), ps.taps.origin[2]
    M = onehot_matrix(padded, C, x.dtype)
    z_shape = [N, C, padded.out_len, S] if ps.axis == ROWS else [N, C, R, padded.out_len]
    grid = shift_grid(ps.shift, ps.axis, z_shape, ps.out_len)

    def call():
        src = x if ps.rot is None else rot90_select(x, ps.rot)
        if ps.axis == ROWS:
            xp = F.pad(src, [0, 0, m, m], mode="reflect")
            z = torch.bmm(M, xp.view(N * C, padded.in_len, S))
        else:
            xp = F.pad(src, [m, m, 0, 0], mode="reflect")
            z = torch.bmm(xp.view(N * C, R, padded.in_len), M.transpose(1, 2))
        return F.grid_sample(z.view(z_shape).float(), grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True).to(x.dtype)
    return call


def bwd_direct(dz, taps, axis, rot):
    """A function that launches K7-bwd on dz straight through its C entry
    point into one output: the kernel's time without the wrapper's host
    path (the checks, the output's allocation). It counts no launch."""
    import torch
    from stylegan_v_tpu_torch.ops import cuda_build, shear_warp
    fn = cuda_build.entry_point("shear_resample_bwd", shear_warp._ARGTYPES["shear_resample_bwd"])
    dx = torch.empty(shear_warp._stage_shape(dz, axis, taps.in_len), dtype=dz.dtype,
                     device=dz.device)
    N, C, R, S = dz.shape
    args = (dz.data_ptr(), dx.data_ptr(), *(t.data_ptr() for t in taps.tables),
            0 if rot is None else rot.data_ptr(), cuda_build.DTYPE_CODES[dz.dtype], axis, N * C,
            C, R, S, *dx.shape[2:])

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"K7-bwd's direct launch failed with CUDA error {err}")
        return dx
    return call


def shear_record(pas, kind, shape, fns, moved, flops, library_call=None, direct=None):
    """CUDA-event times in turns of fns (plain, kernel[, library]) and the
    row of one call; `direct`, the kernel launched through its C entry
    point, is timed too (`kernel_ms`)."""
    fns = list(fns) + ([direct] if direct else [])
    for fn in fns:                                  # warm-up
        fn()
    plain_t, kern, *rest = in_turns(fns, 10)
    lib = rest[0] if library_call else None
    bound, by = bound_ms(moved, flops)
    row = dict(name=f"{kind} pass {pas}", shape=list(shape), ms=kern, plain_ms=plain_t,
               library_ms=lib, library_call=library_call,
               bound_ms=bound, bound_by=by, gb_per_s=moved / (kern * 1e-3) / 1e9,
               share_of_bound=bound / kern)
    if direct:
        row.update(kernel_ms=rest[-1], kernel_share_of_bound=bound / rest[-1])
    return row


SHEAR_KINDS = ("K7", "K7-bwd", "K8", "K8 adjoint")   # the rows of shear_kernels, a pass each


def shear_kernels(dev, G_bgc):
    """(a): K7 (the fused pass), K7-bwd and K8 (forward and adjoint) against
    their plain versions at both passes of the step's canvas ([16, 9, 536^2]
    -> 524^2, the bgc maps of the pipe and branch_maps) and of SHEAR_ODD
    (branch_maps), float32 and bf16: K7 and K8 equal to them to the bit,
    K7-bwd (with pass V's rot, its plain version then _rot90_back) within
    KERNEL_TOL (its sums' order); each called twice, equal to the bit; at
    the canvas with the bgc maps in bf16, CUDA-event times of each call, its
    plain version and its library call (K7: earlier_route; K7-bwd: torch.bmm
    of the transposed one-hot matrix, then in pass V _rot90_back, the same
    function; K8 and its adjoint:
    F.grid_sample on shift_grid, on a float32 copy of the input, since
    grid_sample takes its grid in the input's dtype and a bf16 grid cannot
    place a line past 256), each checked against the kernel, with the bound
    of the bytes this call's tables read. K7-bwd's `ms` is its wrapper as the
    step calls it, with rot in pass V, on a fresh LineTaps (nothing prepared
    before: its blocks build their lists from the taps); its `kernel_ms` the
    kernel launched through its C entry point (bwd_direct). Returns each
    kernel's worst error, the sums of each of SHEAR_KINDS over the two
    passes and the rows."""
    import torch
    import torch.nn.functional as F
    from stylegan_v_tpu_torch.ops import (shear_pass, shear_pass_plain, shear_resample_bwd,
                                          shear_resample_bwd_plain, shear_shift,
                                          shear_shift_plain)
    from stylegan_v_tpu_torch.ops.shear_warp import (ROWS, LineTaps, _rot90_back, branch_maps,
                                                     shear_plan, warp_passes)

    g = torch.Generator(device=dev).manual_seed(20)
    N, C, H, out = G_bgc.shape[0], WARP_BATCH[1], 2 * (WARP_BATCH[2] + 12), 2 * (WARP_BATCH[2] + 6)
    cases = [("canvas", (N, C, H, out), {"bgc": G_bgc, "edges": branch_maps(N, dev)}),
             ("odd", SHEAR_ODD, {"edges": branch_maps(SHEAR_ODD[0], dev)})]
    worst = {"K7": 0.0, "K7-bwd": 0.0, "K8": 0.0}
    equal = {k: [0, 0] for k in worst}          # calls equal to the plain version to the bit
    rows = []
    for case, (N, C, H, out), sets in cases:
        for set_name, G in sets.items():
            plan = shear_plan(G, H, H, out, out)
            rot = int(plan.rot.sum())
            check(set_name == "bgc" or 0 < rot < N,
                  f"[20 shear] {case} {set_name}: {rot} of {N} samples take the rot90 branch")
            for dtype_name in ("float32", "bfloat16"):
                dtype, tol = getattr(torch, dtype_name), KERNEL_TOL[dtype_name]
                for ps in warp_passes(plan, N, C, H, out):
                    pas, taps, shift, axis = ps.name, ps.taps, ps.shift, ps.axis
                    Lz = taps.out_len
                    adj = shift.adjoint()
                    x = torch.randn(ps.shape, generator=g, device=dev).to(dtype)
                    y = shear_pass(x, taps, shift, axis, out, ps.rot)
                    z_shape = list(y.shape)
                    z_shape[2 + axis] = Lz
                    zin = torch.randn(z_shape, generator=g, device=dev).to(dtype)
                    z = shear_shift(zin, shift, axis, out)
                    dy = torch.randn(y.shape, generator=g, device=dev).to(dtype)
                    dy_z = shear_shift(dy, adj, axis, Lz)
                    dx = shear_resample_bwd(zin, taps, axis, ps.rot)

                    def bwd_plain():
                        dx = shear_resample_bwd_plain(zin, taps, axis)
                        return dx if ps.rot is None else _rot90_back(dx, ps.rot)
                    for name, got, want in (
                            ("K7", y, shear_pass_plain(x, taps, shift, axis, out, ps.rot)),
                            ("K7-bwd", dx, bwd_plain()),
                            ("K8", z, shear_shift_plain(zin, shift, axis, out)),
                            ("K8", dy_z, shear_shift_plain(dy, adj, axis, Lz))):
                        torch.cuda.synchronize()
                        e = (got.float() - want.float()).abs().max().item()
                        same = torch.equal(got, want)
                        check(got.shape == want.shape
                              and torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
                              and (same or name == "K7-bwd"),
                              f"[20 shear] {name} vs plain, {case} {set_name} pass {pas} "
                              f"{list(ps.shape)} {dtype_name}: max err {e}, equal to the bit "
                              f"{same}")
                        worst[name] = max(worst[name], e)
                        equal[name][0] += same
                        equal[name][1] += 1
                    check(torch.equal(shear_pass(x, taps, shift, axis, out, ps.rot), y)
                          and torch.equal(shear_resample_bwd(zin, taps, axis, ps.rot), dx)
                          and torch.equal(shear_shift(zin, shift, axis, out), z)
                          and torch.equal(shear_shift(dy, adj, axis, Lz), dy_z),
                          f"[20 shear] K7, K7-bwd or K8 {case} {set_name} pass {pas} "
                          f"{dtype_name}: two calls differ")
                    if (case, set_name, dtype) != ("canvas", "bgc", torch.bfloat16):
                        continue
                    S = onehot_matrix(taps, C, dtype)
                    P, other = N * C, x.shape[3 - axis]
                    if axis == ROWS:
                        lib_bwd = lambda: _rot90_back(torch.bmm(                    # noqa: E731
                            S.transpose(1, 2), zin.view(P, Lz, other)).view(dx.shape), ps.rot)
                    else:
                        lib_bwd = lambda: torch.bmm(zin.view(P, other, Lz), S)      # noqa: E731
                    route = earlier_route(x, ps)
                    # K8's: grid_sample on float32 copies (module docstring of shear_kernels)
                    z32, dy32 = zin.float(), dy.float()
                    grid = shift_grid(shift, axis, zin.shape, out)
                    grid_adj = shift_grid(adj, axis, dy.shape, Lz)
                    lib_k8 = lambda: F.grid_sample(z32, grid, mode="bilinear",      # noqa: E731
                                                   padding_mode="zeros", align_corners=True)
                    lib_k8_adj = lambda: F.grid_sample(dy32, grid_adj,              # noqa: E731
                                                       mode="bilinear", padding_mode="zeros",
                                                       align_corners=True)
                    for name, fn, want in (("K7", route, y), ("K7-bwd", lib_bwd, dx),
                                           ("K8", lib_k8, z), ("K8 adjoint", lib_k8_adj, dy_z)):
                        e_lib = (fn().view(want.shape).float() - want.float()).abs().max().item()
                        check(e_lib <= tol * max(want.float().abs().max().item(), 1.0),
                              f"[20 shear] the library call of {name} pass {pas} differs from "
                              f"the kernel by {e_lib}")
                    bmm = "torch.bmm of the banded one-hot matrix, a copy a plane"
                    direct = bwd_direct(zin, taps, axis, ps.rot)
                    check(torch.equal(direct(), dx), f"[20 shear] K7-bwd pass {pas} through "
                                                     f"its C entry point differs from its wrapper")
                    gs = ("F.grid_sample(bilinear, zeros, align_corners=True) on the float32 "
                          "input, grid of the shift's positions built before")
                    rows += [
                        shear_record(pas, "K7", list(ps.shape), (
                            lambda: shear_pass_plain(x, taps, shift, axis, out, ps.rot),
                            lambda: shear_pass(x, taps, shift, axis, out, ps.rot), route),
                            shear_bytes("K7", taps, shift, axis, x, y),
                            3 * (zin.numel() + y.numel()),
                            "the earlier route: rot90 select, F.pad reflect, " + bmm
                            + " over the padded axis, then " + gs.replace("input", "stage 1")),
                        shear_record(pas, "K7-bwd", list(zin.shape), (
                            bwd_plain,
                            lambda: shear_resample_bwd(zin, LineTaps(
                                *taps.tables, taps.in_len, taps.origin), axis,
                                ps.rot),
                            lib_bwd),
                            shear_bytes("K7-bwd", taps, None, axis, zin, dx), 4 * zin.numel(),
                            f"{bmm}, transposed" + (", then the rot90 samples turned back "
                                                    "(_rot90_back)" if axis == ROWS else ""),
                            direct=direct),
                        shear_record(pas, "K8", list(zin.shape), (
                            lambda: shear_shift_plain(zin, shift, axis, out),
                            lambda: shear_shift(zin, shift, axis, out), lib_k8),
                            shear_bytes("K8", None, shift, axis, zin, z), 3 * z.numel(), gs),
                        shear_record(pas, "K8 adjoint", list(dy.shape), (
                            lambda: shear_shift_plain(dy, adj, axis, Lz),
                            lambda: shear_shift(dy, adj, axis, Lz), lib_k8_adj),
                            shear_bytes("K8", None, adj, axis, dy, dy_z), 3 * dy_z.numel(),
                            gs)]
                    del S, route, z32, dy32, grid, grid_adj, direct
                    torch.cuda.empty_cache()
    for r in rows:
        built = (f"; launched through its C entry point {r['kernel_ms']:.4f} ms "
                 f"({r['kernel_share_of_bound']:.1%})" if "kernel_ms" in r else "")
        print(f"[20 shear] (a) {r['name']} {r['shape']} bf16: kernel {r['ms']:.4f} ms "
              f"({r['gb_per_s']:.0f} GB/s, {r['share_of_bound']:.1%} of the {r['bound_ms']:.4f} "
              f"ms bound{built})  plain {r['plain_ms']:.4f} ms  library "
              f"{r['library_ms']:.4f} ms", flush=True)
    sums = {}
    for kind in SHEAR_KINDS:
        mine = [r for r in rows if r["name"].startswith(f"{kind} pass")]
        t = {k: sum(r[k] for r in mine) for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        if kind == "K7-bwd":
            t["kernel_ms"] = sum(r["kernel_ms"] for r in mine)
        t["bound_by"] = "bytes" if all(r["bound_by"] == "bytes" for r in mine) else "operations"
        sums[kind] = t
    slower = [r["name"] for r in rows if r["name"].startswith(("K7-bwd", "K8"))
              and not r["ms"] < r["library_ms"]]
    print(f"[20 shear] (a) max_abs_err vs plain (canvas bgc and edge maps, {SHEAR_ODD} edge "
          f"maps, float32 and bf16): " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + "; equal to the plain version to the bit: "
          + ", ".join(f"{k} {a} of {b}" for k, (a, b) in equal.items())
          + "; K7, K7-bwd and K8 repeat to the bit; one warp's two passes at the canvas in bf16: "
          + ", ".join(f"{k} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, library "
                      f"{t['library_ms']:.4f})" for k, t in sums.items())
          + f"; K7-bwd's and K8's calls not faster than their library calls: "
            f"{slower or 'none'}", flush=True)
    return worst, sums, rows


def shear_calls(dev):
    """The anti-aliased warp of the ADA pipe with warp_mode="shear" on the
    step's batch (WARP_BATCH, bgc draws at p = 1): its input and G_inv
    (_warp_antialiased's) and the G_inv of its shear warp on the canvas."""
    import torch
    from stylegan_v_tpu_torch.training import augment as taug

    (N, C, H), seen = WARP_BATCH, {}
    warp, shear = taug._warp_antialiased, taug.shear_affine_grid_sample

    def recorded(images, G_inv, *args, **kwargs):
        seen["pipe"] = (images.detach().clone(), G_inv.detach().clone())
        return warp(images, G_inv, *args, **kwargs)

    def recorded_shear(x, G_inv, out_h, out_w):
        seen["canvas"] = (tuple(x.shape), G_inv.detach().clone(), out_h, out_w)
        return shear(x, G_inv, out_h, out_w)

    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.rand(N, C, H, H, generator=g, device=dev) * 2 - 1
    taug._warp_antialiased, taug.shear_affine_grid_sample = recorded, recorded_shear
    try:
        pipe = taug.make_augment_pipe(taug.AugmentConfig(**taug.AUGPIPE_SPECS["bgc"],
                                                         warp_upsample=2, warp_mode="shear"))
        with torch.no_grad():
            pipe(g, x, torch.ones((), device=dev))
    finally:
        taug._warp_antialiased, taug.shear_affine_grid_sample = warp, shear
    big, out = 2 * (H + 12), 2 * (H + 6)
    check(seen["canvas"][0] == (N, C, big, big) and seen["canvas"][2:] == (out, out),
          f"[20 shear] the pipe's shear warp: {seen['canvas']}")
    return seen["pipe"], seen["canvas"][1]


def shear_whole_warp(dev, smi, images, G_inv):
    """(b): _warp_antialiased at the step's batch in bf16, shear against K4,
    forward and forward + backward, CUDA-event times in turns; each call's
    launches, how far the two executors' images lie apart (white noise in,
    the whole canvas), and one forward + backward of each under
    torch.profiler (tools/profile_split.py:profile: device time by class
    and the longest kernels)."""
    import torch
    from stylegan_v_tpu_torch.ops import setup_filter
    from stylegan_v_tpu_torch.tools.profile_split import profile
    from stylegan_v_tpu_torch.training import augment as taug

    Hz = setup_filter(taug._SYM6)
    g = torch.Generator(device=dev).manual_seed(21)
    x = images.detach().requires_grad_(True)

    def forward(mode):
        def call():
            with torch.no_grad():
                return taug._warp_antialiased(images, G_inv, Hz, 3, warp_mode=mode)
        return call

    dy = torch.randn(forward("gather")().shape, generator=g, device=dev)

    def both(mode):
        def call():
            taug._warp_antialiased(x, G_inv, Hz, 3, warp_mode=mode).backward(dy)
        return call

    kernels = _kernels()[2:4] + _shear_kernels()
    launched = {}
    for what, fn in (("shear fwd", forward("shear")), ("shear fwd+bwd", both("shear")),
                     ("K4 fwd", forward("gather")), ("K4 fwd+bwd", both("gather"))):
        before = [k.launches for k in kernels]
        fn()
        launched[what] = tuple(k.launches - b for k, b in zip(kernels, before))
    want = {"shear fwd": (0, 0, 2, 0, 0), "shear fwd+bwd": (0, 0, 2, 2, 2),
            "K4 fwd": (1, 0, 0, 0, 0), "K4 fwd+bwd": (1, 1, 0, 0, 0)}
    check(launched == want, f"[20 shear] (b) K4, K4-bwd, {SHEAR_KERNELS} launched {launched}, "
                            f"expected {want}")
    k4, sh = forward("gather")().float(), forward("shear")().float()
    d = k4 - sh
    peak = (k4.max() - k4.min()).item()
    psnr = 10 * torch.log10(peak ** 2 / d.square().mean()).item()
    fns = [forward("gather"), forward("shear"), both("gather"), both("shear")]
    for fn in fns:                                  # warm-up
        fn()
    k4_f, sh_f, k4_fb, sh_fb = in_turns(fns, 10)
    for what, fn in (("shear", both("shear")), ("K4", both("gather"))):
        total, window, split, top, _ = profile(fn)
        print(f"[20 shear] (b) one forward + backward under torch.profiler, {what}: kernels "
              f"{total:.4f} ms of a {window:.4f} ms window (idle share {1 - total / window:.3f}); "
              + ", ".join(f"{c} {ms:.4f}" for c, ms in sorted(split.items(), key=lambda kv: -kv[1]))
              + "; longest: " + ", ".join(f"{name[:60]} {ms:.4f}" for name, ms in top[:6]),
              flush=True)
    print(f"[20 shear] (b) the anti-aliased warp at {list(images.shape)} (bf16 geometry): "
          f"forward K4 {k4_f:.4f} ms, shear {sh_f:.4f} ms ({sh_f / k4_f:.2f}x); forward + "
          f"backward K4 {k4_fb:.4f} ms, shear {sh_fb:.4f} ms ({sh_fb / k4_fb:.2f}x); launches "
          f"(K4, K4-bwd, {SHEAR_KERNELS}) {launched}; shear vs K4 images: max abs diff "
          f"{d.abs().max().item():.4g}, PSNR {psnr:.2f} dB over a peak of {peak:.3g} (two "
          f"bilinear passes against one 2-D tap: not the same function); on {smi}", flush=True)
    return dict(forward_k4_ms=k4_f, forward_shear_ms=sh_f, fwd_bwd_k4_ms=k4_fb,
                fwd_bwd_shear_ms=sh_fb, psnr_db=psnr)


def phase_shear(dev, smi, G, D, k4_step):
    """Phase 20: the shear warp executor (warp_mode="shear"): (a) its kernels
    (shear_kernels), (b) the whole anti-aliased warp against K4
    (shear_whole_warp), (c) the FFS-256 ADA step with the shear pipe
    (phase_train, beside phase 11's K4 numbers `k4_step`) and (d) card vs CPU
    with it (phase_aug_parity). Phases 3-12 launched no shear kernel. Returns
    (a)'s numbers, the launches of (c)'s run, (b)'s and (c)'s numbers."""
    import torch
    from stylegan_v_tpu_torch.utils.misc import float32_precision

    import stylegan_v_tpu_torch.ops as ops
    ran = tuple(k.launches for k in _shear_kernels())
    check(ran == (0, 0, 0), f"[20 shear] {SHEAR_KERNELS} launched {ran} times before phase 20")
    check(not hasattr(ops, "shear_resample") and not hasattr(ops.shear_warp, "shear_resample"),
          "[20 shear] the port has a resample without its shift")
    t0 = time.perf_counter()
    with float32_precision(False):
        (images, G_pipe), G_canvas = shear_calls(dev)
        kernels = shear_kernels(dev, G_canvas)
        torch.cuda.empty_cache()
        whole = shear_whole_warp(dev, smi, images, G_pipe)
    del images
    torch.cuda.empty_cache()
    launches, step = phase_train(dev, smi, G, D, augment=True, warp_mode="shear", k4=k4_step)
    torch.cuda.empty_cache()
    with float32_precision(False):
        phase_aug_parity(dev, warp_mode="shear")
    print(f"[20 shear] done in {time.perf_counter() - t0:.1f} s; the port's 'auto' and "
          f"'gather' ran K4 (phases 10-12), 'shear' K7 (the fused pass), K7-bwd and K8, and "
          f"no resample without its shift", flush=True)
    return kernels, launches[5:], whole, step


# Phase 21: the quality demo's step. Per D pass K1 runs once a D block (its
# resnet skip) and K2 once (the filter before its down=2 conv); per synthesis
# K2 runs twice a block above 4^2 (k2_per_d, k2_per_synthesis). A step is
# two syntheses and one backward through one (3 x the synthesis's K2), three
# D passes and their backwards without R1 (Gmain, Dgen, Dreal), five with
# it, plus the ADA pipe's K4 and K4-bwd with 2 K2 each (as derived above
# ADA_LAUNCHES_PER_STEP). At 256^2 (12 K2 a synthesis, 6 D blocks) this is
# ADA_LAUNCHES_PER_STEP. The demo's setup, as the JAX demo's, keeps the
# default G_reg_interval=4 at pl_weight=0, so every 4th step also runs Gpl: a
# synthesis, its backward and the backward of that, 3 x the synthesis's K2
# more. At the demo's 64^2 (8 K2 a synthesis, 4 D blocks), by (Gpl, R1):
# (12, 12, 3, 1, 56), with Gpl (12, 12, 3, 1, 80), with both (20, 20, 5, 2, 102).
def ada_launches_per_step(k2_synthesis, d_blocks):
    return {False: (3 * d_blocks, 3 * d_blocks, 3, 1, 3 * k2_synthesis + 6 * d_blocks + 8),
            True: (5 * d_blocks, 5 * d_blocks, 5, 2, 3 * k2_synthesis + 10 * d_blocks + 14)}


def demo_launches_per_step(k2_synthesis, d_blocks):
    """{(do_gpl, do_dr1): the launches of K1, K1-bwd, K4, K4-bwd, K2 a step}."""
    per_r1 = ada_launches_per_step(k2_synthesis, d_blocks)
    return {(gpl, r1): per_r1[r1][:4] + (per_r1[r1][4] + (3 * k2_synthesis if gpl else 0),)
            for gpl in (False, True) for r1 in (False, True)}


DEMO_K2_PER_SYNTHESIS, DEMO_D_BLOCKS = 8, 4
DEMO_LAUNCHES_PER_STEP = demo_launches_per_step(DEMO_K2_PER_SYNTHESIS, DEMO_D_BLOCKS)
DEMO_ARGS = ["--videos", "32", "--kimg-per-tick", "0.48", "--total-kimg", "0.96",
             "--snap-ticks", "1", "--fvd-items", "16", "--workers", "3"]   # 2 ticks of 10 steps
DEMO_STEPS = 20
PROFILE_SHAPE = (4, 8, 2)        # (b): videos, frames, iterations at 256^2


def demo_steps(record):
    """Wrap training.loop.make_train_step so that every step the loop takes
    appends ((do_gpl, do_dr1), the kernels' launches in it) to `record`;
    returns the function that restores it."""
    from stylegan_v_tpu_torch.training import loop
    kernels, make = _kernels(), loop.make_train_step

    def wrapped_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def counted(state, batch, *, do_gpl, do_dr1, **kw):
            before = tuple(k.launches for k in kernels)
            out = step(state, batch, do_gpl=do_gpl, do_dr1=do_dr1, **kw)
            record.append(((do_gpl, do_dr1),
                           tuple(k.launches - b for k, b in zip(kernels, before))))
            return out
        return counted

    loop.make_train_step = wrapped_make
    return lambda: setattr(loop, "make_train_step", make)


def phase_demo(dev, smi, G, tmp):
    """Phase 21: (a) the quality demo in process for two ticks at 64^2 and
    (b) profile_model's harness on phase 5's G (`G`). The run goes in `tmp`,
    its metric cache in a HOME there."""
    import contextlib
    import hashlib
    import io
    import math
    import os
    import zipfile
    import torch
    from stylegan_v_tpu_torch import profile_model
    from stylegan_v_tpu_torch import train_fvd_demo as demo
    from stylegan_v_tpu_torch.metrics import metric_utils

    check(ada_launches_per_step(K2_PER_SYNTHESIS_256, 6) == ADA_LAUNCHES_PER_STEP,
          "[21 demo] the per-step derivation does not give phase 11's counts at 256^2")
    kernels = _kernels()
    registries = (metric_utils._custom_detectors, metric_utils._custom_detector_tags)
    registered = [dict(d) for d in registries]
    home = os.environ.get("HOME")
    os.environ["HOME"] = os.path.join(tmp, "home")                # the metric stats cache
    run, data = os.path.join(tmp, "demo"), os.path.join(tmp, "moving64.zip")
    steps, out = [], io.StringIO()
    restore = demo_steps(steps)
    t0 = time.perf_counter()
    try:
        for k in kernels:
            k.launches = 0
        with contextlib.redirect_stdout(out), SynthesisCalls() as syn:
            series = demo.main(["--outdir", run, "--data", data, "--device", str(dev)]
                               + DEMO_ARGS)
        torch.cuda.synchronize()
        counts = tuple(k.launches for k in kernels)
    finally:
        restore()
        for d, before in zip(registries, registered):
            d.clear()
            d.update(before)
        if home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = home
    seconds = time.perf_counter() - t0

    check(len(series) == 2 and all(math.isfinite(v) and v >= 0 for _, v in series),
          f"[21 demo] FVD rows {series}")
    variants = [variant for variant, _ in steps]
    check(variants == [(i % 4 == 0, i % 16 == 0) for i in range(DEMO_STEPS)],
          f"[21 demo] the steps' (Gpl, R1): {variants}")
    for i, (variant, got) in enumerate(steps):
        check(got == DEMO_LAUNCHES_PER_STEP[variant],
              f"[21 demo] step {i} (Gpl, R1) = {variant} launched {KERNELS} {got} times, "
              f"expected {DEMO_LAUNCHES_PER_STEP[variant]}")
    # the run: its steps' launches, and K2 for every synthesis outside them
    # (the activation summary, the snapshot grids, the FVD's clips). In a step
    # SynthesisCalls sees two forwards and a backward, and with Gpl one more
    # forward and its backward, but not the backward of that backward.
    in_steps = sum(DEMO_K2_PER_SYNTHESIS * (3 + 2 * gpl) for gpl, _ in variants)
    want = tuple(sum(DEMO_LAUNCHES_PER_STEP[v][j] for v in variants) for j in range(5))
    want = want[:4] + (want[4] + syn.k2 - in_steps,)
    check(counts == want, f"[21 demo] the run launched {KERNELS} {counts} times, expected {want}")
    last = [json.loads(line) for line in open(os.path.join(run, "stats.jsonl"))][-1]
    ms = last["Timing/Gmain_Dmain"]["mean"] * 1e3
    with zipfile.ZipFile(data) as zf:
        members = hashlib.sha256(b"".join(zf.read(n) for n in sorted(zf.namelist())))
    ticks = [line for line in out.getvalue().splitlines() if line.startswith("tick ")]
    print("\n".join(f"[21 demo] {line}" for line in ticks))
    print(f"[21 demo] (a) train_fvd_demo at 64^2, channel_base 8192, 16 videos x 3 frames, "
          f"bgc, gamma 1, {DEMO_STEPS} steps in 2 ticks, fvd2048_16f at 16 clips under the "
          f"demo's random I3D (seed 17): {[(n, float(f'{v:.6g}')) for n, v in series]}; "
          f"launches {KERNELS} a step {DEMO_LAUNCHES_PER_STEP[False, False]}, with Gpl (every "
          f"4th) {DEMO_LAUNCHES_PER_STEP[True, False]}, with Gpl and R1 (every 16th) "
          f"{DEMO_LAUNCHES_PER_STEP[True, True]} (every step asserted), the run {counts} "
          f"({syn.k2} K2 by G's syntheses); the last tick's Timing/Gmain_Dmain {ms:.2f} ms/step "
          f"(host, between dispatches, {last['Timing/Gmain_Dmain']['num']} steps); the zip's "
          f"members' sha256 {members.hexdigest()[:16]}; {seconds:.1f} s on {smi}", flush=True)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = profile_model.profile(G.eval(), [PROFILE_SHAPE[0]], PROFILE_SHAPE[1],
                                     PROFILE_SHAPE[2])
    print("\n".join(f"[21 demo] (b) {line}" for line in out.getvalue().splitlines()))
    check(len(rows) == 1 and rows[0]["frames_per_sec"] > 0 and rows[0]["peak_gib"] > 0,
          f"[21 demo] profile_model rows {rows}")
    print(f"[21 demo] (b) profile_model on phase 5's FFS-256 G: {rows[0]['frames_per_sec']:.1f} "
          f"frames/s at {PROFILE_SHAPE[0]} x {PROFILE_SHAPE[1]}, {PROFILE_SHAPE[2]} iterations, "
          f"peak {rows[0]['peak_gib']:.2f} GiB on {smi}", flush=True)


# ---------------------------------------------------------------- phase 22
# The quality and stability gates, each through its entry point's functions,
# run last, after phase 21 and in its temporary directory (its run and zip).
GATE_SEED = 5                    # (a): the stand-in detectors' weights
GATE_FVD_ITEMS = 16              # (b): max_real, num_gen of the stub-mode sweep
SHEAR_GATE_RES = (32, 64, 128, 256)   # (c): the validator's resolutions
SHEAR_GATE_ITERS = 5             # (c): timed calls of each direction
SOAK_ROUNDS = 2                  # (d): rounds of 15 main steps and one R1 step
DIAG_STEPS = 10                  # (e)


def gate_detectors(dev, smi, tmp):
    """(a): stand-ins for the three reference detector files
    (tools/standin_detectors.py: the port's modules with seeded weights,
    traced at the full fixture_inputs' shapes), validated by
    validate_detectors.main on the card against their TorchScript on the CPU
    at the full fixture_inputs: exit 0, every case within the gate, the
    fixtures file's schema; no K kernel launches."""
    import contextlib
    import io
    import os
    from stylegan_v_tpu_torch import validate_detectors as vd
    from stylegan_v_tpu_torch.metrics.metric_utils import DETECTOR_FILES
    from stylegan_v_tpu_torch.tools import standin_detectors as sd

    tag = "[22 gates (a)]"
    directory = os.path.join(tmp, "gate_detectors")
    os.makedirs(directory)
    t0 = time.perf_counter()
    for name in sd.NAMES:
        sd.write_standin(name, os.path.join(directory, DETECTOR_FILES[name]),
                         vd.fixture_inputs(name)[0][1], vd.CASE_TORCH_KWARGS[name][0],
                         seed=GATE_SEED)
    t_write = time.perf_counter() - t0
    out_path = os.path.join(tmp, "detector_fixtures.json")
    before = tuple(k.launches for k in _kernels())
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = vd.main(["--detector-dir", directory, "--out", out_path, "--device", str(dev)])
    t_gate = time.perf_counter() - t0
    print("\n".join(f"{tag} {line}" for line in out.getvalue().splitlines()), flush=True)
    check(rc == 0, f"{tag} validate_detectors exited {rc}")
    launched = tuple(k.launches - b for k, b in zip(_kernels(), before))
    check(launched == (0,) * 5, f"{tag} the detectors launched {KERNELS} {launched} times")
    fixtures = json.load(open(out_path))
    check(set(fixtures) == set(sd.NAMES), f"{tag} fixtures for {sorted(fixtures)}")
    worst = {}
    for name, rec in fixtures.items():
        labels = [label for label, _ in vd.fixture_inputs(name)]
        check(rec["ok"] is True and rec["input_seed"] == 0 and list(rec["cases"]) == labels,
              f"{tag} {name}: {rec}")
        for label, case in rec["cases"].items():
            check(case["ok"] and case["max_rel"] <= vd.MAX_REL
                  and case["mean_rel"] <= vd.MEAN_REL and len(case["want_sample"]) == 16,
                  f"{tag} {name} {label}: {case}")
        worst[name] = (max(c["max_rel"] for c in rec["cases"].values()),
                       max(c["mean_rel"] for c in rec["cases"].values()))
    print(f"{tag} validate_detectors on stand-ins for {', '.join(sd.NAMES)} at the full "
          f"fixture_inputs: the port on {dev} against the TorchScript on the CPU, worst (max_rel, "
          f"mean_rel) " + ", ".join(f"{n} ({a:.2e}, {b:.2e})" for n, (a, b) in worst.items())
          + f" within ({vd.MAX_REL:g}, {vd.MEAN_REL:g}); stand-ins written in {t_write:.1f} s, "
          f"the gate {t_gate:.1f} s; on {smi}", flush=True)


def gate_parity(dev, tmp):
    """(b): fvd_parity.main in stub mode over phase 21's snapshot and a copy
    of it with G_ema's parameters moved by 0.05 (phase 21's two ticks both
    fall in kimg 000000, so its run keeps one file; tests/test_fvd_parity.py
    makes its second checkpoint so), against a reference-format jsonl:
    exit 0 or 2, the report's fields, K2 12 a synthesis at 256^2 (8 at the
    demo's 64^2), nothing else launched."""
    import contextlib
    import io
    import math
    import os
    import shutil
    import torch
    from stylegan_v_tpu_torch import fvd_parity
    from stylegan_v_tpu_torch.io.checkpoint import load_snapshot, meta_decode
    from stylegan_v_tpu_torch.models import Generator

    tag = "[22 gates (b)]"
    run, data = os.path.join(tmp, "demo"), os.path.join(tmp, "moving64.zip")
    ckpts = os.path.join(tmp, "parity_ckpts")
    os.makedirs(ckpts)
    src = os.path.join(run, "network-snapshot-000000")
    for ext in (".pt", ".meta.json"):
        shutil.copy(src + ext, os.path.join(ckpts, "network-snapshot-000000" + ext))
    payload, meta = load_snapshot(src + ".pt")
    G = Generator(meta_decode(meta["configs"]["G"]))
    G.load_state_dict(payload["G_ema"])
    with torch.no_grad():
        for p in G.parameters():
            p.add_(0.05)
    payload["G_ema"] = G.state_dict()
    torch.save(payload, os.path.join(ckpts, "network-snapshot-000001.pt"))
    meta["cur_nimg"] = 1000
    json.dump(meta, open(os.path.join(ckpts, "network-snapshot-000001.meta.json"), "w"))
    ref = os.path.join(tmp, "metric-fvd2048_16f.jsonl")
    with open(ref, "w") as f:
        for snap, v in (("network-snapshot-000000.pkl", 120.0), ("network-snapshot-000001.pkl", 80.0)):
            f.write(json.dumps({"results": {"fvd2048_16f": v}, "metric": "fvd2048_16f",
                                "snapshot_pkl": snap}) + "\n")
    report_path = os.path.join(tmp, "fvd_parity.json")
    env = {"SGV_STUB_DETECTORS": "1", "HOME": os.path.join(tmp, "home_parity")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    kernels, out = _kernels(), io.StringIO()
    before = tuple(k.launches for k in kernels)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), SynthesisCalls() as syn:
            rc = fvd_parity.main(["--data", data, "--ckpts",
                                  os.path.join(ckpts, "network-snapshot-*"), "--ref-jsonl", ref,
                                  "--out", report_path, "--max-real", str(GATE_FVD_ITEMS),
                                  "--num-gen", str(GATE_FVD_ITEMS), "--device", str(dev)])
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    seconds = time.perf_counter() - t0
    launched = tuple(k.launches - b for k, b in zip(kernels, before))
    print("\n".join(f"{tag} {line}" for line in out.getvalue().splitlines()), flush=True)
    report = json.load(open(report_path))
    ra = report["rank_agreement"]
    check(rc in (0, 2) and report["parity"] == (rc == 0), f"{tag} fvd_parity exited {rc}")
    check(report["detector_gate"]["status"] == "stubbed"
          and set(report["ours"]) == {"000000", "000001"}
          and all(math.isfinite(v) for v in report["ours"].values())
          and ra["status"] == "ok" and ra["n"] == 2
          and {"spearman_rho", "kendall_tau", "best_ckpt_agrees", "pairs"} <= set(ra),
          f"{tag} the report {report}")
    check(syn.forwards > 0 and launched == (0, 0, 0, 0, syn.k2),
          f"{tag} launched {KERNELS} {launched} times, expected (0, 0, 0, 0, {syn.k2}) "
          f"({syn.forwards} syntheses)")
    print(f"{tag} fvd_parity in stub mode over phase 21's snapshot and a moved copy, "
          f"fvd2048_16f at {GATE_FVD_ITEMS} real / {GATE_FVD_ITEMS} generated clips: "
          f"{report['ours']}, rank agreement {ra['spearman_rho']} (best agrees "
          f"{ra['best_ckpt_agrees']}), exit {rc}; K2 {launched[4]} in {syn.forwards} "
          f"syntheses; {seconds:.1f} s", flush=True)


def gate_shear(dev, smi):
    """(c): validate_shear_onchip at SHEAR_GATE_RES, the JAX script's draws:
    PASS at every size (PSNR > 28 dB, finite outputs and gradient), each
    resolution's K7, K7-bwd, K8, K4 and K2 launches as derived."""
    from stylegan_v_tpu_torch import validate_shear_onchip as vs

    tag = "[22 gates (c)]"
    kernels = _kernels() + _shear_kernels()
    names = ("K1", "K1-bwd", "K4", "K4-bwd", "K2", "K7", "K7-bwd", "K8")
    # A shear warp's forward is 2 K7 (a pass each) and 2 K2 (the 12-tap 2x up
    # and down); its backward 2 K8, 2 K7-bwd (phase 20's) and 2 K2 (the
    # resamples' adjoints). validate runs the forward alone n = iters + 2
    # times (the compared call, a warm one, the timed ones), forward and
    # backward as often, and the gather reference once (1 K4, 2 K2).
    n = SHEAR_GATE_ITERS + 2
    want = (0, 0, 1, 0, 6 * n + 2, 4 * n, 2 * n, 2 * n)
    rows = []
    for res, case in vs.draws(SHEAR_GATE_RES).items():
        before = tuple(k.launches for k in kernels)
        r = vs.validate(res, case, dev, SHEAR_GATE_ITERS)
        got = tuple(k.launches - b for k, b in zip(kernels, before))
        check(r["ok"], f"{tag} {res}^2: {r}")
        check(got == want, f"{tag} {res}^2 launched {', '.join(names)} {got} times, "
                           f"expected {want}")
        rows.append(r)
        print(f"{tag} res {res:4d} (B={r['batch']}, canvas {r['canvas']}^2): psnr "
              f"{r['psnr']:.2f} dB, grad finite {r['grad_finite']}, forward {r['fwd_ms']:.3f} "
              f"ms, forward + backward {r['fwd_bwd_ms']:.3f} ms (CUDA events, "
              f"{SHEAR_GATE_ITERS} calls) -> PASS; launches {dict(zip(names, got))}", flush=True)
    return rows


def gate_soak(dev, smi):
    """(d): soak_train.main for SOAK_ROUNDS rounds: phase 11's FFS-256 G and D
    (seed 0, channel_base 16384) and step, 15 main steps and one R1 step a
    round on the fixed batch, every watched stat finite (the soak raises
    otherwise); the launches, 15 x phase 11's per step without R1 and 1 x
    with, a round."""
    import contextlib
    import io
    import math
    import torch
    from stylegan_v_tpu_torch import soak_train

    tag = "[22 gates (d)]"
    kernels, out = _kernels(), io.StringIO()
    before = tuple(k.launches for k in kernels)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        summary = soak_train.main(["--rounds", str(SOAK_ROUNDS), "--device", str(dev)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = tuple(k.launches - b for k, b in zip(kernels, before))
    per_round = tuple(15 * a + b for a, b in zip(ADA_LAUNCHES_PER_STEP[False],
                                                 ADA_LAUNCHES_PER_STEP[True]))
    want = tuple(SOAK_ROUNDS * n for n in per_round)
    print("\n".join(f"{tag} {line}" for line in out.getvalue().splitlines()), flush=True)
    check(summary["steps"] == 16 * SOAK_ROUNDS and math.isfinite(summary["augment_p"]),
          f"{tag} {summary}")
    check(launched == want, f"{tag} {SOAK_ROUNDS} rounds launched {KERNELS} {launched} times, "
                            f"expected {want} ({per_round} a round)")
    print(f"{tag} soak_train --rounds {SOAK_ROUNDS}: {summary['steps']} FFS-256 steps, zero "
          f"non-finite stats, ADA p {summary['augment_p']:.4f}, {summary['frames_per_s']:.1f} "
          f"frames/s with the build; launches {KERNELS} {launched} ({per_round} a round); "
          f"{seconds:.1f} s on {smi}", flush=True)
    del summary
    torch.cuda.empty_cache()


def gate_dynamics(dev, tmp):
    """(e): diag_dynamics.main for DIAG_STEPS steps on phase 21's zip at its
    defaults (64^2, channel_base 8192, 16 x 3, no augment, R1 at step 0):
    every logged score finite; K1, K1-bwd and K2 per step as derived at 64^2
    without augment (8 K2 a synthesis, 4 D blocks), K4 and K4-bwd none."""
    import contextlib
    import io
    import math
    import os
    import torch
    from stylegan_v_tpu_torch import diag_dynamics

    tag = "[22 gates (e)]"
    k2_syn, blocks = DEMO_K2_PER_SYNTHESIS, DEMO_D_BLOCKS
    per_step = {False: (3 * blocks, 3 * blocks, 0, 0, 3 * k2_syn + 6 * blocks),
                True: (5 * blocks, 5 * blocks, 0, 0, 3 * k2_syn + 10 * blocks)}
    want = tuple(sum(per_step[i % 16 == 0][j] for i in range(DIAG_STEPS)) for j in range(5))
    kernels, out = _kernels(), io.StringIO()
    before = tuple(k.launches for k in kernels)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        hist, _ = diag_dynamics.main(["--data", os.path.join(tmp, "moving64.zip"),
                                      "--steps", str(DIAG_STEPS), "--log-every", "1",
                                      "--device", str(dev)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = tuple(k.launches - b for k, b in zip(kernels, before))
    print("\n".join(f"{tag} {line}" for line in out.getvalue().splitlines() if line),
          flush=True)
    check([s for s, _ in hist] == list(range(DIAG_STEPS))
          and all(math.isfinite(r[k]) for _, r in hist
                  for k in ("Loss/scores/real", "Loss/scores/fake", "Loss/G/loss")),
          f"{tag} the logged rows {hist}")
    check(launched == want, f"{tag} launched {KERNELS} {launched} times, expected {want}")
    print(f"{tag} diag_dynamics, {DIAG_STEPS} steps on phase 21's zip: Dreal "
          f"{hist[0][1]['Loss/scores/real']:+.3f} -> {hist[-1][1]['Loss/scores/real']:+.3f}, "
          f"Dfake {hist[0][1]['Loss/scores/fake']:+.3f} -> {hist[-1][1]['Loss/scores/fake']:+.3f}; "
          f"launches {KERNELS} {launched}; {seconds:.1f} s", flush=True)


def phase_gates(dev, smi, tmp):
    """Phase 22: (a)-(e) in `tmp`, phase 21's directory."""
    t_phase, parts = time.perf_counter(), {}
    for key, fn, args in (("a", gate_detectors, (dev, smi, tmp)), ("b", gate_parity, (dev, tmp)),
                          ("c", gate_shear, (dev, smi)), ("d", gate_soak, (dev, smi)),
                          ("e", gate_dynamics, (dev, tmp))):
        t0 = time.perf_counter()
        fn(*args)
        parts[key] = time.perf_counter() - t0
    print(f"[22 gates] the parts took " + ", ".join(f"({k}) {v:.1f} s" for k, v in parts.items())
          + f"; phase 22 took {time.perf_counter() - t_phase:.1f} s", flush=True)


def package_version(name):
    """The installed version of package `name`, or "absent"."""
    import importlib.metadata
    import importlib.util
    if importlib.util.find_spec(name) is None:
        return "absent"
    return f"{name} {importlib.metadata.version(name)}"


def kernel_records(k1, k1_bwd, k4, k4_bwd, k2, launches, moco, cli, moco_ranks, shear):
    """The kernel record: each kernel's launches in the ADA run (phase 11),
    worst error against its plain version, and its time, its plain version's
    and its library call's beside its bound: K1 and K1-bwd summed over one D
    pass at 16 x 3 (phases 3, 7), K4 and K4-bwd at the step's warp (phase 10);
    for K4 also its reference design's time there. `moco` is phase 17's
    (launches per step without and with R1 as measured, K1's and K1-bwd's
    records at the image D's skips, K4's and K4-bwd's at 48 channels): each
    kernel's launches per MoCoGAN step, K1's and K1-bwd's worst error, times
    and bound summed over the image D's skips at a round's 8 x 16 frames, and
    K4's and K4-bwd's at the MoCoGAN pipe's warp. `cli` is phase 18's ((b)'s
    records of K1 and K1-bwd at the projection's pyramid, (a)'s launches of
    each per projection step as counted): their launches per projection step
    and their numbers there. `moco_ranks` is phase 19's (each kernel's
    launches per rank per step without and with R1 as measured, K1's and
    K1-bwd's records at one rank's image D skips, K4's and K4-bwd's at one
    rank's 48-channel warp). `k2` is phase 3b's: K2's record is G's r = 256
    up-conv call at 16 x 3, with the sums over one forward's calls and their
    adjoints, every call's numbers, and the ADA pipe's separable calls at
    each batch phase_warp held them (K2_PIPE) and in phase 3b. `shear` is
    phase 20's: K7's, K7-bwd's and K8's launches in (c)'s five steps, worst
    error and times summed over one warp's two passes at the step's canvas
    (K8: its forward), each call's row, (b)'s whole warp and (c)'s step."""
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
    err, head, sums, rows = k2
    records.append({"name": "upfirdn2d", "route": "cuda",
                    "source": "stylegan_v_tpu_torch/csrc/upfirdn2d.cu",
                    "replaces": "stylegan_v_tpu/ops/upfirdn2d.py:74 (_depthwise_pass, from "
                                ":101 upfirdn2d: an XLA convolution; no Pallas kernel)",
                    "launches": launches[4], "max_abs_err": err, "ms": head["ms"],
                    "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                    "bound_by": head["bound_by"],
                    "library_call": "F.conv_transpose2d (depthwise, stride 2, padding 0, in "
                                    "the input's dtype)",
                    "library_ms": head["library_ms"],
                    "share_of_bound": head["share_of_bound"],
                    "kernel_ms": head["kernel_ms"],
                    "shape": "G's r = 256 up=2 conv, [48, 128, 128, 128] bf16 -> 258^2",
                    "one_forward_16x3": sums, "calls": rows,
                    "separable_pipe": dict(K2_PIPE, **{"16x9 (phase 3b)": [
                        r for r in rows if r["name"].startswith("augment")]})})
    moco_launches, moco_k1, moco_k1_bwd, moco_k4, moco_k4_bwd = moco
    for i, rec in enumerate(records):
        rec["mocogan_launches_per_step"] = {"without_r1": moco_launches[False][i],
                                            "with_r1": moco_launches[True][i]}
    for rec, (err, m) in ((records[0], moco_k1), (records[1], moco_k1_bwd)):
        rec["mocogan_image_d"] = {"max_abs_err": err, "ms": m["ms"], "plain_ms": m["plain_ms"],
                                  "library_ms": m["library_ms"], "bound_ms": m["bound_ms"],
                                  "bound_by": m["bound_by"],
                                  "share_of_bound": m["bound_ms"] / m["ms"]}
    (cli_k1, cli_k1_bwd), proj_launches = cli
    for rec, (err, m), n in ((records[0], cli_k1, proj_launches[0]),
                             (records[1], cli_k1_bwd, proj_launches[1])):
        rec["projection_launches_per_step"] = n
        rec["projection_pyramid"] = {"max_abs_err": err, "ms": m["ms"],
                                     "plain_ms": m["plain_ms"], "library_ms": m["library_ms"],
                                     "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                                     "share_of_bound": m["bound_ms"] / m["ms"]}
    for rec, m in ((records[2], moco_k4), (records[3], moco_k4_bwd)):
        rec["mocogan_48ch"] = {"max_abs_err": m[0], "ms": m[1], "plain_ms": m[2],
                               "library_ms": m[3], "bound_ms": m[4], "bound_by": m[5],
                               "share_of_bound": m[4] / m[1]}
    rank_launches, rank_k1, rank_k1_bwd, rank_k4, rank_k4_bwd = moco_ranks
    for i, rec in enumerate(records):
        rec["mocogan_ranks_launches_per_step"] = {"without_r1": rank_launches[False][i],
                                                  "with_r1": rank_launches[True][i]}
    for rec, (err, m) in ((records[0], rank_k1), (records[1], rank_k1_bwd)):
        rec["mocogan_ranks_image_d"] = {"max_abs_err": err, "ms": m["ms"],
                                        "plain_ms": m["plain_ms"], "library_ms": m["library_ms"],
                                        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                                        "share_of_bound": m["bound_ms"] / m["ms"]}
    for rec, m in ((records[2], rank_k4), (records[3], rank_k4_bwd)):
        rec["mocogan_ranks_48ch"] = {"max_abs_err": m[0], "ms": m[1], "plain_ms": m[2],
                                     "library_ms": m[3], "bound_ms": m[4], "bound_by": m[5],
                                     "share_of_bound": m[4] / m[1]}
    (worst, sums, rows), shear_launches, whole, step = shear
    sw = "stylegan_v_tpu/ops/shear_warp.py"
    bmm = "torch.bmm of the banded one-hot matrix (the JAX formulation), a copy a plane"
    gs = ("F.grid_sample(bilinear, zeros, align_corners=True) on the float32 input, grid of "
          "the shift's positions built before")
    for (name, key, replaces, library), n in zip((
            ("shear_pass", "K7", f"{sw}:104 (_line_pass_onehot: a one-hot matmul) and :278 "
                                 f"(_shift_lines_dense_impl), with the reflect pads :423, :455 "
                                 f"and the rot90 select :388; no Pallas kernel",
             f"the earlier route: rot90 select, F.pad reflect, {bmm} over the padded axis, "
             f"then {gs.replace('input', 'stage 1')}"),
            ("shear_resample_bwd", "K7-bwd", f"{sw}:104 (its gradient, from jax.grad: the "
                                             f"transposed matmul), the pads' gradient and "
                                             f"the rot90 select's :388",
             f"{bmm}, transposed, then in pass V the rot90 samples turned back"),
            ("shear_shift", "K8", f"{sw}:278 (_shift_lines_dense_impl) and :333, :337 "
                                          f"(its VJP, a shift too; no Pallas kernel)", gs)),
            shear_launches):
        t = sums[key]
        records.append({"name": name, "route": "cuda",
                        "source": f"stylegan_v_tpu_torch/csrc/{name}.cu", "replaces": replaces,
                        "launches": n, "max_abs_err": worst[key.split()[0]], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_call": library,
                        "library_ms": t["library_ms"], "share_of_bound": t["bound_ms"] / t["ms"],
                        "shape": "one warp's two passes at the ADA step's canvas, [16, 9, 536^2] "
                                 "-> 524^2 bf16, the pipe's bgc maps",
                        "calls": [r for r in rows if r["name"].startswith(key.split()[0] + " ")]})
        if "kernel_ms" in t:
            records[-1].update(kernel_ms=t["kernel_ms"], ms_is="the wrapper as the step calls "
                               "it (pass V with rot); kernel_ms the kernel launched through its "
                               "C entry point")
    adj = sums["K8 adjoint"]
    records[-1].update(ms_is="its forward, as in earlier records (the step runs the forward "
                             "fused in shear_pass); the step's calls are the adjoint's",
                       adjoint={**{k: adj[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                       "library_ms")},
                                "share_of_bound": adj["bound_ms"] / adj["ms"]})
    records[-3].update(whole_warp_16x9=whole, shear_ada_step=dict(zip(
        ("ms_without_r1", "ms_with_r1", "ms_amortised", "frames_per_s", "peak_gib"), step)))
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
    laps, clock = [], [time.perf_counter()]

    def lap(phases):
        now = time.perf_counter()
        laps.append(f"{phases} {now - clock[0]:.1f}")
        clock[0] = now
    smi = phase_device()
    phase_build()
    lap("1-2")
    with float32_precision(False):
        k1 = phase_kernel(dev, "[3 kernel]", "down", downfirdn2d_x2, downfirdn2d_x2_plain)
        G, D = ffs256_models(dev)
        k2 = phase_k2(dev, G, D)
        torch.cuda.empty_cache()
        phase_slice(dev, G, D)
        phase_speed(dev, G, smi)
        phase_parity(dev)
        k1_bwd = phase_bwd(dev)
    lap("3-7")
    _, no_aug = phase_train(dev, smi, G, D, augment=False)     # the step's own default
    torch.cuda.empty_cache()
    lap("8")
    with float32_precision(False):
        phase_grads(dev)
        k4, k4_bwd = phase_warp(dev)
    torch.cuda.empty_cache()
    lap("9-10")
    launches, prestaged = phase_train(dev, smi, G, D, augment=True, no_aug=no_aug)
    torch.cuda.empty_cache()
    lap("11")
    with float32_precision(False):
        phase_aug_parity(dev)
    lap("12")
    shear = phase_shear(dev, smi, G, D, prestaged)
    lap("20")
    shear_launched = tuple(k.launches for k in _shear_kernels())
    del D
    G.cpu()                                           # phase 21's, off the card until then
    torch.cuda.empty_cache()
    detectors = random_detectors()
    with tempfile.TemporaryDirectory() as tmp:
        zip_path, G_ema = phase_loop(dev, smi, prestaged, tmp)   # the loop's own TF32 default
        lap("13")
        with float32_precision(False):
            phase_metrics(dev, smi, G_ema, zip_path, tmp, detectors)
        del G_ema
        torch.cuda.empty_cache()
        lap("14")
        phase_parallel(dev, smi, zip_path, tmp)       # the steps' own TF32 default
        torch.cuda.empty_cache()
        lap("15")
        # the loop's own TF32 default
        pkl, gen_rate = phase_legacy(dev, smi, zip_path, tmp, detectors)
        torch.cuda.empty_cache()
        lap("16")
        moco = phase_mocogan(dev, smi, zip_path, tmp, detectors, (k4, k4_bwd))
        torch.cuda.empty_cache()
        lap("17")
        cli = phase_cli(dev, smi, zip_path, tmp, pkl, gen_rate, k1, k1_bwd)
        torch.cuda.empty_cache()
        lap("18")
        moco_ranks = phase_moco_ranks(dev, smi, zip_path, tmp)
        lap("19")
    with tempfile.TemporaryDirectory() as tmp:
        phase_demo(dev, smi, G.to(dev), tmp)          # the loop's own TF32 default
        lap("21")
        after = tuple(k.launches for k in _shear_kernels())
        check(after == shear_launched, f"phases 13-19 and 21 launched {SHEAR_KERNELS} "
                                       f"{tuple(a - b for a, b in zip(after, shear_launched))} "
                                       f"times")
        del G
        torch.cuda.empty_cache()
        phase_gates(dev, smi, tmp)                    # each entry point's own TF32 default
        lap("22")
    records = kernel_records(k1, k1_bwd, k4, k4_bwd, k2, launches, moco, cli, moco_ranks, shear)
    print(f"[timing] seconds a phase on the host's clock, in the order run: {', '.join(laps)}",
          flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
