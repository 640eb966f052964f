"""Adaptive discriminator augmentation (ADA) pipeline, NCHW.

Counterpart of stylegan_v_tpu/training/augment.py (reference
src/training/augment.py, the 18-transform differentiable pipeline of
"Training GANs with Limited Data"):

  * Pixel blitting and geometric transforms accumulate ONE inverse map
    G_inv per sample and run as one pass: reflect pad -> 12-tap 2x upsample
    -> bilinear warp (K4, ops/grid_sample.py) -> 12-tap 2x downsample
    (`warp_upsample=2`), or as a direct mirrored warp (`warp_upsample=1`).
  * Color transforms are one homogeneous 4x4 matrix per sample applied to
    RGB; C = F*3 channels (video-consistent augmentation) are frames, frame
    major: channel f*3 + c is color c of frame f.
  * Image-space filtering amplifies 4 wavelet bands with a per-sample
    separable filter; noise and cutout corrupt.

Random draws. The JAX pipe splits its key into 64 and takes one key per
`rand` / `randn` call. The port takes them from a draw source, an object
with `rand(shape)` (uniform in [0, 1)) and `randn(shape)` (standard normal),
called in exactly the JAX pipe's order and with its shapes:

    xflip: rand (B,) value, rand (B,) gate;  rotate90: the same;
    xint: rand (B, 2), rand (B, 1);          scale: randn (B,), rand (B,);
    rotate: rand (B,), rand (B,);            aniso: randn (B,), rand (B,);
    rotate (again): rand (B,), rand (B,);    xfrac: randn (B, 2), rand (B, 1);
    brightness: randn (B,), rand (B,);       contrast: randn (B,), rand (B,);
    lumaflip: rand (B, 1, 1), rand (B, 1, 1);
    hue (C > 1): rand (B,), rand (B,);       saturation (C > 1): randn (B, 1, 1), rand (B, 1, 1);
    imgfilter, per band: randn (B,), rand (B,);
    noise: randn (B, 1, 1, 1), rand (B, 1, 1, 1), then randn (B, H, W, C) (NHWC,
           transposed here);
    cutout: rand (B, 1) gate, then rand (B, 2) center,

each only when its probability multiplier is > 0, and every draw is taken
even where `debug_percentile` overrides it. `GeneratorDraws` wraps a
torch.Generator; a test can replay the JAX keys through its own source.

`p` is a float32 tensor (or a number) that the pipe never reads on the
host: every transform runs at any p, and the gates compare draws with it on
the device, so the step's cost does not depend on p.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F

from ..ops import downsample2d, setup_filter, upsample2d
from ..ops.grid_sample import affine_grid_sample

# Wavelet low-pass decomposition coefficients (stylegan_v_tpu/training/augment.py:44-53).
_SYM6 = [0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
         -0.048311742585633, 0.4910559419267466, 0.787641141030194,
         0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
         0.04472490177066578, 0.0017677118642428036, -0.007800708325034148]
_SYM2 = [-0.12940952255092145, 0.22414386804185735, 0.836516303737469,
         0.48296291314469025]


@dataclass(frozen=True)
class AugmentConfig:
    """Probability multipliers + shape parameters (reference augment.py:118-164).
    A copy of the JAX package's, field for field (tests/test_torch_augment.py)."""
    # pixel blitting
    xflip: float = 0.0
    rotate90: float = 0.0
    xint: float = 0.0
    xint_max: float = 0.125
    # geometric
    scale: float = 0.0
    rotate: float = 0.0
    aniso: float = 0.0
    xfrac: float = 0.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    # color
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    # image-space filtering
    imgfilter: float = 0.0
    imgfilter_bands: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    # corruptions
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5
    # geometric execution: 2 = the reference's anti-aliased pad -> 2x
    # upsample -> warp -> 2x downsample pipeline; 1 = direct mirrored warp.
    warp_upsample: int = 2
    # warp executor: "auto" and "gather" both run the bilinear warp (K4) in
    # the port; "shear" (the JAX package's TPU executor) is not ported.
    warp_mode: str = "auto"
    # geometric-stage payload dtype: "auto" = bfloat16 on a CUDA tensor,
    # float32 on CPU (the JAX package's policy: bf16 on an accelerator);
    # "float32" / "bfloat16" force it.
    geom_dtype: str = "auto"
    # data-parallel shard count of the batch. Accepted and ignored: in the
    # JAX package it only sets how many chunks the shear/gather warp runs in
    # (stylegan_v_tpu/training/augment.py:302-312) and never changes a value;
    # the port's pipe runs each rank's rows unchunked.
    data_shards: int = 1


# Augpipe presets (reference train.py:36-50 augpipe_specs).
AUGPIPE_SPECS = {
    "blit":   dict(xflip=1, rotate90=1, xint=1),
    "geom":   dict(scale=1, rotate=1, aniso=1, xfrac=1),
    "color":  dict(brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1),
    "filter": dict(imgfilter=1),
    "noise":  dict(noise=1),
    "cutout": dict(cutout=1),
    "bg":     dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1),
    "bgc":    dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1,
                   brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1),
    "bgcf":   dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1,
                   brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1,
                   imgfilter=1),
    "bgcfn":  dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1,
                   brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1,
                   imgfilter=1, noise=1),
    "bgcfnc": dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1,
                   brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1,
                   imgfilter=1, noise=1, cutout=1),
}


class GeneratorDraws:
    """The pipe's draw source over a torch.Generator, on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def rand(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.generator.device)

    def randn(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.generator.device)


# ---------------- batched matrix helpers (reference augment.py:43-107) --------
# float32 [B, 3, 3] / [B, 4, 4] on the arguments' device.

def _eye(n: int, B: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.float32, device=device).repeat(B, 1, 1)


def translate2d(tx, ty):
    m = _eye(3, tx.shape[0], tx.device)
    m[:, 0, 2], m[:, 1, 2] = tx, ty
    return m


def scale2d(sx, sy):
    m = _eye(3, sx.shape[0], sx.device)
    m[:, 0, 0], m[:, 1, 1] = sx, sy
    return m


def rotate2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    m = _eye(3, theta.shape[0], theta.device)
    m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1] = c, -s, s, c
    return m


def translate3d(tx, ty, tz):
    m = _eye(4, tx.shape[0], tx.device)
    m[:, 0, 3], m[:, 1, 3], m[:, 2, 3] = tx, ty, tz
    return m


def scale3d(sx, sy, sz):
    m = _eye(4, sx.shape[0], sx.device)
    m[:, 0, 0], m[:, 1, 1], m[:, 2, 2] = sx, sy, sz
    return m


def rotate3d(v, theta):
    """Rotation of homogeneous color space around axis v (reference augment.py:90-98)."""
    vx, vy, vz = v[0], v[1], v[2]
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1 - c
    m = _eye(4, theta.shape[0], theta.device)
    m[:, 0, 0] = vx * vx * cc + c
    m[:, 0, 1] = vx * vy * cc - vz * s
    m[:, 0, 2] = vx * vz * cc + vy * s
    m[:, 1, 0] = vy * vx * cc + vz * s
    m[:, 1, 1] = vy * vy * cc + c
    m[:, 1, 2] = vy * vz * cc - vx * s
    m[:, 2, 0] = vz * vx * cc - vy * s
    m[:, 2, 1] = vz * vy * cc + vx * s
    m[:, 2, 2] = vz * vz * cc + c
    return m


def _build_fbank() -> np.ndarray:
    """4-band wavelet filter bank (reference augment.py:169-179)."""
    Hz_lo = np.asarray(_SYM2)
    Hz_hi = Hz_lo * ((-1) ** np.arange(Hz_lo.size))
    Hz_lo2 = np.convolve(Hz_lo, Hz_lo[::-1]) / 2
    Hz_hi2 = np.convolve(Hz_hi, Hz_hi[::-1]) / 2
    fbank = np.eye(4, 1)
    for i in range(1, fbank.shape[0]):
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(fbank.shape[0], -1)[:, :-1]
        fbank = scipy.signal.convolve(fbank, [Hz_lo2])
        fbank[i, (fbank.shape[1] - Hz_hi2.size) // 2:
                 (fbank.shape[1] + Hz_hi2.size) // 2] += Hz_hi2
    return fbank.astype(np.float32)


def _resolve_geom_dtype(geom_dtype: str, device: torch.device) -> torch.dtype:
    """The payload-dtype policy: bf16 on a CUDA tensor, float32 on CPU."""
    if geom_dtype == "auto":
        geom_dtype = "bfloat16" if device.type == "cuda" else "float32"
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[geom_dtype]


def _warp_antialiased(images, G_inv, Hz_geom, Hz_pad, geom_dtype="auto"):
    """The reference's anti-aliased geometric execution: symmetric static
    reflect pad, 2x upsample, bilinear warp on the (H + Hz_pad*2)*2 canvas,
    then downsample and crop (reference augment.py:286-300).

    Unchunked: the JAX package maps the warp over batch chunks and
    rematerializes each in the backward to bound TPU HBM
    (stylegan_v_tpu/training/augment.py:286-315); K4 keeps no packed
    neighbourhood, and the whole batch fits the card.
    """
    B, C, H, W = images.shape
    dev = images.device
    dt = _resolve_geom_dtype(geom_dtype, dev)
    m = Hz_pad * 2
    ones = torch.ones(B, device=dev)
    # account for 2x upsample + half-pixel origin (augment.py:290-291)
    G_inv = scale2d(2 * ones, 2 * ones) @ G_inv @ scale2d(ones / 2, ones / 2)
    G_inv = (translate2d(-0.5 * ones, -0.5 * ones) @ G_inv
             @ translate2d(0.5 * ones, 0.5 * ones))
    out_h, out_w = (H + Hz_pad * 2) * 2, (W + Hz_pad * 2) * 2
    in_h, in_w = (H + 2 * m) * 2, (W + 2 * m) * 2
    G_inv = (scale2d(2 / in_w * ones, 2 / in_h * ones) @ G_inv
             @ scale2d(out_w / 2 * ones, out_h / 2 * ones))
    x = F.pad(images.to(dt), [m, m, m, m], mode="reflect")
    x = upsample2d(x, Hz_geom, up=2)
    x = affine_grid_sample(x, G_inv, out_h, out_w, mode="reflect")
    x = downsample2d(x, Hz_geom, down=2, padding=-Hz_pad * 2, flip_filter=True)
    return x.to(images.dtype)


class _PlaneFilter(torch.autograd.Function):
    """Valid correlation of every plane p of x [1, P, H, W] with its own 1-D
    filter k[p] (k [P, taps], a constant) along `axis` (3: rows, 2: columns).

    Its backward is the same pass with the filter flipped, over the gradient
    zero-padded by taps - 1, so every order of derivative is a forward pass:
    left to autograd, the second order of a grouped conv goes through
    PyTorch's generic grouped double backward, which loops over channels.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, k: torch.Tensor, axis: int) -> torch.Tensor:
        ctx.save_for_backward(k)
        ctx.axis = axis
        w = k.to(x.dtype)
        w = w[:, None, None, :] if axis == 3 else w[:, None, :, None]
        return F.conv2d(x, w, groups=k.shape[0])

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        k, = ctx.saved_tensors
        e = k.shape[1] - 1
        pad = [e, e, 0, 0] if ctx.axis == 3 else [0, 0, e, e]
        return _PlaneFilter.apply(F.pad(dy, pad), k.flip(1), ctx.axis), None, None


def _as_draws(draws):
    if isinstance(draws, torch.Generator):
        return GeneratorDraws(draws)
    if draws is None or not (hasattr(draws, "rand") and hasattr(draws, "randn")):
        raise ValueError("the augment pipe needs a draw source (rand, randn) or a "
                         "torch.Generator")
    return draws


def make_augment_pipe(cfg: AugmentConfig):
    """Returns augment(draws, images [B, C, H, W], p, debug_percentile=None) -> images.

    `draws` is a draw source (module docstring) or a torch.Generator. C may
    be 3, 1, or F*3 (video-consistent, frame-major)."""
    if cfg.warp_mode not in ("auto", "gather", "shear"):
        raise ValueError(f"unknown warp_mode {cfg.warp_mode!r}")
    if cfg.warp_mode == "shear":
        raise NotImplementedError("the shear warp executor is not ported: ROADMAP ports it "
                                  "only if K4 measures slower than it on the card")
    if cfg.warp_upsample not in (1, 2):
        raise ValueError(f"warp_upsample must be 1 or 2, got {cfg.warp_upsample}")
    Hz_geom = setup_filter(_SYM6)                     # orthogonal lowpass, 12 taps
    Hz_pad = (len(_SYM6) if Hz_geom.ndim == 1 else Hz_geom.shape[0]) // 4
    Hz_fbank = torch.from_numpy(_build_fbank())
    geom_enabled = any(getattr(cfg, k) > 0 for k in
                       ("xflip", "rotate90", "xint", "scale", "rotate", "aniso", "xfrac"))
    color_enabled = any(getattr(cfg, k) > 0 for k in
                        ("brightness", "contrast", "lumaflip", "hue", "saturation"))
    v_luma = np.asarray([1, 1, 1, 0]) / np.sqrt(3)

    def augment(draws, images: torch.Tensor, p, debug_percentile=None) -> torch.Tensor:
        assert images.ndim == 4, f"expected NCHW, got {tuple(images.shape)}"
        B, C, H, W = images.shape
        dev = images.device
        src = _as_draws(draws)
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        dp = (None if debug_percentile is None
              else torch.tensor(debug_percentile, dtype=torch.float32, device=dev))

        def rand(shape):
            return src.rand(shape).to(dev, torch.float32)

        def randn(shape):
            return src.randn(shape).to(dev, torch.float32)

        def full(shape, value):
            return value.expand(shape)

        # ---- pixel blitting + geometric: accumulate G_inv ----------------
        if geom_enabled:
            G_inv = _eye(3, B, dev)
            ones = torch.ones(B, device=dev)
            if cfg.xflip > 0:
                i = torch.floor(rand((B,)) * 2)
                i = torch.where(rand((B,)) < cfg.xflip * p, i, 0.0)
                if dp is not None:
                    i = full((B,), torch.floor(dp * 2))
                G_inv = G_inv @ scale2d(1.0 / (1 - 2 * i), ones)
            if cfg.rotate90 > 0:
                i = torch.floor(rand((B,)) * 4)
                i = torch.where(rand((B,)) < cfg.rotate90 * p, i, 0.0)
                if dp is not None:
                    i = full((B,), torch.floor(dp * 4))
                G_inv = G_inv @ rotate2d(-(-np.pi / 2) * i)      # rotate2d_inv
            if cfg.xint > 0:
                t = (rand((B, 2)) * 2 - 1) * cfg.xint_max
                t = torch.where(rand((B, 1)) < cfg.xint * p, t, 0.0)
                if dp is not None:
                    t = full((B, 2), (dp * 2 - 1) * cfg.xint_max)
                G_inv = G_inv @ translate2d(-torch.round(t[:, 0] * W),
                                            -torch.round(t[:, 1] * H))
            if cfg.scale > 0:
                s = torch.exp2(randn((B,)) * cfg.scale_std)
                s = torch.where(rand((B,)) < cfg.scale * p, s, 1.0)
                if dp is not None:
                    s = full((B,), torch.exp2(torch.erfinv(dp * 2 - 1) * cfg.scale_std))
                G_inv = G_inv @ scale2d(1 / s, 1 / s)
            p_rot = 1 - torch.sqrt(torch.clip(1 - cfg.rotate * p, 0, 1))
            if cfg.rotate > 0:
                theta = (rand((B,)) * 2 - 1) * np.pi * cfg.rotate_max
                theta = torch.where(rand((B,)) < p_rot, theta, 0.0)
                if dp is not None:
                    theta = full((B,), (dp * 2 - 1) * np.pi * cfg.rotate_max)
                G_inv = G_inv @ rotate2d(theta)                  # rotate2d_inv(-theta)
            if cfg.aniso > 0:
                s = torch.exp2(randn((B,)) * cfg.aniso_std)
                s = torch.where(rand((B,)) < cfg.aniso * p, s, 1.0)
                if dp is not None:
                    s = full((B,), torch.exp2(torch.erfinv(dp * 2 - 1) * cfg.aniso_std))
                G_inv = G_inv @ scale2d(1 / s, s)
            if cfg.rotate > 0:
                theta = (rand((B,)) * 2 - 1) * np.pi * cfg.rotate_max
                theta = torch.where(rand((B,)) < p_rot, theta, 0.0)
                if dp is not None:
                    theta = torch.zeros(B, device=dev)
                G_inv = G_inv @ rotate2d(theta)
            if cfg.xfrac > 0:
                t = randn((B, 2)) * cfg.xfrac_std
                t = torch.where(rand((B, 1)) < cfg.xfrac * p, t, 0.0)
                if dp is not None:
                    t = full((B, 2), torch.erfinv(dp * 2 - 1) * cfg.xfrac_std)
                G_inv = G_inv @ translate2d(-t[:, 0] * W, -t[:, 1] * H)

            # ---- execute geometry --------------------------------------------
            if cfg.warp_upsample == 1:
                # direct warp with mirrored sampling, no anti-aliasing
                Gn = (scale2d(2 / W * ones, 2 / H * ones) @ G_inv
                      @ scale2d(W / 2 * ones, H / 2 * ones))
                gdt = _resolve_geom_dtype(cfg.geom_dtype, dev)
                images = affine_grid_sample(images.to(gdt), Gn, H, W,
                                            mode="reflect").to(images.dtype)
            else:
                images = _warp_antialiased(images, G_inv, Hz_geom, Hz_pad, cfg.geom_dtype)

        # ---- color transforms --------------------------------------------
        if color_enabled:
            Cm = _eye(4, B, dev)
            if cfg.brightness > 0:
                b = randn((B,)) * cfg.brightness_std
                b = torch.where(rand((B,)) < cfg.brightness * p, b, 0.0)
                if dp is not None:
                    b = full((B,), torch.erfinv(dp * 2 - 1) * cfg.brightness_std)
                Cm = translate3d(b, b, b) @ Cm
            if cfg.contrast > 0:
                c = torch.exp2(randn((B,)) * cfg.contrast_std)
                c = torch.where(rand((B,)) < cfg.contrast * p, c, 1.0)
                if dp is not None:
                    c = full((B,), torch.exp2(torch.erfinv(dp * 2 - 1) * cfg.contrast_std))
                Cm = scale3d(c, c, c) @ Cm
            v = torch.tensor(v_luma, dtype=torch.float32, device=dev)
            vv = torch.outer(v, v)
            eye4 = torch.eye(4, device=dev)
            if cfg.lumaflip > 0:
                i = torch.floor(rand((B, 1, 1)) * 2)
                i = torch.where(rand((B, 1, 1)) < cfg.lumaflip * p, i, 0.0)
                if dp is not None:
                    i = full((B, 1, 1), torch.floor(dp * 2))
                Cm = (eye4 - 2 * vv * i) @ Cm                   # Householder
            if cfg.hue > 0 and C > 1:
                theta = (rand((B,)) * 2 - 1) * np.pi * cfg.hue_max
                theta = torch.where(rand((B,)) < cfg.hue * p, theta, 0.0)
                if dp is not None:
                    theta = full((B,), (dp * 2 - 1) * np.pi * cfg.hue_max)
                Cm = rotate3d(v, theta) @ Cm
            if cfg.saturation > 0 and C > 1:
                s = torch.exp2(randn((B, 1, 1)) * cfg.saturation_std)
                s = torch.where(rand((B, 1, 1)) < cfg.saturation * p, s, 1.0)
                if dp is not None:
                    s = full((B, 1, 1), torch.exp2(torch.erfinv(dp * 2 - 1) * cfg.saturation_std))
                Cm = (vv + (eye4 - vv) * s) @ Cm

            # execute: [B, C, H, W]; C = F*3 folds frames (reference augment.py:357-371)
            if C % 3 == 0:
                x = images.reshape(B, C // 3, 3, H * W)
                x = (torch.einsum("bfcn,bxc->bfxn", x, Cm[:, :3, :3])
                     + Cm[:, :3, 3].reshape(B, 1, 3, 1))
                images = x.reshape(B, C, H, W)
            elif C == 1:
                Cl = torch.mean(Cm[:, :3, :], dim=1, keepdim=True)      # [B, 1, 4]
                images = (images * torch.sum(Cl[:, :, :3], dim=2)[:, None, None]
                          + Cl[:, 0, 3][:, None, None, None])
            else:
                raise ValueError("Image must have 1, 3, or F*3 channels")

        # ---- image-space filtering ---------------------------------------
        if cfg.imgfilter > 0:
            num_bands = Hz_fbank.shape[0]
            expected_power = torch.tensor(np.array([10, 1, 1, 1]) / 13, dtype=torch.float32,
                                          device=dev)
            g = torch.ones(B, num_bands, device=dev)
            for i, band_strength in enumerate(cfg.imgfilter_bands):
                t_i = torch.exp2(randn((B,)) * cfg.imgfilter_std)
                t_i = torch.where(rand((B,)) < cfg.imgfilter * p * band_strength, t_i, 1.0)
                if dp is not None:
                    t_i = (full((B,), torch.exp2(torch.erfinv(dp * 2 - 1) * cfg.imgfilter_std))
                           if band_strength > 0 else torch.ones(B, device=dev))
                t = torch.ones(B, num_bands, device=dev)
                t[:, i] = t_i
                t = t / torch.sqrt(torch.sum(expected_power * torch.square(t), dim=-1,
                                             keepdim=True))
                g = g * t
            Hz_prime = g @ Hz_fbank.to(dev)                         # [B, taps]
            pd = Hz_fbank.shape[1] // 2
            # per-sample separable filter: one plane per (sample, channel)
            x = F.pad(images.reshape(1, B * C, H, W), [pd, pd, pd, pd], mode="reflect")
            k = Hz_prime.repeat_interleave(C, dim=0)                 # [B*C, taps]
            x = _PlaneFilter.apply(x, k, 3)
            x = _PlaneFilter.apply(x, k, 2)
            images = x.reshape(B, C, H, W)

        # ---- corruptions -------------------------------------------------
        if cfg.noise > 0:
            sigma = torch.abs(randn((B, 1, 1, 1))) * cfg.noise_std
            sigma = torch.where(rand((B, 1, 1, 1)) < cfg.noise * p, sigma, 0.0)
            if dp is not None:
                sigma = full((B, 1, 1, 1), torch.erfinv(dp) * cfg.noise_std)
            images = images + randn((B, H, W, C)).permute(0, 3, 1, 2) * sigma
        if cfg.cutout > 0:
            size = torch.full((B, 2), cfg.cutout_size, device=dev)
            size = torch.where(rand((B, 1)) < cfg.cutout * p, size, 0.0)
            center = rand((B, 2))
            if dp is not None:
                size = torch.full((B, 2), cfg.cutout_size, device=dev)
                center = full((B, 2), dp)
            coord_x = (torch.arange(W, device=dev) + 0.5) / W
            coord_y = (torch.arange(H, device=dev) + 0.5) / H
            mask_x = (torch.abs(coord_x[None, None, :] - center[:, 0, None, None])
                      >= size[:, 0, None, None] / 2)
            mask_y = (torch.abs(coord_y[None, :, None] - center[:, 1, None, None])
                      >= size[:, 1, None, None] / 2)
            mask = torch.logical_or(mask_x, mask_y).to(images.dtype)
            images = images * mask[:, None]

        return images

    return augment
