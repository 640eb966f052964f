"""Export a trained generator to a serving artifact that runs without the
model code (the port's counterpart of scripts/export_model.py).

    python -m stylegan_v_tpu_torch.export_model --ckpt <snapshot|run-dir|reference.pkl> \\
        --out model.pt2 --batch 4 --video-len 16 [--truncation 1.0] [--max-t T] \\
        [--selftest] [--device cpu]

The JAX script lowers synthesis to StableHLO with `jax.export`; here
`torch.export.export` traces the whole synthesis program, weights included,
to an ExportedProgram of ATen ops, saved with `torch.export.save`. A process
that imports torch alone loads it with `torch.export.load(path).module()`:
neither this package nor its configs are needed. The graph is traced on
`--device` (default cuda; no card raises, `--device cpu` for the CPU) and
runs there.

The artifact takes (z [B, z_dim] f32, [c [B, c_dim] f32,] t [B, T] f32,
seed i32 []) and returns frames [B, T, C, H, W] f32 in [-1, 1], NCHW per
frame. `seed` drives the motion-noise draw inside the program (a
counter-based normal draw, `counter_normal`: a traced program cannot hold a
torch.Generator seeded from an input), so one artifact serves arbitrarily
many distinct videos. The motion-code lattice is pre-sized for timestamps up
to --max-t (default: video-len), the sidecar's `t_max`; per-layer noise is
the constant buffers (noise_mode="const"). The sidecar <out>.json records
the I/O contract. --selftest loads the artifact back and compares it with
the direct forward.

FIR route: a ctypes kernel launch cannot be traced, so the artifact's
upfirdn2d passes (G's up-convs and image skips, K2 everywhere else in the
port) are traced as their plain ATen version (F.pad and a depthwise
F.conv2d a pass), inside `ops.upfirdn2d_kernel.aten_route()`. That is the
artifact's one route (FIR_ROUTE, recorded in the sidecar as `fir_route`);
the direct forward that --selftest compares it with runs K2 on a card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import List, Optional

import numpy as np
import torch
from torch import nn

U32 = 0xFFFFFFFF
FIR_ROUTE = "aten"     # the upfirdn2d passes of the artifact: plain ATen ops, not K2


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32) and c < 2^32, in 16-bit halves
    so that no int64 product overflows."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & U32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mixer (lowbias32) on int64 holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_normal(seed: torch.Tensor, shape, device) -> torch.Tensor:
    """Standard normals of `shape` (float32 on `device`) drawn from the
    integer `seed` by counters: element i takes the uniforms of counters i
    and n + i (n elements), each hash32(hash32(counter ^ key) ^ C) with
    key = hash32(seed ^ C'), in (0, 1) from its top 24 bits, and Box-Muller.
    Plain tensor ops, so torch.export traces it with `seed` an input."""
    n = math.prod(shape)
    key = _hash32((seed.to(device=device, dtype=torch.int64) & U32) ^ 0x9E3779B9)
    counters = torch.arange(2 * n, dtype=torch.int64, device=device)
    bits = _hash32(_hash32(counters ^ key) ^ 0x5BD1E995)
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / 2 ** 24)
    normal = torch.sqrt(-2.0 * torch.log(u[:n])) * torch.cos((2.0 * math.pi) * u[n:])
    return normal.reshape(shape)


class Served(nn.Module):
    """G's serving program, unconditional: forward(z, t, seed) -> [B, T, C, H, W]."""

    def __init__(self, G, max_t: float, truncation: float):
        super().__init__()
        from .models.motion import MotionMappingNetwork
        self.G = G
        self.truncation = truncation
        self.traj_len = MotionMappingNetwork.required_traj_len(G.cfg, max_t)

    def motion_z(self, seed: torch.Tensor, batch: int, device) -> torch.Tensor:
        return counter_normal(seed, (batch, self.traj_len, self.G.cfg.motion.z_dim), device)

    def frames(self, z, c, t, motion_z) -> torch.Tensor:
        img = self.G(z, c, t, motion_z=motion_z, noise_mode="const",
                     truncation_psi=self.truncation)
        return img.reshape(z.shape[0], t.shape[1], *img.shape[1:])

    def forward(self, z, t, seed):
        return self.frames(z, None, t, self.motion_z(seed, z.shape[0], z.device))


class ServedConditional(Served):
    """G's serving program with labels: forward(z, c, t, seed)."""

    def forward(self, z, c, t, seed):
        return self.frames(z, c, t, self.motion_z(seed, z.shape[0], z.device))


def build_export(G, batch: int, video_len: int, truncation: float,
                 max_t: Optional[float] = None):
    """Returns (exported, served): the ExportedProgram and the module it was
    traced from (for parity selftests), on G's device. The upfirdn2d passes
    are traced on the FIR_ROUTE, the plain ATen ops (see the module note)."""
    from .ops.upfirdn2d_kernel import aten_route
    device = next(G.parameters()).device
    cfg = G.cfg
    served = (ServedConditional if cfg.c_dim > 0 else Served)(
        G, float(video_len if max_t is None else max_t), truncation).eval()
    z = torch.zeros(batch, cfg.z_dim, device=device)
    t = torch.arange(video_len, dtype=torch.float32, device=device)[None].repeat(batch, 1)
    seed = torch.tensor(0, dtype=torch.int32, device=device)
    args = (z, torch.zeros(batch, cfg.c_dim, device=device), t, seed) if cfg.c_dim > 0 \
        else (z, t, seed)
    with torch.no_grad(), aten_route():
        exported = torch.export.export(served, args).run_decompositions()
    check_portable(exported)
    return exported, served


def check_portable(exported) -> None:
    """Raise unless every op of the graph is one of torch's own (ATen): a
    custom op or a host call of this package would not load without it."""
    foreign = sorted({str(node.target) for node in exported.graph.nodes
                      if node.op == "call_function"
                      and not (isinstance(node.target, torch._ops.OpOverload)
                               and node.target.namespace in ("aten", "prims"))
                      and not str(node.target).startswith("<built-in function")})
    if foreign:
        raise RuntimeError(f"the exported graph holds ops torch alone cannot run: {foreign}")


def selftest_inputs(cfg, batch: int, video_len: int, device):
    """The selftest's inputs, as the JAX script's: z from RandomState(0), t
    0..video_len-1, seed 7, class 0."""
    rng = np.random.RandomState(0)
    z = torch.from_numpy(rng.randn(batch, cfg.z_dim).astype(np.float32)).to(device)
    t = torch.arange(video_len, dtype=torch.float32, device=device)[None].repeat(batch, 1)
    seed = torch.tensor(7, dtype=torch.int32, device=device)
    if cfg.c_dim > 0:
        c = torch.zeros(batch, cfg.c_dim, device=device)
        c[:, 0] = 1.0
        return z, c, t, seed
    return z, t, seed


def main(argv: Optional[List[str]] = None) -> dict:
    """The CLI; returns the sidecar's contents (with the selftest's error)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True,
                    help="a snapshot (.pt), a run dir, or a reference .pkl")
    ap.add_argument("--out", required=True, help="output artifact path")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--video-len", type=int, default=16)
    ap.add_argument("--max-t", type=float, default=None,
                    help="largest timestamp the artifact must serve "
                         "(sizes the motion lattice; default: video-len)")
    ap.add_argument("--truncation", type=float, default=1.0)
    ap.add_argument("--selftest", action="store_true",
                    help="load the artifact back and check it reproduces "
                         "the direct forward pass")
    ap.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from .generate import load_any_checkpoint, pick_best_checkpoint
    from .training.loop import resolve_device
    from .utils.misc import float32_precision

    device = resolve_device(args.device)
    path = args.ckpt
    if os.path.isdir(path):                  # a run dir: its best or latest snapshot
        found = pick_best_checkpoint(path)
        if not found:
            raise FileNotFoundError(f"no snapshot found under {path}")
        path = found
    G = load_any_checkpoint(path, device)
    cfg = G.cfg

    exported, served = build_export(G, args.batch, args.video_len, args.truncation,
                                    max_t=args.max_t)
    torch.export.save(exported, args.out)
    inputs = {"z": [args.batch, cfg.z_dim]}
    if cfg.c_dim > 0:
        inputs["c"] = [args.batch, cfg.c_dim]
    inputs["t"] = [args.batch, args.video_len]
    inputs["seed"] = []
    meta = {
        "inputs": inputs,
        "output": [args.batch, args.video_len, cfg.img_channels, cfg.img_resolution,
                   cfg.img_resolution],
        "layout": "NCHW per frame: [batch, frame, channel, height, width]",
        "range": [-1.0, 1.0],
        "t_max": float(args.video_len if args.max_t is None else args.max_t),
        "truncation": args.truncation,
        "device": str(device),
        "fir_route": FIR_ROUTE,
    }
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"exported {os.path.getsize(args.out) / 1e6:.1f} MB torch.export artifact to "
          f"{args.out} (device {device})")

    if args.selftest:
        loaded = torch.export.load(args.out).module()
        inputs = selftest_inputs(cfg, args.batch, args.video_len, device)
        with torch.no_grad(), float32_precision(False):
            got = loaded(*inputs)
            want = served(*inputs)     # the direct forward the artifact was traced from
        err = float((got - want).abs().max())
        # The artifact's FIR passes are ATen convolutions and the direct
        # forward's are K2 on a card: both sum in float32 and round once to
        # the layer's dtype, in another order. bf16 synthesis blocks may
        # round otherwise in the decomposed graph; float32 models agree to
        # float-association noise
        tol = 1e-4 if cfg.num_bf16_res == 0 else 0.05
        if not err < tol:
            raise AssertionError(f"selftest mismatch: {err} (tol {tol})")
        meta["selftest_max_abs_err"] = err
        print(f"selftest OK: artifact output matches direct forward "
              f"(max abs err {err:.2e})")
    return meta


if __name__ == "__main__":
    main()
