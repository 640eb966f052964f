"""The work a cell's unit asks of the chip, counted on the meta device from
the configuration's shapes alone: the reference's models run there, where
nothing is computed and every shape is.

FLOPs: the convolutions and matrix products that PyTorch's autograd runs for
the unit, 2 per multiply-add, as torch.utils.flop_counter counts them: a
forward pass, each input gradient and weight gradient a backward asks for
(`backward(inputs=...)` asks only for the phase's own network's weights), and
R1's input gradient with that gradient's own backward. The FIR filter passes
(depthwise convolutions of one channel a group) are left out here and
counted as bytes instead.

FIR bytes: every upfirdn2d call of the unit, forward and every order of its
adjoint, as the reference records it (`reference/ops.py:fir_calls`): its
input read once and its output written once, in the dtype of the call
(bfloat16 in the top four resolutions and in the augment pipe's geometry,
as on the card)."""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten


def _skip_depthwise(formula, x_pos: int, w_pos: int):
    """The registry's formula, but 0 for a depthwise (FIR) convolution."""
    def count(*args, **kwargs):
        x_shape, w_shape = args[x_pos].shape, args[w_pos].shape
        if len(w_shape) >= 2 and w_shape[1] == 1 and x_shape[1] > 1:
            return 0
        return formula(*args, **kwargs)
    return count


_CONVS = {aten.convolution: (0, 1), aten._convolution: (0, 1),
          aten.convolution_backward: (1, 2)}
_FORMULAS = {op: (_skip_depthwise(f, *_CONVS[op]) if op in _CONVS else f)
             for op, f in flop_registry.items()}


class _Counter(TorchDispatchMode):
    """Sums torch.utils.flop_counter's formulas over every op dispatched
    inside it (FlopCounterMode's arithmetic without its module hooks)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.by_op: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = _FORMULAS.get(func._overloadpacket)
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            self.flops += n
            name = str(func._overloadpacket)
            self.by_op[name] = self.by_op.get(name, 0) + n
        return out


def _fir_bytes(calls) -> int:
    return sum((_numel(c.in_shape) + _numel(c.out_shape)) * torch.empty((), dtype=c.dtype)
               .element_size() for c in calls)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _meta_models(plain: Dict):
    from ..reference import build_models
    G, D = build_models(plain, "meta")
    return G, D


def train_work(plain: Dict, videos: int) -> Dict[str, float]:
    """FLOPs and FIR bytes of one main step and of one R1 step (the main
    step's phases and Dr1) at `videos` videos a chip."""
    from ..lib.traffic import MetaDraws, motion_len
    from ..reference.step import Trainer
    G, D = _meta_models(plain)
    tr = Trainer(G, D, plain["loss_cfg"], plain["train_cfg"], plain["opt_g"], plain["opt_d"],
                 plain["augment_cfg"], 0.5)
    tr.opt_G.step = tr.opt_D.step = lambda *a, **k: None     # Adam computes no FLOP
    gcfg = plain["gen_cfg"]
    F, R = gcfg["sampling"]["num_frames_per_video"], gcfg["img_resolution"]
    meta = dict(device="meta")
    batch = {"real_img": torch.empty(videos, F, 3, R, R, dtype=torch.uint8, **meta),
             "real_t": torch.empty(videos, F, **meta),
             "gen_t": torch.empty(videos, 3, F, **meta)}
    L = motion_len(gcfg)
    src = MetaDraws()
    draws = {n: {"z": torch.empty(videos, gcfg["z_dim"], **meta),
                 "motion_z": torch.empty(videos, L, gcfg["motion"]["z_dim"], **meta)}
             for n in ("Gmain", "Dgen")}
    for n in ("Gmain", "Dgen", "Dreal", "Dr1"):
        draws.setdefault(n, {}).update(augment=[src], d_noise=[src])
    out = {}
    from ..reference.ops import fir_calls
    for key, do_dr1 in (("main", False), ("r1", True)):
        with _Counter() as fc, fir_calls() as calls:
            tr.step(batch, draws, do_dr1)
        out[f"{key}_flops"] = float(fc.flops)
        out[f"{key}_fir_bytes"] = float(_fir_bytes(calls))
    return out


def synth_work(plain: Dict, clips: int, frames: int) -> Dict[str, float]:
    """FLOPs and FIR bytes of one G forward of `clips` clips x `frames` frames."""
    from ..lib.traffic import motion_len
    from ..reference.ops import fir_calls
    G, _ = _meta_models(plain)
    gcfg = plain["gen_cfg"]
    z = torch.empty(clips, gcfg["z_dim"], device="meta")
    t = torch.empty(clips, frames, device="meta")
    mz = torch.empty(clips, motion_len(gcfg, float(frames - 1)), gcfg["motion"]["z_dim"],
                     device="meta")
    with torch.no_grad(), _Counter() as fc, fir_calls() as calls:
        G(z, None, t, motion_z=mz, noise_mode="const")
    return {"batch_flops": float(fc.flops), "batch_fir_bytes": float(_fir_bytes(calls))}
