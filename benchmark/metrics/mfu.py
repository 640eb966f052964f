"""mfu.<mix>: the share of the card's bf16 dense peak that the window's
required FLOPs reach: 100 x FLOPs done / window seconds / peak. The FLOPs
are count/work.py's (the configuration's convolutions and matrix products,
forward and the gradients the step needs, R1's second order, FIR passes
left out), for every step or batch of the untraced window."""
from ..count.peaks import BF16_FLOPS_PER_S


def read(ctx):
    flops = ctx["work"]().get("window_flops")
    if not flops:
        return None
    return 100.0 * flops / ctx["window_s"] / BF16_FLOPS_PER_S
