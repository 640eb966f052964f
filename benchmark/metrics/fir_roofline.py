"""fir_roofline.<mix>: the FIR resampling kernels' share of their HBM
roofline over the traced window: 100 x the least time that every
upfirdn2d call of the traced steps or batches needs to read its input and
write its output once at 3.35 TB/s (count/work.py's bytes), over the device
time of the kernels that do that work (K2, K1 and K1-bwd, and any plain
depthwise convolution)."""
from ..count.peaks import fir_bound_s
from ..lib.trace import FIR_CLASSES


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    spent = sum(tr["by_class"].get(c, 0.0) for c in FIR_CLASSES)
    nbytes = ctx["work"]().get("traced_fir_bytes")
    if spent <= 0 or not nbytes:
        return None
    return 100.0 * fir_bound_s(nbytes) / spent
