"""The chip's published peaks, the yardstick of every share of a roofline
or of a peak. NVIDIA H100 SXM5 80 GB data sheet, dense rates without
sparsity, at its full 700 W power limit (a run prints the card's limit)."""

BF16_FLOPS_PER_S = 989e12     # bf16 and fp16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12     # HBM3


def fir_bound_s(nbytes: float) -> float:
    """The least time to move `nbytes` through HBM: a FIR pass does a few
    operations a byte, far below the float32 rate's ratio (20 a byte), so its
    bound is the bytes'."""
    return nbytes / HBM_BYTES_PER_S
