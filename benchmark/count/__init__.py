"""The yardstick's arithmetic: the chip's peaks, the required FLOPs of a
step or a batch and the bytes of its FIR resampling, from shapes alone."""
