"""peak_mem_gib.<mix>: torch.cuda.max_memory_allocated over the window,
after reset_peak_memory_stats at its start, in GiB: what bounds the batch a
card can hold."""


def read(ctx):
    peak = ctx.get("window_peak", 0)
    return peak / 2 ** 30 if peak else None
