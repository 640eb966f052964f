"""r1_step_ms.<mix>: the mean over the window's R1 steps of the step's time
between CUDA events recorded before and after it is dispatched (the device
runs it between them, behind what was queued before)."""


def read(ctx):
    ms = ctx.get("r1_ms") or []
    return sum(ms) / len(ms) if ms else None
