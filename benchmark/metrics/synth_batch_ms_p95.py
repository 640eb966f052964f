"""synth_batch_ms_p95: the 95th percentile (nearest rank) over every batch
of the window of the time the one client waits for a batch: on the host
clock, from the previous batch's frames reaching the client (or from the
window's start) to this batch's frames reaching it."""
import math


def read(ctx):
    ms = sorted(ctx.get("batch_ms") or [])
    if ctx["kind"] != "synth" or not ms:
        return None
    return ms[math.ceil(0.95 * len(ms)) - 1]
