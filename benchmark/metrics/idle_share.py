"""idle_share.<mix>: the share of the traced window in which no operation
ran on the device, 100 x (1 - busy / window), busy being the union of the
intervals of every device operation (kernels, copies, fills) in the
profiler's trace, so that overlapping kernels count once."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
