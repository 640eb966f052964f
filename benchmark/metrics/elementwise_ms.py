"""elementwise_ms.<mix>: device time a step of the kernels that the
program's tools/profile_split.py classes as "elementwise and reductions"
(bias_act, modulated_conv2d's scalings, conv2d_resample's pads and copies,
the optimizer), over the traced R1 interval."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or ctx["kind"] != "train":
        return None
    s = tr["by_class"].get("elementwise and reductions", 0.0)
    return 1e3 * s / ctx["traced_units"] if s > 0 else None
