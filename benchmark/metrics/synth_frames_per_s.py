"""synth_frames_per_s: every frame G made and the host received in the
window, over the window's time on the host clock."""


def read(ctx):
    if ctx["kind"] != "synth":
        return None
    return ctx["frames"] / ctx["window_s"]
