"""train_frames_per_s: every frame the training step consumed in the window
(videos x frames a step, over whole R1 intervals) over the window's time on
the host clock, each interval ended by a synchronisation."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx["frames"] / ctx["window_s"]
