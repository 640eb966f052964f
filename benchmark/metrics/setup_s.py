"""setup_s: seconds from the start of the process (the first statement of
run.py) to the start of the measured window: imports, the kernels' build
where it is not in the checkout yet, the models made on the device from the
seed, and the warm-up (the train mix's three checked steps, the synth mix's
warm-up batches)."""


def read(ctx):
    return ctx["setup_s"]
