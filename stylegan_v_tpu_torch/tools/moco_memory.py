"""Peak device memory of the MoCoGAN training step at each training.batch_gpu.

    python -m stylegan_v_tpu_torch.tools.moco_memory 16 8 4

For each batch_gpu given, builds the MoCoGAN slice's step (`slice_setup`:
configs/experiments.yaml's mocogan_baseline/b16_mnf16 at 256^2, 16 videos of
16 consecutive frames, bgc ADA at p 0.5, seeded weights; chip_smoke.py phase
17 runs it too), runs one step with R1 and one without on seeded uint8
frames (the first steps: they include the warm-up), and prints one JSON line:
the peak of torch.cuda.max_memory_allocated in GiB and each step's ms, or
the out-of-memory error. It measures on the card only; nothing falls back to
the CPU.
"""
from __future__ import annotations

import json
import sys
import time

# configs/experiments.yaml's mocogan_baseline/b16_mnf16 at 256^2, with clips of
# 16 consecutive frames (PERF.md section 4 says why)
OVERRIDES = ["model=mocogan", "training.batch_size=16", "dataset.max_num_frames=16",
             "sampling=uniform", "sampling.num_frames_per_video=16"]
SHAPE = (16, 16, 256)          # videos, frames, resolution of a step


def slice_setup(batch_gpu: int, extra=(), run_dir=None):
    """The slice's TrainSetup at `batch_gpu` videos a round, composed from
    configs/ by the entry point's code (`extra`: more overrides)."""
    from ..train import CONFIG_DIR
    from ..train_setup import setup_training
    from ..utils import config as cfglib
    cfg = cfglib.load_config(CONFIG_DIR, OVERRIDES + [f"training.batch_gpu={batch_gpu}"]
                             + list(extra))
    return setup_training(cfg, dataset_resolution=SHAPE[2], dataset_c_dim=0, run_dir=run_dir)


def slice_batch(device, seed: int = 17) -> dict:
    """A step's batch: 16 videos of 16 consecutive seeded uint8 frames."""
    import torch
    B, F, res = SHAPE
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(F, device=device, dtype=torch.float32).repeat(B, 1)
    return {"real_img": torch.randint(0, 255, (B, F, 3, res, res), generator=g, device=device,
                                      dtype=torch.uint8),
            "real_c": torch.zeros(B, 0, device=device), "real_t": t,
            "gen_c": torch.zeros(B, 3, 0, device=device), "gen_t": torch.stack([t, t, t], dim=1)}


def slice_step(setup, device, augment_p: float = 0.5, seed: int = 0):
    """The slice's seeded G and D (from `setup`, seeded with `seed`) on
    `device`, their TrainState at `augment_p` and the step with the setup's
    ADA pipe: (state, step)."""
    import torch
    from ..models import Generator
    from ..training import init_train_state, make_augment_pipe, make_train_step
    from ..training.loop import build_discriminator

    gen = torch.Generator().manual_seed(seed)
    G = Generator(setup.gen_cfg, generator=gen).to(device)
    D = build_discriminator(setup, gen).to(device)
    state = init_train_state(G, D, setup.opt_g, setup.opt_d, setup.train_cfg,
                             augment_p=augment_p)
    step = make_train_step(G, D, setup.loss_cfg, setup.train_cfg,
                           augment_fn=make_augment_pipe(setup.augment_cfg))
    return state, step


def probe(batch_gpu: int, device) -> dict:
    import torch
    out = {"batch_gpu": batch_gpu}
    try:
        state, step = slice_step(slice_setup(batch_gpu), device)
        g = torch.Generator(device=device).manual_seed(1)
        batch = slice_batch(device)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        for do_dr1 in (True, False):
            t0 = time.perf_counter()
            step(state, batch, generator=g, do_dr1=do_dr1)
            torch.cuda.synchronize(device)
            out[f"ms_{'r1' if do_dr1 else 'main'}"] = (time.perf_counter() - t0) * 1e3
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    except torch.cuda.OutOfMemoryError as e:
        out["out_of_memory"] = str(e).splitlines()[0]
    return out


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("moco_memory: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    for batch_gpu in [int(a) for a in (sys.argv[1:] if argv is None else argv)]:
        print(json.dumps(probe(batch_gpu, device)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
