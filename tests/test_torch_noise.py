"""Per-layer noise in 'random' mode (models/generator.py:SynthesisLayer).

  * Over two gloo ranks (torchrun; the ranks run this file as a script,
    `--worker`, and import no jax), each layer's noise in the training step
    is the one-process step's draw, row for row: every rank draws the round's
    global frames and keeps its own (parallel/distributed.py:RowsDraws), as
    the JAX step draws over its global batch. Both ranks' G after the step
    equals the one-process step's within 1e-5 of scale.
  * The noise a layer adds is N(0, 1) times its noise_strength: per layer,
    mean and standard deviation within five standard errors.
"""
import os
import subprocess
import sys

import numpy as np
import torch

WORKER = __name__ == "__main__"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if WORKER:
    sys.path.insert(0, REPO)

from stylegan_v_tpu_torch.models import Discriminator, Generator  # noqa: E402
from stylegan_v_tpu_torch.models import generator as tgm  # noqa: E402
from stylegan_v_tpu_torch.models.config import (DiscriminatorConfig, GeneratorConfig,  # noqa: E402
                                                MotionConfig, SamplingConfig, TimeEncConfig)
from stylegan_v_tpu_torch.parallel import distributed as tdist  # noqa: E402
from stylegan_v_tpu_torch.training import loss as tloss  # noqa: E402
from stylegan_v_tpu_torch.training import train_step as tts  # noqa: E402

B, F, RES = 4, 3, 32
SAMPLING = SamplingConfig(num_frames_per_video=F, max_num_frames=128)
GCFG = GeneratorConfig(   # tests/test_models.py:small_gen_cfg with per-layer noise
    w_dim=64, z_dim=64, img_resolution=RES, channel_base=1024, channel_max=64, num_bf16_res=0,
    mapping_layers=2, use_noise=True,
    motion=MotionConfig(z_dim=32, v_dim=32, motion_z_distance=16, kernel_size=11),
    time_enc=TimeEncConfig(dim=32, min_period_len=16, max_period_len=1024), sampling=SAMPLING)
DCFG = DiscriminatorConfig(   # tests/test_models.py:small_disc_cfg
    img_resolution=RES, channel_base=1024, channel_max=64, num_bf16_res=0, concat_res=8,
    mbstd_group_size=2, mapping_layers=2, sampling=SAMPLING)


def models():
    gen = torch.Generator().manual_seed(41)
    G, D = Generator(GCFG, generator=gen), Discriminator(DCFG, generator=gen)
    with torch.no_grad():
        for i, (name, p) in enumerate(n for n in G.named_parameters()
                                      if n[0].endswith("noise_strength")):
            p.fill_(0.3 + 0.1 * i)
    return G, D


def batch():
    gen = torch.Generator().manual_seed(42)
    t = torch.sort(torch.randint(0, 60, (B, F), generator=gen).float(), dim=1).values
    t += torch.arange(F) * 0.1
    return {"real_img": torch.randint(0, 256, (B, F, 3, RES, RES), generator=gen,
                                      dtype=torch.uint8),
            "real_c": torch.zeros(B, 0), "real_t": t, "gen_c": torch.zeros(B, 3, 0),
            "gen_t": torch.stack([t + i for i in range(3)], dim=1)}


def step_noise(world):
    """One step with every phase but R1 on this rank's rows, drawing from a
    generator seeded alike everywhere; returns each layer call's noise draw
    and G's parameters after the step."""
    G, D = models()
    tcfg = tts.TrainingConfig(batch_size=B)
    opt = tts.OptimizerConfig()
    state = tts.init_train_state(G, D, opt, opt, tcfg, world=world)
    step = tts.make_train_step(G, D, tloss.LossConfig(pl_weight=2.0, r1_gamma=0.5), tcfg,
                               world=world)
    data = batch()
    if world.size > 1:
        rows = tdist.row_plan(B, 1, 2, world.size, world.rank).batch
        data = {k: v[torch.as_tensor(rows)] for k, v in data.items()}
    draws, orig = [], tgm.draw_noise

    def recording(source, shape, device):
        draws.append(orig(source, shape, device))
        return draws[-1]

    tgm.draw_noise = recording
    try:
        step(state, data, generator=torch.Generator().manual_seed(5), do_gpl=True)
    finally:
        tgm.draw_noise = orig
    return draws, {k: v.clone() for k, v in G.state_dict().items()}


if WORKER:
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    world = tdist.init_distributed("gloo", rank, int(os.environ["WORLD_SIZE"]), "env://",
                                   torch.device("cpu"))
    try:
        torch.save(step_noise(world), f"{sys.argv[2]}.{rank}")
    finally:
        tdist.destroy_distributed()
    sys.exit(0)


# ============================================================ the test process


PORT_TOL = 1e-5          # two ranks against one process: float32, sum order only


def test_two_ranks_draw_one_process_noise_row_for_row(tmp_path):
    out = str(tmp_path / "noise")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes=1", "--nproc_per_node=2",
         "--master_addr=localhost", f"--master_port={tdist.free_port()}",
         os.path.abspath(__file__), "--worker", out],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want, want_G = step_noise(tdist.World())
    finally:
        torch.set_num_threads(n)
    layers = sum(1 for k in want_G if k.endswith("noise_strength"))
    # Gmain, Gpl (half the videos) and Dgen: one draw a layer each
    assert [len(d) for d in want] == [B * F] * layers + [B * F // 2] * layers + [B * F] * layers
    for rank in range(2):
        got, got_G = torch.load(f"{out}.{rank}", weights_only=True)
        plan = tdist.row_plan(B, 1, 2, 2, rank, pl_batch_shrink=2)
        k = len(plan.rows) // 2
        for i, (g, w) in enumerate(zip(got, want)):
            rows = plan.rows if len(w) == B * F else plan.rows[:k]
            assert torch.equal(g, w[torch.as_tensor(tdist.frame_rows(rows, F))]), (rank, i)
        assert len(got) == len(want)
        scale = max(float(w.abs().max()) for w in want_G.values())    # G's, as in
        for name, w in want_G.items():                               # test_torch_parallel
            assert float((got_G[name] - w).abs().max()) <= PORT_TOL * scale, (rank, name)


def test_random_noise_is_standard_normal_times_the_strength(monkeypatch):
    G, _ = models()
    strengths = [float(p.detach()) for name, p in G.named_parameters()
                 if name.endswith("noise_strength")]
    added, orig = [], tgm.modulated_conv2d

    def recording(*args, noise=None, **kw):
        if noise is not None:
            added.append(noise.detach())
        return orig(*args, noise=noise, **kw)

    monkeypatch.setattr(tgm, "modulated_conv2d", recording)
    gen = torch.Generator().manual_seed(6)
    n_videos = 8
    z = torch.randn(n_videos, GCFG.z_dim, generator=gen)
    t = torch.arange(n_videos * F, dtype=torch.float32).reshape(n_videos, F)
    with torch.no_grad():
        G(z, None, t, noise_mode="random", generator=gen)
    assert len(added) == len(strengths) > 4
    for noise, s in zip(added, strengths):
        n = noise.numel()
        assert noise.shape[:2] == (n_videos * F, 1)
        assert abs(float(noise.mean())) <= 5 * s / np.sqrt(n), (s, float(noise.mean()))
        assert abs(float(noise.std()) / s - 1) <= 5 / np.sqrt(2 * n), (s, float(noise.std()))
        assert not torch.equal(noise[0], noise[1])                  # every frame its own
