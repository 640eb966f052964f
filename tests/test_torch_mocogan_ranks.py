"""MoCoGAN over several ranks on the CPU over gloo, held to the JAX package's
MoCoGAN step and to the port's one-process step, at
tests/test_torch_mocogan.py's config (64^2, 3 frames, num_t_paddings 6, small
widths, the LSTM G), with JAX's draws and the video D's noise replayed.

  (a) The image D's minibatch-std rows: mbstd_group counts the image D's
      group of 4 frames in videos (parallel/distributed.py says why), the
      image D on a rank's frames equals the JAX MoCoGAN D's image logits on
      the global batch at those frames, and a round that does not split into
      4 x W videos raises before a step. rank_draws hands a rank its rows of
      the video D's global noise.
  (b) The MoCoGAN D on each rank's rows with the world (the video D's batch
      norms over both ranks) equals the JAX D on the global 8 videos within
      FP32_TOL; with local statistics (no world) the video logits miss by
      more than 10x that: the fault the world repairs.
  (c) The JAX MoCoGAN step on a 2-device CPU mesh equals its single-device
      step within TOL, for one step with every phase at B = 8: the global
      batch statistics are the reference's math.
  (d) Two gloo ranks at B = 8 in one round equal the JAX single-device step
      with R1 and the 0.1x group, from the same JAX state: G, D, G_ema, the
      scalars and the stats within TOL; Adam's moments of the video D and of
      G's synthesis within VIDEO_TOL, the rest within TOL
      (tests/test_torch_mocogan.py's docstring says why). D's input from G
      takes the JAX frames' values at the rank's rows, as that file's
      `pin_frames` does; the frames are checked within TOL first.
  (e) Two ranks at B = 16 in two rounds of 8, with the bgc pipe, equal the
      port's one-process step on the same global batch and draws within 1e-5
      of scale (the sum order differs). Each rank issues the video D's
      all_reduces as the code derives them, in (d) (with R1) and (e); one
      process issues none.
  (f) ZeRO-1 on two ranks equals plain Adam to the bit over two steps with a
      consolidated snapshot and a resume between them; both groups keep their
      lr in the snapshot and after the resume, on both ranks.
  (g) `python -m stylegan_v_tpu_torch.train model=mocogan num_gpus=2 --device
      cpu` at narrow widths: steps, snapshots rank 0 alone writes, a resume
      from latest whose snapshot holds both groups, both logit streams in
      stats.jsonl.

The ranks are subprocesses running this file as a script (`--worker`); they
import torch and the port, never jax. The work that needs nothing of JAX, (e)
(the ranks and the one process) and (f) and (g), starts with the module's
first test and runs while the test process computes the JAX side; then the
test process writes the inputs, the JAX state's pieces and the global draws
for (b) and (d) to a file under tmp_path, starts their two ranks and runs the
JAX mesh step (c) meanwhile.
"""
import contextlib
import os
import subprocess
import sys

import numpy as np
import torch

WORKER = __name__ in ("__main__", "__mp_main__")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if WORKER:
    sys.path.insert(0, REPO)

from stylegan_v_tpu_torch.io.checkpoint import (load_adam_state, load_snapshot,  # noqa: E402
                                                restore_train_state, save_snapshot)
from stylegan_v_tpu_torch.models import (Generator, MoCoGANDiscriminator,  # noqa: E402
                                         batch_statistics_over)
from stylegan_v_tpu_torch.parallel import distributed as tdist  # noqa: E402
from stylegan_v_tpu_torch.parallel import zero as tzero  # noqa: E402
from stylegan_v_tpu_torch.training import augment as taug  # noqa: E402
from stylegan_v_tpu_torch.training import loss as tloss_mod  # noqa: E402
from stylegan_v_tpu_torch.training import train_step as tts  # noqa: E402
from stylegan_v_tpu_torch.utils.summary import (check_replica_consistency,  # noqa: E402
                                                train_state_tree)

W = 2
WORKER_TIMEOUT_S = 600


class Replay:
    """A draw source handing out recorded normals (NCDHW tensors) in order."""

    def __init__(self, arrays):
        self.arrays = iter(arrays)

    def randn(self, shape):
        x = next(self.arrays)
        assert tuple(x.shape) == tuple(shape), (tuple(x.shape), tuple(shape))
        return x


def replayed(draws):
    """A step's draws with each recorded video D noise source as a Replay."""
    return {phase: {k: ([Replay(r) for r in v] if k == "d_noise" else v)
                    for k, v in d.items()} for phase, d in draws.items()}


def make_D(task, generator=None):
    return MoCoGANDiscriminator(task["disc_cfg"], video_discr_num_t_paddings=task["ntp"],
                                generator=generator)


def build(task, run, world, zero1=False):
    """A run's state and step as a rank of `world`: from `run["start"]` (a
    JAX state's pieces, Adam's moments included) or from weights seeded with
    `run["seed"]`; D's Adam takes D's lr_scale_map, two groups."""
    start = run.get("start")
    gen = None if start else torch.Generator().manual_seed(run["seed"])
    G, D = Generator(task["gen_cfg"], generator=gen), make_D(task, gen)
    if start:
        G.load_state_dict(start["params_G"])
        D.load_state_dict(start["params_D"])
    tcfg = tts.TrainingConfig(**task["train"], batch_size=run["B"],
                              batch_chip=run["batch_chip"], zero1=zero1)
    opt = tts.OptimizerConfig(**task["opt"])
    state = tts.init_train_state(G, D, opt, opt, tcfg, world=world,
                                 augment_p=start["augment_p"] if start else task["aug_p"])
    if start:
        state.G_ema.load_state_dict(start["params_Gema"])
        for name in ("opt_G", "opt_D"):
            load_adam_state(getattr(state, name), start[name])
        state.ada_sign_acc.fill_(start["ada_sign_acc"])
        state.step, state.cur_nimg = start["step"], start["cur_nimg"]
    pipe = taug.make_augment_pipe(taug.AugmentConfig(**task["aug"])) if run["augment"] else None
    step = tts.make_train_step(G, D, tloss_mod.LossConfig(**task["loss"]), tcfg,
                               augment_fn=pipe, world=world)
    return state, step


def plan_of(run, D, world):
    rounds = run["B"] // (run["batch_chip"] or run["B"])
    N = run["B"] // rounds
    return tdist.row_plan(run["B"], rounds, tdist.mbstd_group(D, N, world.size), world.size,
                          world.rank)


def local_batch(batch, plan):
    return {k: v[torch.as_tensor(plan.batch)] for k, v in batch.items()}


def snapshot(state, stats):
    """What a run compares after a step."""
    return {"G": {k: v.clone() for k, v in state.G.state_dict().items()},
            "D": {k: v.clone() for k, v in state.D.state_dict().items()},
            "G_ema": {k: v.clone() for k, v in state.G_ema.state_dict().items()},
            "scalars": {k: getattr(state, k).clone()
                        for k in ("pl_mean", "augment_p", "ada_sign_acc")},
            "stats": {k: v.detach().clone() for k, v in stats.items()}}


def forward_on_rows(task, world):
    """(b): the MoCoGAN D on this rank's rows of the global videos, with the
    world and with local statistics, and the all_reduces each issued."""
    f = task["forward"]
    D = make_D(task)
    D.load_state_dict(f["params_D"])
    N, frames = f["t"].shape
    plan = tdist.row_plan(N, 1, tdist.mbstd_group(D, N, world.size), world.size, world.rank)
    img = f["img"][torch.as_tensor(tdist.frame_rows(plan.rows, frames))]
    t = f["t"][torch.as_tensor(plan.rows)]
    out = {"rows": plan.rows}
    for name, ctx in (("world", batch_statistics_over(D, world)),
                      ("local", contextlib.nullcontext())):
        tdist.all_reduce_sum.calls = 0
        with torch.no_grad(), ctx:
            logits = D(img, None, t, noise=tdist.RowsDraws(Replay(f["noise"]), plan.rows, N))
        out[name] = {k: v.clone() for k, v in logits.items()}
        out[f"{name}_calls"] = tdist.all_reduce_sum.calls
    return out


def jax_step_on_rows(task, world):
    """(d): the JAX state's step on this rank's rows of the JAX batch and
    draws, D's input from G pinned to the rank's rows of the JAX frames."""
    run = task["jax"]
    state, step = build(task, run, world)
    plan = plan_of(run, state.D, world)
    frames = torch.as_tensor(tdist.frame_rows(plan.rows, task["frames"]))
    want = [x[frames] for x in run["frames"]]        # Gmain's, then Dgen's
    errs = []
    synthesis = tloss_mod.GANLoss.run_synthesis

    def pinned(self, *args, **kwargs):
        img = synthesis(self, *args, **kwargs)
        jimg = want.pop(0)
        errs.append(float((img - jimg).abs().max()) / float(jimg.abs().max()))
        return img + (jimg - img).detach()

    tloss_mod.GANLoss.run_synthesis = pinned
    tdist.all_reduce_sum.calls = 0
    try:
        state, stats = step(state, local_batch(run["batch"], plan), do_dr1=True,
                            draws=replayed(run["draws"]))
    finally:
        tloss_mod.GANLoss.run_synthesis = synthesis
    out = snapshot(state, stats)
    out.update(frame_errs=errs, unpinned=len(want), opt_G=state.opt_G.state_dict(),
               opt_D=state.opt_D.state_dict(), calls=tdist.all_reduce_sum.calls)
    return out


def rounds_step(task, world):
    """(e) and the one-process side of it: one step from seeded weights and
    draws; with the all_reduces the step issued."""
    run = task["rounds"]
    state, step = build(task, run, world)
    batch = run["batch"] if world.size == 1 else local_batch(run["batch"], plan_of(
        run, state.D, world))
    tdist.all_reduce_sum.calls = 0
    state, stats = step(state, batch, generator=torch.Generator().manual_seed(run["draw_seed"]))
    return dict(snapshot(state, stats), calls=tdist.all_reduce_sum.calls)


def zero_steps(task, world):
    """(f): two steps with plain Adam, and with ZeRO-1 the first, a
    consolidated snapshot, a restore into a fresh state and the second."""
    run = task["zero"]
    state, step = build(task, run, world)
    batch = local_batch(run["batch"], plan_of(run, state.D, world))
    out = {"plain": []}
    for do_dr1, seed in run["plan"]:
        state, stats = step(state, batch, do_dr1=do_dr1,
                            generator=torch.Generator().manual_seed(seed))
        out["plain"].append(snapshot(state, stats))
    (dr1_a, seed_a), (dr1_b, seed_b) = run["plan"]
    zstate, zstep = build(task, run, world, zero1=True)
    zstate, stats = zstep(zstate, batch, do_dr1=dr1_a, generator=torch.Generator().manual_seed(seed_a))
    out["zero"] = [snapshot(zstate, stats)]
    out["zero_bytes"] = tzero.opt_state_bytes_per_device(zstate)
    out["plain_bytes"] = tzero.opt_state_bytes_per_device(state)
    tzero.consolidate_optimizers_(zstate)
    if world.is_chief:
        save_snapshot(task["tmp"], zstate, zstate.cur_nimg, configs={})
    torch.distributed.barrier()
    payload, _ = load_snapshot(os.path.join(task["tmp"], "network-snapshot-000000.pt"))
    fresh, fstep = build(task, run, world, zero1=True)
    restore_train_state(fresh, payload)
    out["snapshot_lrs"] = [g["lr"] for g in payload["opt_D"]["param_groups"]]
    out["restored_lrs"] = [g["lr"] for g in fresh.opt_D.param_groups]
    fresh, stats = fstep(fresh, batch, do_dr1=dr1_b, generator=torch.Generator().manual_seed(seed_b))
    out["zero"].append(snapshot(fresh, stats))
    out["consistent"] = check_replica_consistency(train_state_tree(fresh), world)
    return out


# the checks of each pair of ranks: those without JAX's inputs, and those with
CHECKS = {"port": {"rounds": rounds_step, "zero": zero_steps},
          "jax": {"forward": forward_on_rows, "jax": jax_step_on_rows}}


def worker_ranks(task, checks, rank, init_method, out_path):
    """One rank of a pair: its `checks` (a key of CHECKS)."""
    world = tdist.init_distributed("gloo", rank, W, init_method, torch.device("cpu"),
                                   timeout_s=WORKER_TIMEOUT_S)
    try:
        torch.save({name: fn(task, world) for name, fn in CHECKS[checks].items()}, out_path)
    finally:
        tdist.destroy_distributed()


def worker_loop(args, kimgs):
    """(g): the entry point, two ranks on the CPU, its setup's kimg cut to a
    few steps (the config's kimg is an int), then resumed from latest."""
    import dataclasses

    from stylegan_v_tpu_torch import train, train_setup
    setup_training = train_setup.setup_training
    for kimg, extra in zip(kimgs, ([], ["training.resume=latest"])):
        train_setup.setup_training = lambda *a, _k=kimg, **kw: dataclasses.replace(
            setup_training(*a, **kw), total_kimg=_k)
        assert train.main(args + extra) is None      # the ranks ran in their processes


if WORKER and __name__ == "__main__":
    torch.set_num_threads(1)
    mode = sys.argv[2]
    task = torch.load(sys.argv[3], weights_only=False)
    torch.manual_seed(1234)                  # the global RNG must not matter
    if mode == "loop":
        worker_loop(task["args"], task["kimgs"])
    elif mode == "single":                   # (e)'s one process
        torch.save(rounds_step(task, tdist.World()), sys.argv[4])
    else:
        worker_ranks(task, mode, int(sys.argv[4]), sys.argv[5], sys.argv[6])
    sys.exit(0)


# ============================================================ the test process

if not WORKER:
    import json
    import types

    import jax
    import jax.numpy as jnp
    import pytest

    from stylegan_v_tpu.models import Generator as JGenerator
    from stylegan_v_tpu.models import mocogan as jmoco
    from stylegan_v_tpu.parallel import create_mesh, replicated_sharding, shard_batch
    from stylegan_v_tpu.training import train_step as jts
    from stylegan_v_tpu_torch.io import (jax_to_torch_discriminator, jax_to_torch_generator,
                                         jax_to_torch_train_state)
    from stylegan_v_tpu_torch.parallel.distributed import World
    from test_data import build_video_dataset_zip
    from test_torch_mocogan import (F, LOOP_ARGS, MDCFG, MGCFG, MLOSS, MTRAIN, NTP, OPT, RES,
                                    JaxVideoNoise, assert_moments_close, ncdhw)
    from test_torch_models import FP32_TOL, assert_close, nchw, port_cfg
    from test_torch_train import (AUG, TOL, JaxDraws, assert_stats_close, assert_tree_close,
                                  one_torch_thread)

    __all__ = ["one_torch_thread"]        # the fixture, from test_torch_train.py

    B = 8                                 # (a)-(d): one round of 8 videos, 4 a rank
    ROUNDS_B, ROUNDS_CHIP = 16, 8         # (e): two rounds of 8
    PORT_TOL = 1e-5                       # (e): two ranks against one process, sum order only
    TRAIN = {k: v for k, v in MTRAIN.items() if k != "batch_size"}

    def batch_of(seed, n=B):
        """n videos of F frames at RES^2, seeded, in both layouts (JAX's, the
        port's): test_torch_train.py's make_batch at n."""
        r = np.random.RandomState(seed)
        t = np.sort(r.randint(0, 60, size=(n, F)).astype(np.float32), axis=1)
        t += np.arange(F)[None] * 0.1
        jbatch = {"real_img": r.randint(0, 255, size=(n, F, RES, RES, 3)).astype(np.uint8),
                  "real_c": np.zeros((n, 0), np.float32), "real_t": t,
                  "gen_c": np.zeros((n, 3, 0), np.float32),
                  "gen_t": np.stack([t + i for i in range(3)], axis=1).astype(np.float32)}
        tbatch = {k: torch.from_numpy(v) for k, v in jbatch.items()}
        tbatch["real_img"] = torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(jbatch["real_img"], -1, 2)))
        return jbatch, tbatch

    def port_modules():
        return Generator(port_cfg(MGCFG)), MoCoGANDiscriminator(
            port_cfg(MDCFG), video_discr_num_t_paddings=NTP)

    @pytest.fixture(scope="module")
    def jax_side():
        """The JAX MoCoGAN at B = 8: its first state, its single-device step,
        the draws, the video D's noise recorder (with the D's output: one
        compiled forward for (a), (b) and the step's noise) and G's eager
        frames."""
        JG = JGenerator(MGCFG)
        JD = jmoco.MoCoGANDiscriminator(MDCFG, video_discr_num_t_paddings=NTP)
        tcfg = jts.TrainingConfig(**dict(MTRAIN, batch_size=B))
        opt = jts.OptimizerConfig(**OPT)
        state = jts.init_train_state(jax.random.PRNGKey(0), JG, JD, opt, opt, tcfg,
                                     d_lr_scales=JD.lr_scale_map)

        def step_fn(mesh=None):
            return jts.make_train_step(JG, JD, jts.LossConfig(**MLOSS), opt, opt, tcfg,
                                       donate=False, d_lr_scales=JD.lr_scale_map, mesh=mesh)

        draws = JaxDraws(JG, {"params": state.params_G, **state.extra_G}, cfg=MGCFG, batch=B,
                         loss=MLOSS)
        noise = JaxVideoNoise(lambda v, k, img, t: JD.apply(v, img, None, t, rngs={"noise": k}),
                              output=True)
        frames = lambda v, z, t, mz: JG.apply(v, z, None, t, motion_z=mz)   # noqa: E731
        return types.SimpleNamespace(state=state, step_fn=step_fn, draws=draws, noise=noise,
                                     frames=frames)

    @pytest.fixture(scope="module")
    def forward(jax_side):
        """(a), (b): 8 videos of 3 frames and the JAX MoCoGAN D on them, its
        video D's noise recorded, from the first state's D."""
        r = np.random.RandomState(2)
        img = r.randn(B * F, RES, RES, 3).astype(np.float32)
        t = np.sort(r.randint(0, 9, size=(B, F)), axis=1).astype(np.float32)
        variables = {"params": jax_side.state.params_D}
        noise, want = jax_side.noise(variables, jax.random.PRNGKey(3), img, t)
        return {"img": nchw(img), "t": torch.from_numpy(t),
                "noise": [ncdhw(a) for a in noise.arrays],
                "params_D": jax_to_torch_discriminator(variables),
                "want": {k: np.asarray(v) for k, v in want.items()}}

    # ------------------------------------------------- (a) the image D's rows

    def test_mbstd_group_counts_the_image_d_group_in_videos():
        """The group of 4 frames, counted in videos; a round of N videos must
        split into 4 x W, and the step says so before it runs; rank_draws
        gives a rank its rows of each global video D noise draw."""
        G, D = port_modules()
        assert tdist.mbstd_group(D, B, W) == D.image_discr.b4.mbstd.group_size == 4
        assert tdist.mbstd_group(D, 4) == 4
        for N, ranks in ((4, 2), (12, 2), (8, 4)):
            with pytest.raises(ValueError, match="image discriminator's minibatch-std group of 4"):
                tdist.mbstd_group(D, N, ranks)
        with pytest.raises(ValueError, match="group of 4"):
            tts.make_train_step(G, D, tloss_mod.LossConfig(**MLOSS),
                                tts.TrainingConfig(**TRAIN, batch_size=12),
                                world=World(0, W, "gloo"))
        plan = tdist.row_plan(B, 1, 4, W, 1)
        source = taug.GeneratorDraws(torch.Generator().manual_seed(5))
        mine = tdist.rank_draws({"Dreal": {"d_noise": [source]}}, plan, F)["Dreal"]["d_noise"]
        whole = torch.randn((B, 3, F, 4, 4), generator=torch.Generator().manual_seed(5))
        assert torch.equal(mine[0].randn((B // W, 3, F, 4, 4)), whole[torch.as_tensor(plan.rows)])

    @pytest.mark.parametrize("rank", [0, 1])
    def test_the_image_d_on_a_ranks_frames_is_the_global_batchs(forward, rank):
        """The image D on rank r's frames (frame_rows of rank_rows(8, 4, 2, r))
        equals the JAX image logits of the global batch at those frames; a
        contiguous block of videos, the split without the image D's group,
        does not."""
        D = make_D({"disc_cfg": port_cfg(MDCFG), "ntp": NTP})
        D.load_state_dict(forward["params_D"])
        rows = tdist.rank_rows(B, tdist.mbstd_group(D, B, W), W, rank)
        want = forward["want"]["image_logits"]
        for videos, equal in ((rows, True), (np.arange(rank * 4, rank * 4 + 4), False)):
            frames = tdist.frame_rows(videos, F)
            with torch.no_grad():
                got = D.image_discr(forward["img"][torch.as_tensor(frames)], None,
                                    forward["t"][torch.as_tensor(videos)].reshape(-1, 1)
                                    )["image_logits"]
            err = float(np.abs(got.numpy() - want[frames]).max())
            assert (err <= FP32_TOL * float(np.abs(want).max())) == equal, (videos, err)

    def test_all_reduce_sum_over_one_rank_is_the_identity():
        x = torch.randn(3, requires_grad=True)
        tdist.all_reduce_sum.calls = 0
        assert tdist.all_reduce_sum(x, World()) is x and tdist.all_reduce_sum.calls == 0

    # ------------------------------------------------------- (c) the JAX mesh

    def jax_step_inputs(jax_side):
        """The JAX step's batch, rng and draws, the video D's noise for each D
        call (run_D folds 99 into its key: stylegan_v_tpu/training/loss.py:121)
        as NCDHW tensors."""
        jbatch, tbatch = batch_of(31)
        rng = jax.random.PRNGKey(201)
        draws = jax_side.draws.step(rng, 1, do_gpl=False, do_dr1=True)
        variables = {"params": jax_side.state.params_D}
        img, t = jnp.zeros((B * F, RES, RES, 3)), jnp.zeros((B, F))
        for name, keys in jax_side.draws.d_call_keys(rng, 1, True).items():
            draws.setdefault(name, {})["d_noise"] = [
                [ncdhw(a) for a in jax_side.noise(variables, jax.random.fold_in(k, 99), img,
                                                  t)[0].arrays] for k in keys]
        return jbatch, tbatch, rng, draws

    def assert_jax_close(got, want):
        """A JAX (state, stats) against another within TOL."""
        (gs, gstats), (ws, wstats) = got, want
        assert_stats_close(gstats, wstats, TOL)
        G, D = port_modules()
        g, w = jax_to_torch_train_state(gs, G, D), jax_to_torch_train_state(ws, G, D)
        for k in ("params_G", "params_D", "params_Gema"):
            assert_tree_close(g[k], w[k], TOL, f"{k}.")
        assert_tree_close({k: np.float32(g[k]) for k in ("augment_p", "w_avg")},
                          {k: np.float32(w[k]) for k in ("augment_p", "w_avg")},
                          what="scalars ", min_scale=1.0)

    # ------------------------------------------------------------- the ranks

    ME = [sys.executable, os.path.abspath(__file__), "--worker"]
    LOOP_KIMGS = (0.048, 0.072)     # (g): two steps of 24 frames, then a third resumed

    def start(cmds):
        """`cmds` as subprocesses, one torch thread each."""
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        env.pop("XLA_FLAGS", None)
        return [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                                 text=True) for c in cmds]

    def pair(checks, task_path, tmp):
        """The commands of a pair of ranks running CHECKS[checks], and their outputs."""
        init = f"tcp://localhost:{tdist.free_port()}"
        outs = [str(tmp / f"{checks}{r}.pt") for r in range(W)]
        return [ME + [checks, task_path, str(r), init, outs[r]] for r in range(W)], outs

    @pytest.fixture(scope="module", autouse=True)
    def background(tmp_path_factory):
        """Starts with the module's first test what needs nothing of JAX: (e)'s
        and (f)'s pair of ranks, (e)'s one process and (g)'s loop."""
        tmp = tmp_path_factory.mktemp("moco_port")
        task = {"gen_cfg": port_cfg(MGCFG), "disc_cfg": port_cfg(MDCFG), "ntp": NTP,
                "frames": F, "train": TRAIN, "opt": OPT, "loss": MLOSS, "aug": dict(AUG),
                "aug_p": 0.5, "tmp": str(tmp),
                "rounds": dict(B=ROUNDS_B, batch_chip=ROUNDS_CHIP, augment=True, seed=7,
                               draw_seed=8, batch=batch_of(32, ROUNDS_B)[1]),
                "zero": dict(B=B, batch_chip=None, augment=False, seed=9,
                             plan=[(False, 10), (False, 11)], batch=batch_of(33)[1])}
        task_path = str(tmp / "task.pt")
        torch.save(task, task_path)
        zip_path = build_video_dataset_zip(str(tmp / "data"), num_videos=8, frames_per_video=16,
                                           res=RES)
        run_dir = tmp / "run"
        loop_args = [a for a in LOOP_ARGS if a not in ("training.batch_size=4", "training.snap=2")]
        loop_task = str(tmp / "loop.pt")
        torch.save({"args": loop_args + ["num_gpus=2", "training.batch_size=8",
                                         "training.kimg_per_tick=0.024", "training.snap=1",
                                         f"dataset.path={zip_path}",
                                         f"project_release_dir={run_dir}"],
                    "kimgs": LOOP_KIMGS}, loop_task)
        cmds, outs = pair("port", task_path, tmp)
        outs.append(str(tmp / "single.pt"))
        cmds += [ME + ["single", task_path, outs[-1]], ME + ["loop", loop_task]]
        procs = start(cmds)
        yield dict(procs=procs, outs=outs, run=run_dir, task=task)
        for p in procs:
            if p.poll() is None:
                p.kill()

    def finish(procs, timeout=WORKER_TIMEOUT_S):
        """Each process's output, once it has ended with exit code 0."""
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        return logs

    @pytest.fixture(scope="module")
    def ranks(background, jax_side, forward, tmp_path_factory):
        """The JAX single-device step, then (b)'s and (d)'s pair of ranks and
        meanwhile the JAX mesh step; then every process's results."""
        tmp = tmp_path_factory.mktemp("moco_jax")
        jbatch, tbatch, rng, draws = jax_step_inputs(jax_side)
        jstate = jax_side.state
        jnext, jstats = jax_side.step_fn()(jstate, jbatch, rng, do_gpl=False, do_dr1=True)
        jnext, jstats = jax.device_get(jnext), jax.device_get(jstats)
        # Gmain's frames from G before the step, Dgen's from G after Gmain's update
        frames = [nchw(jax_side.frames({"params": params, **jstate.extra_G}, d["z"].numpy(),
                                       jbatch["gen_t"][:, p], d["motion_z"].numpy()))
                  for params, d, p in ((jstate.params_G, draws["Gmain"], 0),
                                       (jnext.params_G, draws["Dgen"], 2))]
        task = dict(background["task"], forward=forward, jax=dict(
            B=B, batch_chip=None, augment=False, batch=tbatch, draws=draws, frames=frames,
            start=jax_to_torch_train_state(jstate, *port_modules())))
        task_path = str(tmp / "task.pt")
        torch.save(task, task_path)
        cmds, outs = pair("jax", task_path, tmp)
        procs = start(cmds)
        try:
            mesh = create_mesh(devices=jax.devices()[:W])
            got = jax_side.step_fn(mesh)(jax.device_put(jstate, replicated_sharding(mesh)),
                                         shard_batch(mesh, jbatch), rng, do_gpl=False,
                                         do_dr1=True)
            finish(procs)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        logs = finish(background["procs"])
        load = lambda path: torch.load(path, weights_only=False)       # noqa: E731
        port = [load(o) for o in background["outs"][:W]]
        return dict(ranks=[dict(load(o), **p) for o, p in zip(outs, port)],
                    jax=(jnext, jstats), mesh=jax.device_get(got),
                    one=load(background["outs"][W]), run=background["run"], loop_log=logs[-1])

    # ------------------------------------------------- (b) the video D forward

    @pytest.mark.parametrize("rank", [0, 1])
    def test_the_d_on_a_ranks_rows_with_the_world_is_the_global_batchs(ranks, forward, rank):
        """Both logits of the rank's rows against the JAX D on the global 8
        videos within FP32_TOL; three batch norms, two all_reduces each."""
        got = ranks["ranks"][rank]["forward"]
        rows = got["rows"]
        want = forward["want"]
        assert_close(got["world"]["video_logits"], want["video_logits"][rows], FP32_TOL)
        assert_close(got["world"]["image_logits"],
                     want["image_logits"][tdist.frame_rows(rows, F)], FP32_TOL)
        assert (got["world_calls"], got["local_calls"]) == (2 * 3, 0)

    @pytest.mark.parametrize("rank", [0, 1])
    def test_local_batch_statistics_miss_the_global_batchs(ranks, forward, rank):
        """The mutation check of (b): the same call without the world (each
        rank's own statistics) misses by more than 10x the tolerance."""
        got = ranks["ranks"][rank]["forward"]
        want = forward["want"]["video_logits"][got["rows"]]
        err = float(np.abs(got["local"]["video_logits"].numpy() - want).max())
        assert err > 10 * FP32_TOL * float(np.abs(want).max()), err

    # -------------------------------------------------------- (c) JAX's mesh

    def test_jax_mesh_step_equals_the_single_device_step(ranks):
        """(c): GSPMD's MoCoGAN step over two devices, every phase at B = 8,
        against one device from the same state, batch and rng."""
        assert_jax_close(ranks["mesh"], ranks["jax"])

    # ---------------------------------------------------- (d) ranks vs JAX

    @pytest.mark.parametrize("rank", [0, 1])
    def test_two_ranks_equal_the_jax_step(ranks, rank):
        """(d): Gmain, Dmain and Dr1 with the 0.1x group, from the JAX state,
        D's input pinned to the JAX frames at the rank's rows (checked within
        TOL first)."""
        got = ranks["ranks"][rank]["jax"]
        jnext, jstats = ranks["jax"]
        assert got["unpinned"] == 0 and max(got["frame_errs"]) <= TOL, got["frame_errs"]
        assert {"Loss/G/loss_video", "Loss/scores/fake_video",
                "Loss/scores/real_video"} <= set(got["stats"])
        assert_stats_close(got["stats"], jstats)
        G, D = port_modules()
        want = jax_to_torch_train_state(jnext, G, D)
        for k, jk in (("G", "params_G"), ("D", "params_D"), ("G_ema", "params_Gema")):
            assert_tree_close(got[k], want[jk], TOL, f"{k}.")
        assert_tree_close({"w_avg": got["G"]["mapping.w_avg"]}, {"w_avg": want["w_avg"]})
        assert_tree_close(got["scalars"], {k: np.float32(want[k])
                                           for k in ("pl_mean", "augment_p", "ada_sign_acc")},
                          what="scalars ", min_scale=1.0)
        lrs = [g["lr"] for g in got["opt_D"]["param_groups"]]
        ratio = MTRAIN["D_reg_interval"] / (MTRAIN["D_reg_interval"] + 1)
        assert lrs == [OPT["lr"] * ratio, OPT["lr"] * ratio * 0.1]
        for name, module, convert in (("opt_D", D, jax_to_torch_discriminator),
                                      ("opt_G", G, jax_to_torch_generator)):
            opt = types.SimpleNamespace(state_dict=lambda s=got[name]: s)
            assert_moments_close(opt, getattr(jnext, name), module, convert, name)

    # ------------------------------------------------ (e) ranks vs one process

    def test_two_ranks_equal_one_process_on_the_same_global_batch(ranks):
        """(e): two rounds with the bgc pipe; both ranks equal to the bit, and
        within PORT_TOL of scale of the one-process step."""
        r0, r1 = (r["rounds"] for r in ranks["ranks"])
        want = ranks["one"]
        for k in ("G", "D", "G_ema", "scalars", "stats"):
            for name in r0[k]:
                assert torch.equal(r0[k][name], r1[k][name]), (k, name)
        for k in ("G", "D", "G_ema"):
            assert_tree_close(r0[k], want[k], PORT_TOL, f"{k}.")
        assert_tree_close(r0["scalars"], want["scalars"], PORT_TOL, "scalars ", min_scale=1.0)
        assert_stats_close(r0["stats"], want["stats"], TOL)
        assert {"Loss/scores/fake_video", "Loss/scores/real_video"} <= set(r0["stats"])

    def test_the_step_issues_the_video_ds_all_reduces_as_derived(ranks):
        """Per round, Gmain, Dgen and Dreal each run the video D forward and
        backward (two all_reduces a batch norm each way) and Dr1 its forward
        alone (R1 differentiates the image logits); 3 batch norms at 64^2:
        (d)'s round with R1 and (e)'s two without. One process issues none."""
        norms = sum(1 for m in port_modules()[1].modules() if type(m).__name__ == "_BatchNorm3d")
        per_round = 3 * (2 * norms) * 2
        with_r1 = per_round + 2 * norms
        assert (norms, per_round, with_r1) == (3, 36, 42)
        assert [r["jax"]["calls"] for r in ranks["ranks"]] == [with_r1] * W
        assert [r["rounds"]["calls"] for r in ranks["ranks"]] == \
            [ROUNDS_B // ROUNDS_CHIP * per_round] * W
        assert ranks["one"]["calls"] == 0

    # -------------------------------------------------------------- (f) ZeRO-1

    def test_zero1_equals_plain_adam_through_a_snapshot_with_both_groups(ranks):
        """(f): ZeRO-1 after the first step, and after a consolidated snapshot,
        a restore and the second, equal plain Adam's to the bit on both ranks;
        the snapshot and the restored optimizer hold the two groups' lr; each
        rank holds part of the moments."""
        ratio = MTRAIN["D_reg_interval"] / (MTRAIN["D_reg_interval"] + 1)
        lrs = [OPT["lr"] * ratio, OPT["lr"] * ratio * 0.1]
        for r in ranks["ranks"]:
            z = r["zero"]
            for got, want in zip(z["zero"], z["plain"]):
                for k in ("G", "D", "G_ema", "scalars"):
                    for name in want[k]:
                        assert torch.equal(got[k][name], want[k][name]), (k, name)
            assert z["snapshot_lrs"] == z["restored_lrs"] == lrs and z["consistent"]
            assert 0 < z["zero_bytes"] < 0.8 * z["plain_bytes"], (z["zero_bytes"],
                                                                  z["plain_bytes"])

    # ---------------------------------------------------------------- (g) loop

    def test_the_loop_trains_snapshots_and_resumes_mocogan_over_two_ranks(ranks):
        """(g): two steps (two ticks, a snapshot each), then resume=latest for a
        third: rank 0 alone writes one stats row a tick with both logit
        streams from both ranks; the resumed snapshot holds D's two groups."""
        run = ranks["run"]
        rows = [json.loads(line) for line in open(run / "stats.jsonl")]
        log = (run / "log.txt").read_text()
        ticks = [line for line in log.splitlines() if line.startswith("tick ")]
        assert len(rows) == len(ticks) == 3, (rows, ticks, ranks["loop_log"][-3000:])
        assert "2 ranks (gloo), 4 videos a rank a step" in log and "Resuming from" in log
        for row in rows:
            for k in ("Loss/G/loss_video", "Loss/scores/fake_video", "Loss/scores/real_video",
                      "Loss/scores/fake", "Loss/scores/real"):
                assert row[k]["num"] == 2 and np.isfinite(row[k]["mean"]), (k, row[k])
        payload, meta = load_snapshot(str(run / "network-snapshot-000000.pt"))
        assert payload["step"] == 3 and meta["cur_nimg"] == 72
        lrs = [g["lr"] for g in payload["opt_D"]["param_groups"]]
        assert len(lrs) == 2 and lrs[1] == pytest.approx(0.1 * lrs[0], rel=1e-12)
        assert all(bool(torch.isfinite(v).all()) for v in payload["D"].values())
