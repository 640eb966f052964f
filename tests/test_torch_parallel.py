"""Data-parallel training of the port over processes, on the CPU over gloo,
held to the JAX package's step on a device mesh.

  (a) `rank_rows`: the ranks' rows are a permutation of the global batch, and
      D's minibatch-std layer on a rank's rows computes the global batch's
      groups (against the JAX layer on the whole batch).
  (b) The JAX step on a 2-device mesh equals the JAX single-device step from
      the same state on test_torch_train.py's small config, batch and draws,
      with and without the bgc pipe, within that file's TOL (GPL_TOL for
      Gpl), for the step with every phase. Chained over three steps the two
      drift past TOL at the third (ROADMAP §3), so the port is held to the
      single-device step, each step from the JAX state before it.
  (c) Two gloo ranks equal the JAX single-device step: three steps with and
      without bgc, and one step with batch_chip giving two rounds; both
      ranks equal to the bit.
  (d) The same two ranks equal the port's one-process step on the same
      global batch and draws: the parameters within 1e-5 of scale (only the
      sum order differs), the stats within (c)'s tolerances.
  (e) One rank with a process group equals the step without one, to the bit.
  (f) ZeRO-1 on two ranks: the parameters equal (c)'s to the bit, each rank
      holds about half the moments, a snapshot consolidates and resumes to
      the bit, and the JAX package's Adam moments load through the bridge.
  (g) The loop through `python -m stylegan_v_tpu_torch.train num_gpus=2
      --device cpu`: steps, a snapshot, resume from latest, only rank 0
      writes; a rank that raises ends a launch with no hang, and a perturbed
      rank makes check_replica_consistency raise.
  (h) Metrics over two replicas, one a process: the merged dataset stats
      equal the JAX package's single-process and replica-merged stats, and
      the FVD equals the one-process replica merge.

The ranks are subprocesses running this file as a script (`--worker`); they
import torch and the port, never jax. The test process computes the JAX
side and the one-process port side, writes the inputs and the global draws
(the augment pipe's replayed from a record of the one-process run) to a file
under tmp_path, and reads the ranks' results back.
"""
import os
import subprocess
import sys
import time

import numpy as np
import torch

WORKER = __name__ in ("__main__", "__mp_main__")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if WORKER:
    sys.path.insert(0, REPO)

from stylegan_v_tpu_torch.io.checkpoint import (load_adam_state, load_snapshot,  # noqa: E402
                                                restore_train_state, save_snapshot)
from stylegan_v_tpu_torch.models import Discriminator, Generator  # noqa: E402
from stylegan_v_tpu_torch.parallel import distributed as tdist  # noqa: E402
from stylegan_v_tpu_torch.parallel import zero as tzero  # noqa: E402
from stylegan_v_tpu_torch.training import augment as taug  # noqa: E402
from stylegan_v_tpu_torch.training import loss as tloss_mod  # noqa: E402
from stylegan_v_tpu_torch.training import train_step as tts  # noqa: E402
from stylegan_v_tpu_torch.utils.summary import (check_replica_consistency,  # noqa: E402
                                                train_state_tree)

W = 2
WORKER_TIMEOUT_S = 900


class Replay:
    """A draw source that hands back recorded draws in order."""

    def __init__(self, draws):
        self.draws = iter(draws)

    def _next(self, shape):
        x = next(self.draws)
        assert tuple(x.shape) == tuple(shape), (tuple(x.shape), tuple(shape))
        return x

    rand = randn = _next


def replayed(draws):
    """A step's draws with each recorded augment source as a Replay."""
    return {phase: {k: ([Replay(r) for r in v] if k == "augment" else v)
                    for k, v in d.items()} for phase, d in draws.items()}


def build_state(task, run, world, start, zero1=False):
    """The port's state and step of one run, from `start`: the pieces of a
    JAX state (io/bridge.py:jax_to_torch_train_state, Adam's moments
    included)."""
    G, D = Generator(task["gen_cfg"]), Discriminator(task["disc_cfg"])
    G.load_state_dict(start["params_G"])
    D.load_state_dict(start["params_D"])
    tcfg = tts.TrainingConfig(**task["train"], batch_chip=run["batch_chip"],
                              batch_size=run["B"], zero1=zero1)
    opt = tts.OptimizerConfig(**task["opt"])
    state = tts.init_train_state(G, D, opt, opt, tcfg, world=world,
                                 augment_p=start["augment_p"])
    state.G_ema.load_state_dict(start["params_Gema"])
    for name in ("opt_G", "opt_D"):
        load_adam_state(getattr(state, name), start[name])
    state.pl_mean.fill_(start["pl_mean"])
    state.ada_sign_acc.fill_(start["ada_sign_acc"])
    state.step, state.cur_nimg = start["step"], start["cur_nimg"]
    pipe = taug.make_augment_pipe(taug.AugmentConfig(**task["aug"])) if run["augment"] else None
    step = tts.make_train_step(G, D, tloss_mod.LossConfig(**task["loss"]), tcfg,
                               augment_fn=pipe, world=world)
    return state, step


def snapshot(state, stats):
    """What a run compares after a step."""
    return {"G": {k: v.clone() for k, v in state.G.state_dict().items()},
            "D": {k: v.clone() for k, v in state.D.state_dict().items()},
            "G_ema": {k: v.clone() for k, v in state.G_ema.state_dict().items()},
            "scalars": {k: getattr(state, k).clone()
                        for k in ("pl_mean", "augment_p", "ada_sign_acc")},
            "stats": {k: v.detach().clone() for k, v in stats.items()}}


def run_steps(task, run, world, chain=False, zero1=False, state_step=None, steps=None):
    """A run's steps on this rank, its rows of each global batch and the
    global draws: each from its own start (the JAX state before it), or with
    `chain` one after the other from the first step's start."""
    steps = run["steps"] if steps is None else steps
    plan = tdist.row_plan(run["B"], run["B"] // (run["batch_chip"] or run["B"]),
                          task["mbstd"], world.size, world.rank)
    state, step = state_step or (None, None)
    out = []
    for do_gpl, do_dr1, batch, draws, start in steps:
        if state is None or not chain:
            state, step = build_state(task, run, world, start, zero1)
        local = {k: v[torch.as_tensor(plan.batch)] for k, v in batch.items()}
        state, stats = step(state, local, do_gpl=do_gpl, do_dr1=do_dr1,
                            draws=replayed(draws))
        out.append(snapshot(state, stats))
    return state, step, out


def worker_ranks(task, rank, init_method, out_path):
    """Every check that needs the two ranks: the runs (c, d), ZeRO-1 (f), the
    consistency check (g) and the metrics (h)."""
    world = tdist.init_distributed("gloo", rank, W, init_method, torch.device("cpu"),
                                   timeout_s=WORKER_TIMEOUT_S)
    try:
        res = {"runs": {}}
        for run in task["runs"]:
            res["runs"][run["name"]] = run_steps(task, run, world)[2]

        # (f) ZeRO-1: the plain run's three steps chained with Adam and with
        # ZeRO-1 over two steps, a snapshot, a restore and the third step
        run = task["runs"][0]
        res["chained"] = run_steps(task, run, world, chain=True)[2]
        zstate, zstep, zout = run_steps(task, run, world, chain=True, zero1=True,
                                        steps=run["steps"][:2])
        res["zero_after_2"] = zout[-1]
        res["zero_bytes"] = tzero.opt_state_bytes_per_device(zstate)
        tzero.consolidate_optimizers_(zstate)
        snap_dir = task["tmp"]
        if world.is_chief:
            save_snapshot(snap_dir, zstate, zstate.cur_nimg, configs={})
        torch.distributed.barrier()
        payload, _ = load_snapshot(os.path.join(snap_dir, "network-snapshot-000000.pt"))
        fresh, fstep = build_state(task, run, world, run["steps"][0][4], zero1=True)
        restore_train_state(fresh, payload)
        res["zero_after_3"] = run_steps(task, run, world, chain=True, state_step=(fresh, fstep),
                                        steps=run["steps"][2:])[2][-1]
        # the JAX package's moments through the bridge, into ZeRO-1's shares
        bstate, _ = build_state(task, run, world, run["steps"][2][4], zero1=True)
        res["bridge_local"] = {
            name: {i: {k: v.clone() for k, v in s.items()}
                   for i, s in zip(_indices(getattr(bstate, name)),
                                   tzero.local_optimizer(getattr(bstate, name)).state.values())}
            for name in ("opt_G", "opt_D")}
        tzero.consolidate_optimizers_(bstate)
        if world.is_chief:
            res["bridge_consolidated"] = {name: getattr(bstate, name).state_dict()["state"]
                                          for name in ("opt_G", "opt_D")}

        # (g) the replicas agree, and a perturbed rank is caught on every rank
        res["consistent"] = check_replica_consistency(train_state_tree(zstate), world)
        if rank == 1:
            with torch.no_grad():
                next(zstate.D.parameters()).view(-1)[0] += 1e-6
        try:
            check_replica_consistency(train_state_tree(zstate), world)
            res["divergence_caught"] = False
        except RuntimeError as e:
            res["divergence_caught"] = "rank(s) [1]" in str(e)

        res["metrics"] = worker_metrics(task, world)
        torch.save(res, out_path)
    finally:
        tdist.destroy_distributed()


def _indices(opt):
    """Global parameter indices of the parameters whose moments this rank holds."""
    index = {id(p): i for i, p in enumerate(p for g in opt.param_groups for p in g["params"])}
    return [index[id(p)] for p in tzero.local_optimizer(opt).state]


def worker_metrics(task, world):
    """(h): the dataset stats and fvd2048_16f over two replicas."""
    import functools

    from stylegan_v_tpu_torch.metrics import metric_main as tmm
    from stylegan_v_tpu_torch.metrics import metric_utils as tmu
    os.environ["SGV_STUB_DETECTORS"] = "1"
    tmu._iter_items_threaded = functools.partial(tmu._iter_items_threaded, num_workers=1)
    saves = []
    save = tmu.FeatureStats.save
    tmu.FeatureStats.save = lambda self, path: (saves.append(path), save(self, path))
    m = task["metrics"]
    opts = tmu.MetricOptions(dataset_kwargs=dict(m["dataset_kwargs"], load_n_consecutive=4),
                             num_replicas=W, replica=world.rank, cache_dir=m["cache_dir"],
                             device="cpu")
    stats = tmu.compute_feature_stats_for_dataset(
        opts, "i3d", {}, temporal_detector=True, batch_size=2, capture_mean_cov=True,
        max_items=m["max_items"])
    G = Generator(task["metric_gen_cfg"], generator=torch.Generator().manual_seed(3)).eval()
    fvd = tmm.calc_metric("fvd2048_16f", G=G, dataset_kwargs=m["dataset_kwargs"],
                          device="cpu", cache_dir=m["cache_dir"], max_real_override=4,
                          num_gen_override=3)
    return {"num_items": stats.num_items, "mean_cov": stats.get_mean_cov(),
            "fvd": fvd["results"]["fvd2048_16f"], "saves": len(saves)}


def worker_single(task, init_method, out_path):
    """(e): one rank in a process group against no process group, to the bit."""
    run = task["runs"][0]
    alone = run_steps(task, run, tdist.World(), chain=True)[2]
    world = tdist.init_distributed("gloo", 0, 1, init_method, torch.device("cpu"))
    try:
        assert tdist.world().size == 1
        grouped = run_steps(task, run, tdist.world(), chain=True)[2]
    finally:
        tdist.destroy_distributed()
    torch.save({"alone": alone, "grouped": grouped, "world": world.size}, out_path)


def _raise_on_rank_1(rank, world_size, init_method):
    world = tdist.init_distributed("gloo", rank, world_size, init_method,
                                   torch.device("cpu"), timeout_s=WORKER_TIMEOUT_S)
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    tdist.all_reduce_mean_([torch.ones(3)], world)       # rank 0 waits here


def worker_failing_launch():
    """A launch whose rank 1 raises while rank 0 waits in a collective: the
    launch must raise, promptly."""
    try:
        tdist.launch(_raise_on_rank_1, 2)
    except Exception as e:                   # torch.multiprocessing's ProcessRaisedException
        print(f"LAUNCH RAISED: {e}", flush=True)
        return 3
    return 0


LOOP_ARGS = ["num_gpus=2", "training.batch_size=4", "training.kimg=0.012", "training.snap=1",
             "training.metrics=[]", "training.num_workers=1",
             "model.generator.fmaps=0.03125", "model.generator.channel_max=64",
             "model.generator.w_dim=64", "model.generator.z_dim=64",
             "model.generator.motion.z_dim=32", "model.generator.motion.v_dim=32",
             "model.generator.time_enc.dim=32", "model.discriminator.fmaps=0.03125",
             "model.discriminator.channel_max=64"]


def worker_loop(dataset, run_dir):
    """(g): the entry point with two ranks on the CPU, then resumed from latest."""
    from stylegan_v_tpu_torch import train
    args = [f"dataset.path={dataset}", f"project_release_dir={run_dir}"] + LOOP_ARGS
    assert train.main(args + ["--device", "cpu"]) is None    # the ranks ran in their processes
    assert train.main(args + ["training.resume=latest", "--device", "cpu"]) is None


if WORKER and __name__ == "__main__":
    mode = sys.argv[2]
    if mode == "failing-launch":
        sys.exit(worker_failing_launch())
    if mode == "loop":
        worker_loop(sys.argv[3], sys.argv[4])
        sys.exit(0)
    task = torch.load(sys.argv[3], weights_only=False)
    torch.manual_seed(1234)                  # the global RNG must not matter
    if mode == "rank":
        worker_ranks(task, int(sys.argv[4]), sys.argv[5], sys.argv[6])
    else:
        worker_single(task, sys.argv[4], sys.argv[5])
    sys.exit(0)


# ============================================================ the test process

if not WORKER:
    import contextlib
    import dataclasses
    import functools
    import json
    from unittest import mock

    import jax
    import jax.numpy as jnp
    import pytest

    import test_torch_train as ttt
    from stylegan_v_tpu.metrics import metric_utils as jmu
    from stylegan_v_tpu.models import discriminator as jdisc
    from stylegan_v_tpu.parallel import create_mesh, replicated_sharding, shard_batch
    from stylegan_v_tpu.training import train_step as jts
    from stylegan_v_tpu_torch.io import jax_to_torch_train_state
    from stylegan_v_tpu_torch.metrics import metric_main as tmm
    from stylegan_v_tpu_torch.metrics import metric_utils as tmu
    from stylegan_v_tpu_torch.models.discriminator import MinibatchStdLayer
    from test_data import SAMPLING, build_video_dataset_dir, build_video_dataset_zip
    from test_torch_models import port_cfg, small_gen_cfg
    from test_torch_train import (GPL_TOL, TOL, assert_stats_close, assert_tree_close,
                                  one_torch_thread)

    __all__ = ["one_torch_thread"]        # the fixture, from test_torch_train.py

    PLAN = [(True, True), (False, False), (False, False)]
    RUNS = {"plain": dict(B=4, batch_chip=None, augment=False, plan=PLAN),
            "bgc": dict(B=4, batch_chip=None, augment=True, plan=PLAN),
            "rounds": dict(B=8, batch_chip=4, augment=False, plan=PLAN[:1])}
    PORT_TOL = 1e-5          # (d): two ranks against one process, sum order only

    # ------------------------------------------------------------- (a) rows

    @pytest.mark.parametrize("rounds", [1, 2])
    @pytest.mark.parametrize("G", [2, 4])
    @pytest.mark.parametrize("world_size", [1, 2, 4])
    def test_rank_rows_keep_the_minibatch_std_groups(world_size, G, rounds):
        N = G * world_size * 2
        plans = [tdist.row_plan(rounds * N, rounds, G, world_size, r) for r in range(world_size)]
        rows = np.concatenate([p.batch for p in plans])
        assert sorted(rows.tolist()) == list(range(rounds * N))
        x = np.random.RandomState(G * 10 + world_size).randn(N, 5, 4, 4).astype(np.float32)
        want = np.asarray(jdisc.MinibatchStdLayer(group_size=G).apply(
            {}, jnp.asarray(np.moveaxis(x, 1, -1))))[..., -1]        # [N, 4, 4]
        layer = MinibatchStdLayer(G)
        for p in plans:
            got = layer(torch.from_numpy(x[p.rows]))[:, -1].numpy()
            np.testing.assert_allclose(got, want[p.rows], rtol=0, atol=1e-6)

    def test_rank_rows_raise_where_the_rows_do_not_split():
        with pytest.raises(ValueError, match="group size"):
            tdist.rank_rows(6, 4, 1, 0)
        with pytest.raises(ValueError, match="ranks do not divide"):
            tdist.rank_rows(8, 4, 4, 0)
        with pytest.raises(ValueError, match="Gpl"):
            tdist.row_plan(8, 1, 2, 2, 0, pl_batch_shrink=4)

    # ---------------------------------------------------------- the sides

    class Recorder:
        """Records what a draw source hands out."""

        def __init__(self, source):
            self.source, self.draws = source, []

        def rand(self, shape):
            self.draws.append(self.source.rand(shape))
            return self.draws[-1]

        def randn(self, shape):
            self.draws.append(self.source.randn(shape))
            return self.draws[-1]

    @contextlib.contextmanager
    def batch_size(B):
        """test_torch_train's make_batch and JaxDraws at B videos."""
        with mock.patch.object(ttt, "B", B):
            yield

    def jax_step_fn(jax_side, run, mesh=None):
        """The JAX step of a run, on one device or on `mesh`, and its first state."""
        JG, JD, jstate, jdraws = jax_side
        tcfg = jts.TrainingConfig(**dict(ttt.TRAIN, batch_size=run["B"]),
                                  batch_chip=run["batch_chip"])
        opt = jts.OptimizerConfig(**ttt.OPT)
        jpipe = ttt.augment_pipes()[0] if run["augment"] else None
        if run["augment"]:
            jstate = jstate.replace(augment_p=jnp.float32(ttt.AUG_P))
        jstep = jts.make_train_step(JG, JD, jts.LossConfig(**ttt.LOSS), opt, opt, tcfg,
                                    augment_fn=jpipe, donate=False, mesh=mesh)
        if mesh is None:
            return jstep, jstate

        def on_mesh(state, batch, rng, **kw):
            state = jax.device_put(state, replicated_sharding(mesh))
            return jstep(state, shard_batch(mesh, batch), rng, **kw)
        return on_mesh, jstate

    def jax_steps(run, step_fn, first):
        """A run's JAX steps, chained from `first`."""
        jstate, out = first, []
        with batch_size(run["B"]):
            for i, (do_gpl, do_dr1) in enumerate(run["plan"]):
                jbatch, _ = ttt.make_batch(20 + i)
                jstate, jstats = step_fn(jstate, jbatch, jax.random.PRNGKey(100 + i),
                                         do_gpl=do_gpl, do_dr1=do_dr1)
                out.append((jax.device_get(jstate), jax.device_get(jstats)))
        return out

    def task_configs():
        """The port's configs of every run (the worker's task, without runs)."""
        return {"gen_cfg": port_cfg(ttt.GCFG), "disc_cfg": port_cfg(ttt.DCFG), "mbstd": 2,
                "train": {k: v for k, v in ttt.TRAIN.items() if k != "batch_size"},
                "opt": ttt.OPT, "loss": ttt.LOSS, "aug": dict(ttt.AUG)}

    def bridged(jstate):
        """The pieces of a JAX state for the port, Adam's moments included."""
        return jax_to_torch_train_state(jstate, Generator(port_cfg(ttt.GCFG)),
                                        Discriminator(port_cfg(ttt.DCFG)))

    def port_steps(jax_side, run, starts):
        """The port's one-process step, each from its JAX start, on the JAX
        draws; returns each step's snapshot and its inputs, with the augment
        draws recorded."""
        jdraws = jax_side[3]
        rounds = run["B"] // (run["batch_chip"] or run["B"])
        out, steps = [], []
        with batch_size(run["B"]):
            for i, ((do_gpl, do_dr1), start) in enumerate(zip(run["plan"], starts)):
                _, tbatch = ttt.make_batch(20 + i)
                draws = jdraws.step(jax.random.PRNGKey(100 + i), rounds, do_gpl,
                                    run["augment"], do_dr1)
                for d in draws.values():
                    if "augment" in d:
                        d["augment"] = [Recorder(s) for s in d["augment"]]
                state, step = build_state(task_configs(), run, tdist.World(), start)
                state, stats = step(state, tbatch, do_gpl=do_gpl, do_dr1=do_dr1, draws=draws)
                out.append(snapshot(state, stats))
                for d in draws.values():
                    if "augment" in d:
                        d["augment"] = [r.draws for r in d["augment"]]
                steps.append((do_gpl, do_dr1, tbatch, draws, start))
        return out, steps

    @pytest.fixture(scope="module")
    def jax_side():
        return ttt.jax_side.__wrapped__()

    @pytest.fixture(scope="module")
    def mesh():
        return create_mesh(devices=jax.devices()[:W])

    @pytest.fixture(scope="module")
    def sides(jax_side, mesh):
        """For each run: the JAX single-device steps, chained; the port's
        one-process steps, each from the JAX state before it, and their inputs;
        with and without the pipe, the mesh's first step (every phase)."""
        out = {}
        for name, run in RUNS.items():
            single, first = jax_step_fn(jax_side, run)
            chain = jax_steps(run, single, first)
            starts = [bridged(st) for st in [first] + [st for st, _ in chain[:-1]]]
            out[name] = dict(single=chain, port=port_steps(jax_side, run, starts))
            if name != "rounds":
                out[name]["mesh"] = jax_steps(dict(run, plan=run["plan"][:1]),
                                              jax_step_fn(jax_side, run, mesh)[0], first)
        return out

    def assert_jax_close(got, want):
        """A JAX (state, stats) against another, within TOL (GPL_TOL for Gpl)."""
        (gs, gstats), (ws, wstats) = got, want
        tol = GPL_TOL if "Loss/pl_penalty" in wstats else TOL
        assert_stats_close(gstats, wstats, tol)
        g, w = jax_to_torch_train_state(gs), jax_to_torch_train_state(ws)
        for k in ("params_G", "params_D", "params_Gema"):
            assert_tree_close(g[k], w[k], TOL, f"{k}.")
        assert_tree_close({k: np.float32(g[k]) for k in ("pl_mean", "augment_p", "w_avg")},
                          {k: np.float32(w[k]) for k in ("pl_mean", "augment_p", "w_avg")},
                          what="scalars ", min_scale=1.0)

    @pytest.mark.parametrize("name", ["plain", "bgc"])
    def test_jax_mesh_step_equals_the_single_device_step(sides, name):
        """(b): the mesh's step with every phase (Gmain, Gpl, Dmain, Dr1, EMA,
        ADA) against the single-device step from the same state. Chained
        over three steps the two drift apart past TOL at the third (ROADMAP
        §3: summation-order noise that D's leaky-ReLU kinks amplify, as
        test_torch_train.py's docstring describes), so the port is held to
        the single-device step, each from the state before it (c)."""
        got, want = sides[name]["mesh"][0], sides[name]["single"][0]
        assert_jax_close(got, want)

    # ---------------------------------------------------------- the ranks

    def _run_processes(cmds, timeout):
        # one thread each: the workers (and the loop's ranks, which inherit
        # it) run beside each other and beside the other test processes
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        env.pop("XLA_FLAGS", None)
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  env=env, text=True) for c in cmds]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        return procs, outs

    @pytest.fixture(scope="module")
    def ranks(sides, tmp_path_factory):
        """Runs the two ranks, the one-rank group, the loop and the failing
        launch at once."""
        tmp = tmp_path_factory.mktemp("ranks")
        ds = build_video_dataset_dir(str(tmp), num_videos=3, frames_per_video=20, res=16)
        task = {
            **task_configs(),
            "metric_gen_cfg": port_cfg(small_gen_cfg(img_resolution=16)),
            "runs": [dict(name=name, B=run["B"], batch_chip=run["batch_chip"],
                          augment=run["augment"], steps=sides[name]["port"][1])
                     for name, run in RUNS.items()],
            "tmp": str(tmp),
            "metrics": {"dataset_kwargs": dict(path=ds, sampling=port_cfg(SAMPLING),
                                               max_num_frames=20),
                        "cache_dir": str(tmp / "cache"), "max_items": 3},
        }
        task_path = str(tmp / "task.pt")
        torch.save(task, task_path)
        me = [sys.executable, os.path.abspath(__file__), "--worker"]
        init = f"tcp://localhost:{tdist.free_port()}"
        init1 = f"tcp://localhost:{tdist.free_port()}"
        outs = [str(tmp / f"rank{r}.pt") for r in range(W)] + [str(tmp / "single.pt")]
        cmds = [me + ["rank", task_path, str(r), init, outs[r]] for r in range(W)]
        zip_path = build_video_dataset_zip(str(tmp / "loop"), num_videos=6, frames_per_video=20,
                                           res=32)
        cmds += [me + ["single", task_path, init1, outs[W]],
                 me + ["loop", zip_path, str(tmp / "run")], me + ["failing-launch"]]
        t0 = time.time()
        procs, logs = _run_processes(cmds, WORKER_TIMEOUT_S)
        for p, log in zip(procs[:W + 2], logs):
            assert p.returncode == 0, log[-4000:]
        return dict(ranks=[torch.load(o, weights_only=False) for o in outs[:W]],
                    single=torch.load(outs[W], weights_only=False),
                    loop=(tmp / "run", logs[W + 1]),
                    failing=(procs[-1].returncode, logs[-1]), seconds=time.time() - t0,
                    ds=ds, task=task)

    def assert_bitwise(a, b, what=""):
        if isinstance(a, dict):
            assert set(a) == set(b), what
            for k in a:
                assert_bitwise(a[k], b[k], f"{what}{k}.")
        elif isinstance(a, list):
            assert len(a) == len(b), what
            for i, (x, y) in enumerate(zip(a, b)):
                assert_bitwise(x, y, f"{what}{i}.")
        else:
            assert torch.equal(a, b), what

    def assert_port_close(got, want):
        """(d): the parameters and scalars within PORT_TOL of scale; the stats,
        values at the end of G and D, within TOL (GPL_TOL with Gpl): Gpl's
        path lengths jump at G's kinks (test_torch_train.py's docstring), and
        the losses after Gpl's update read G and D through those jumps."""
        for k in ("G", "D", "G_ema"):
            assert_tree_close(got[k], want[k], PORT_TOL, f"{k}.")
        assert_tree_close(got["scalars"], want["scalars"], PORT_TOL, "scalars ", min_scale=1.0)
        tol = GPL_TOL if "Loss/pl_penalty" in want["stats"] else TOL
        assert_stats_close(got["stats"], want["stats"], tol)

    @pytest.mark.parametrize("name", ["plain", "bgc", "rounds"])
    def test_two_ranks_equal_the_jax_step(sides, ranks, name):
        """(c): three steps (one with batch_chip's two rounds), each from the
        JAX single-device state before it, against the JAX step ((b) says
        why not the mesh's, and why each step from the same state), and both
        ranks equal to the bit."""
        r0, r1 = (r["runs"][name] for r in ranks["ranks"])
        assert_bitwise(r0, r1)
        for got, (jstate, jstats) in zip(r0, sides[name]["single"]):
            tol = GPL_TOL if "Loss/pl_penalty" in jstats else TOL
            assert_stats_close(got["stats"], jstats, tol)
            want = jax_to_torch_train_state(jstate)
            for k, jk in (("G", "params_G"), ("D", "params_D"), ("G_ema", "params_Gema")):
                assert_tree_close(got[k], want[jk], TOL, f"{k}.")
            assert_tree_close({"w_avg": got["G"]["mapping.w_avg"]}, {"w_avg": want["w_avg"]})
            assert_tree_close(got["scalars"],
                              {k: np.float32(want[k])
                               for k in ("pl_mean", "augment_p", "ada_sign_acc")},
                              what="scalars ", min_scale=1.0)

    @pytest.mark.parametrize("name", ["plain", "bgc", "rounds"])
    def test_two_ranks_equal_one_process_on_the_same_global_batch(sides, ranks, name):
        """(d): the parameters within PORT_TOL of scale, tighter than (c)."""
        for got, want in zip(ranks["ranks"][0]["runs"][name], sides[name]["port"][0]):
            assert_port_close(got, want)

    def test_one_rank_with_a_process_group_equals_the_step_without(ranks):
        """(e): to the bit."""
        single = ranks["single"]
        assert single["world"] == 1
        assert_bitwise(single["grouped"], single["alone"])

    def test_zero1_equals_plain_adam_and_holds_half_the_moments(ranks):
        """(f): ZeRO-1's parameters after two chained steps, and after a
        snapshot and a restore the third, equal plain Adam's to the bit; each
        rank holds about half the moments' bytes."""
        for r in ranks["ranks"]:
            for k in ("G", "D", "G_ema", "scalars"):
                assert_bitwise(r["zero_after_2"][k], r["chained"][1][k], k)
                assert_bitwise(r["zero_after_3"][k], r["chained"][2][k], k)
        G, D = Generator(port_cfg(ttt.GCFG)), Discriminator(port_cfg(ttt.DCFG))
        full = 2 * 4 * sum(p.numel() for p in list(G.parameters()) + list(D.parameters()))
        shares = [r["zero_bytes"] for r in ranks["ranks"]]
        assert all(0.3 * full < s < 0.7 * full for s in shares), (shares, full)

    def test_zero1_loads_the_jax_moments_through_the_bridge(ranks):
        """(f): each rank keeps the bridge's moments of the parameters it owns;
        consolidated on rank 0 they are the bridge's, whole."""
        start = ranks["task"]["runs"][0]["steps"][2][4]      # JAX's state after two steps
        bridge = {name: start[name] for name in ("opt_G", "opt_D")}
        # two steps, the first with Dr1: three Adam updates of D
        assert {float(s["step"]) for s in bridge["opt_D"].values()} == {3.0}
        owned = {name: set() for name in bridge}
        for r in ranks["ranks"]:
            for name, local in r["bridge_local"].items():
                for i, s in local.items():
                    assert_bitwise(s, bridge[name][i], f"{name}[{i}].")
                    assert i not in owned[name]
                    owned[name].add(i)
        for name in bridge:
            assert owned[name] == set(bridge[name])
            consolidated = ranks["ranks"][0]["bridge_consolidated"][name]
            assert_bitwise({i: consolidated[i] for i in bridge[name]}, bridge[name])

    def test_a_diverged_rank_fails_the_consistency_check(ranks):
        """(g): equal states pass on both ranks; rank 1's parameter moved by
        1e-6 raises on both, naming rank 1."""
        assert all(r["consistent"] for r in ranks["ranks"])
        assert all(r["divergence_caught"] for r in ranks["ranks"])

    def test_the_loop_trains_snapshots_and_resumes_over_two_ranks(ranks):
        """(g): `python -m stylegan_v_tpu_torch.train num_gpus=2 --device cpu`,
        one step and a snapshot, then resume=latest and one more: rank 0 alone
        writes (one stats row and one tick line a tick in the shared run
        directory), and the snapshot holds the resumed step."""
        run, out = ranks["loop"]
        files = set(os.listdir(run))
        assert {"reals.jpg", "fakes_init.jpg", "stats.jsonl", "log.txt",
                "network-snapshot-000000.pt", "fakes000012.jpg", "fakes000024.jpg"} <= files
        rows = [json.loads(line) for line in open(run / "stats.jsonl")]
        log = (run / "log.txt").read_text()
        ticks = [line for line in log.splitlines() if line.startswith("tick ")]
        assert len(rows) == len(ticks) == 2, (rows, ticks)
        assert "2 ranks (gloo), 2 videos a rank a step" in log and "Resuming from" in log
        assert [r["Loss/G/loss"]["num"] for r in rows] == [2, 2]    # both ranks' moments
        payload, meta = load_snapshot(str(run / "network-snapshot-000000.pt"))
        assert payload["step"] == 2 and meta["cur_nimg"] == 24
        assert all(bool(torch.isfinite(v).all()) for v in payload["G"].values())

    def test_a_rank_that_raises_ends_the_launch(ranks):
        """(g): rank 1 raises while rank 0 waits in an all_reduce; the launch
        raises (exit 3 of its process) long before the collective's timeout."""
        rc, log = ranks["failing"]
        assert rc == 3, log[-3000:]
        assert "LAUNCH RAISED" in log and "rank 1 fails" in log, log[-3000:]
        assert ranks["seconds"] < WORKER_TIMEOUT_S

    # -------------------------------------------------------- (h) metrics

    def test_metric_stats_over_two_replicas_equal_the_jax_package(ranks, monkeypatch):
        """The ranks' merged dataset stats (3 items, ragged over 2 replicas)
        against the JAX package's single-process stats and its replica merge,
        to 1e-10 relative; rank 0 alone writes the cache; the FVD is equal on
        both ranks and to the one-process merge of the two replicas."""
        monkeypatch.setenv("SGV_STUB_DETECTORS", "1")
        for mod in (jmu, tmu):
            monkeypatch.setattr(mod, "_iter_items_threaded", functools.partial(
                mod._iter_items_threaded, num_workers=1))
        m = ranks["task"]["metrics"]
        kw = dict(temporal_detector=True, batch_size=2, capture_mean_cov=True,
                  max_items=m["max_items"])
        jkw = dict(m["dataset_kwargs"], sampling=SAMPLING, load_n_consecutive=4)
        serial = jmu.compute_feature_stats_for_dataset(
            jmu.MetricOptions(dataset_kwargs=jkw, cache=False), "i3d", {}, **kw)
        merged = jmu.FeatureStats.merge([jmu.compute_feature_stats_for_dataset(
            jmu.MetricOptions(dataset_kwargs=jkw, cache=False, num_replicas=W, replica=r),
            "i3d", {}, **kw) for r in range(W)])
        got = [r["metrics"] for r in ranks["ranks"]]
        for want in (serial, merged):
            for g in got:
                assert g["num_items"] == want.num_items == 3
                for a, b in zip(g["mean_cov"], want.get_mean_cov()):
                    np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * np.abs(b).max())
        assert [g["saves"] for g in got] == [2, 0]      # two real stats' caches, by rank 0
        assert got[0]["fvd"] == got[1]["fvd"] and np.isfinite(got[0]["fvd"])
        # the one-process merge of the two replicas' partial stats
        G = Generator(ranks["task"]["metric_gen_cfg"],
                      generator=torch.Generator().manual_seed(3)).eval()

        def merged(fn):
            def run(opts, **kw):
                return tmu.FeatureStats.merge([
                    fn(dataclasses.replace(opts, num_replicas=W, replica=r), **kw)
                    for r in range(W)])
            return run

        for fn in ("compute_feature_stats_for_dataset", "compute_feature_stats_for_generator"):
            monkeypatch.setattr(tmu, fn, merged(getattr(tmu, fn)))
        want = tmm.calc_metric("fvd2048_16f", G=G, dataset_kwargs=m["dataset_kwargs"],
                               device="cpu", cache=False, max_real_override=4,
                               num_gen_override=3)
        assert got[0]["fvd"] == want["results"]["fvd2048_16f"]
