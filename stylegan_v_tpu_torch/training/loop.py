"""The training orchestrator.

The port's counterpart of stylegan_v_tpu/training/loop.py (reference
src/training/training_loop.py:97-544): the host loop feeds the step from the
zip loader, keeps tick-level telemetry, writes snapshots (images, videos,
the whole state) and resumes.

Over W ranks (one process each, `world`; `setup.num_chips` must equal W),
every rank runs this loop on its device: its loader reads the rank-strided
share of the index stream, B/W videos a step, which the step takes as the
rank's rows of the global batch (training/train_step.py). G, D, G_ema and
the scalars are broadcast from rank 0 after init and after resume. Every
rank reduces the tick's stats across the ranks, checks that the ranks hold
the same state before each snapshot (utils/summary.py:
check_replica_consistency), gathers ZeRO-1's moments for it and scores the
metrics as one replica; rank 0 alone logs, writes stats.jsonl, TensorBoard,
grids, videos, snapshots and metric rows.

Tick cadence, snapshot naming, stats.jsonl schema, the Timing/data_fetch and
Timing/<variant> keys, the tick line and the visualization panels (reals /
fakes_init / fakesNNNNNN grids + sample videos with the
same-motion-different-content decomposition) mirror the JAX loop.

Randomness: G and D are drawn from a torch.Generator seeded with the setup's
seed; each step draws from a torch.Generator on the device seeded from
(seed, step index) alone (`step_seed`, the counterpart of
`jax.random.fold_in(rng, step_idx)`), so a resumed run draws what an
unbroken one would. The loop reads no device value on the host per step:
cur_nimg is a host mirror, and augment_p is read once a tick.

After each snapshot the loop scores G_ema with `setup.metrics` (calc_metric
with `setup.metric_kwargs`, on the loop's device) and appends one
metric-<name>.jsonl row per metric; a metric that fails is logged with its
traceback and training goes on, as in the JAX loop.

Resume: `resume='latest'` or a snapshot path restores the whole state
(io/checkpoint.py), and the ADA pipe's warp executor where the snapshot's
meta names it and the setup's warp_mode is "auto" (augment.py:
resolve_warp_mode; the loop's snapshots name theirs). A reference `.pkl` (torch-era or TF-era, io/legacy.py)
is a weights-only import, as in the JAX loop and the reference's resume_pkl:
a name-matched partial copy into G, G_ema and D where the pickle holds each
(parameters and buffers; a shape that differs raises), while the counters,
Adam's state, augment_p and cur_nimg stay fresh. Rank 0 reads the pickle
before it makes anything (a pickle the port cannot take raises there), and
the broadcast after resume gives every rank its weights.

With `setup.disc_source == "mocogan"` D is the MoCoGAN discriminator
(models/mocogan.py) and its Adam takes the video branch's learning-rate
multiplier (D's `lr_scale_map`) as a parameter group, as the JAX loop builds it
(stylegan_v_tpu/training/loop.py:102-114). Over several ranks its video D's
batch norms take the global batch's statistics (training/train_step.py), and
every rank's Adam holds the same two groups.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data import DeviceLoader, TrainingDataLoader, VideoFramesFolderDataset
from ..io.checkpoint import (find_latest_snapshot, load_snapshot, restore_train_state,
                             save_snapshot)
from ..io.legacy import import_reference_snapshot, load_port_state
from ..metrics import metric_main
from ..models import Discriminator, Generator, MoCoGANDiscriminator
from ..models.motion import MotionMappingNetwork
from ..parallel.distributed import World, broadcast_module_, broadcast_tensors_
from ..parallel.distributed import world as current_world
from ..parallel.zero import consolidate_optimizers_, opt_state_bytes_per_device
from ..train_setup import TrainSetup
from ..utils.logger import Logger
from ..utils.misc import float32_precision, format_time
from ..utils.summary import (check_replica_consistency, print_activation_summary,
                             print_module_summary, train_state_tree)
from ..utils.training_stats import (Collector, DeviceStatsAccumulator, StatsJsonlWriter,
                                    TensorboardWriter)
from .augment import make_augment_pipe, resolve_warp_mode
from .train_step import init_train_state, make_train_step
from .video_io import generate_videos, save_image_grid, save_video_frames_as_mp4, videos_as_grids


def resolve_device(device=None) -> torch.device:
    """The device to train on: `device` as given, or cuda:0 when None. A
    CUDA device that is not there raises; nothing falls back to the CPU."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: training runs on the card; pass "
                           "device=torch.device('cpu') (--device cpu) to run on the CPU")
    return device


def build_discriminator(setup: TrainSetup, generator: torch.Generator) -> torch.nn.Module:
    """The setup's D, drawn from `generator`: the StyleGAN-V Discriminator, or
    the MoCoGAN one (`disc_source`)."""
    if setup.disc_source == "mocogan":
        return MoCoGANDiscriminator(
            setup.disc_cfg, video_discr_lr_multiplier=setup.video_discr_lr_multiplier,
            video_discr_num_t_paddings=setup.video_discr_num_t_paddings, generator=generator)
    return Discriminator(setup.disc_cfg, generator=generator)


def check_world(setup: TrainSetup, world: World) -> None:
    """The setup's chip count must be the number of ranks."""
    if setup.num_chips != world.size:
        raise ValueError(f"the setup trains on {setup.num_chips} chips (num_gpus) but "
                         f"{world.size} process(es) run it: start it through the entry "
                         f"point with num_gpus={setup.num_chips}, or under torchrun "
                         f"with {setup.num_chips} processes")


def step_seed(seed: int, step_idx: int) -> int:
    """The seed of step `step_idx`'s draws, from (seed, step_idx) alone."""
    return int(np.random.SeedSequence([seed, step_idx]).generate_state(1, np.uint64)[0] >> 1)


def setup_snapshot_image_grid(dataset, grid_seed: int = 0, max_videos: int = 16,
                              row_len: int = 4):
    """Pick grid videos + their conditioning (reference training_loop.py:35-76);
    a copy of the JAX loop's.

    Unconditional datasets: seeded random subset. Conditional datasets: the
    grid is LABEL-GROUPED — consecutive `row_len` slots show videos of one
    label, cycling through labels in sorted order."""
    rnd = np.random.RandomState(grid_seed)
    n = min(max_videos, len(dataset))
    if not dataset.has_labels:
        idx = rnd.choice(len(dataset), size=n, replace=False)
    else:
        groups: Dict[tuple, list] = {}
        for i in range(len(dataset)):
            key = tuple(np.asarray(dataset.get_label(i)).flatten().tolist())
            groups.setdefault(key, []).append(i)
        keys = sorted(groups)
        for g in groups.values():
            rnd.shuffle(g)
        idx, k = [], 0
        while len(idx) < n and any(groups.values()):
            g = groups[keys[k % len(keys)]]
            idx.extend(g[:row_len])
            del g[:row_len]
            k += 1
        idx = np.asarray(idx[:n])
    items = [dataset[int(i)] for i in idx]
    images = np.stack([it["image"][0] for it in items])       # first frames
    labels = np.stack([it["label"] for it in items]).astype(np.float32)
    return images, labels


def training_loop(setup: TrainSetup, device=None,
                  abort_fn: Optional[Callable[[], bool]] = None,
                  progress_fn: Optional[Callable[[int, int], None]] = None,
                  log: Callable[[str], None] = print, world: Optional[World] = None) -> Dict:
    """Run training to total_kimg on `device` (cuda:0 when None) as one rank
    of `world` (the default process group's when None); returns a summary
    dict: cur_nimg, ticks, seconds, the step and cur_nimg the run started
    from, and the final TrainState. The whole run, the panels' synthesis
    included, keeps TF32 off unless setup.allow_tf32. Only rank 0 logs."""
    world = current_world() if world is None else world
    check_world(setup, world)
    device = resolve_device(device)
    reference = None
    if setup.resume and str(setup.resume).endswith(".pkl") and world.is_chief:
        reference = import_reference_snapshot(setup.resume)      # before anything is made
    os.makedirs(setup.run_dir, exist_ok=True)
    start_time = time.time()
    if not world.is_chief:
        log = _silent
    logger = Logger(os.path.join(setup.run_dir, "log.txt"), "a").install() \
        if world.is_chief else None
    try:
        with float32_precision(setup.allow_tf32):
            result = _train(setup, device, abort_fn, progress_fn, log, start_time, world,
                            reference)
    finally:
        if logger is not None:
            logger.close()     # gives sys.stdout back even when a step raises
    log(f"Training complete: {result['cur_nimg'] // 1000} kimg in "
        f"{format_time(time.time() - start_time)}")
    return result


def _silent(*_) -> None:
    pass


def _train(setup: TrainSetup, device: torch.device, abort_fn, progress_fn, log,
           start_time: float, world: World, reference=None) -> Dict:
    run_dir = setup.run_dir
    chief = world.is_chief

    # ---- dataset (reference training_loop.py:141-151) --------------------
    log("Loading training set...")
    dataset = VideoFramesFolderDataset(**setup.dataset_kwargs)
    log(f"  videos: {len(dataset)}  resolution: {dataset.resolution}  "
        f"labels: {dataset.label_dim if dataset.has_labels else 0}")

    # ---- models + state (reference training_loop.py:160-183) ------------
    log("Constructing networks...")
    gen = torch.Generator().manual_seed(setup.seed)
    G = Generator(setup.gen_cfg, generator=gen).to(device)
    D = build_discriminator(setup, gen).to(device)
    state = init_train_state(G, D, setup.opt_g, setup.opt_d, setup.train_cfg,
                             augment_p=setup.augment_p, world=world)
    if world.size > 1:
        log(f"  {world.size} ranks ({world.backend}), {setup.train_cfg.batch_size // world.size}"
            f" videos a rank a step" + (", ZeRO-1" if setup.train_cfg.zero1 else ""))
    n_gp = sum(p.numel() for p in G.parameters())
    n_dp = sum(p.numel() for p in D.parameters())
    log(f"  G params: {n_gp/1e6:.2f}M   D params: {n_dp/1e6:.2f}M")
    print_module_summary(G, "Generator", max_rows=0, log=log)
    print_module_summary(D, "Discriminator", max_rows=0, log=log)
    # per-module output shapes from a dummy forward of one video (the
    # reference's print_module_summary pass, misc.py:193-272)
    F = setup.sampling_cfg.num_frames_per_video
    c0 = torch.zeros(1, setup.gen_cfg.c_dim, device=device) if setup.gen_cfg.c_dim > 0 else None
    if chief:
        print_activation_summary(G, torch.zeros(1, setup.gen_cfg.z_dim, device=device), c0,
                                 torch.zeros(1, F, device=device), noise_mode="const",
                                 generator=torch.Generator(device=device).manual_seed(0),
                                 title="Generator", log=log)

    # ---- resume (reference train.py:283-317, training_loop.py:167-183) ---
    resume_nimg, snapshot_warp = 0, None
    if setup.resume and str(setup.resume).endswith(".pkl"):
        # weights only, from a reference snapshot pickle (reference resume_pkl:
        # partial copy, counters and optimizer fresh); rank 0 reads it and the
        # broadcast below carries it
        log(f"Importing reference snapshot {setup.resume} (weights only)")
        for key, module in (("G", state.G), ("G_ema", state.G_ema), ("D", state.D)):
            if reference is not None and reference[key] is not None:
                load_port_state(module, reference[key])
    elif setup.resume:
        path = (find_latest_snapshot(run_dir) if setup.resume == "latest"
                else setup.resume)
        if path:
            log(f"Resuming from {path}")
            payload, meta = load_snapshot(path)
            restore_train_state(state, payload)
            resume_nimg = int(meta.get("cur_nimg", state.cur_nimg))
            snapshot_warp = meta.get("warp_mode")
        elif setup.resume != "latest":
            raise FileNotFoundError(setup.resume)
    # every rank starts from rank 0's state, drawn or resumed
    _broadcast_state(state, world)

    # ---- augmentation + train step ---------------------------------------
    augment_fn, snapshot_meta = None, None
    if setup.augment_cfg is not None:
        # a resumed run keeps the warp executor its snapshot names (where the
        # setup leaves it "auto"), and every snapshot names the one it ran
        warp_mode = resolve_warp_mode(setup.augment_cfg.warp_mode, snapshot_warp)
        log(f"Augment warp executor: {warp_mode}")
        augment_fn = make_augment_pipe(dataclasses.replace(
            setup.augment_cfg, data_shards=world.size, warp_mode=warp_mode))
        snapshot_meta = {"warp_mode": warp_mode}
    step_fn = make_train_step(G, D, setup.loss_cfg, setup.train_cfg, augment_fn=augment_fn,
                              world=world, allow_tf32=setup.allow_tf32)

    # ---- visualization state (reference training_loop.py:272-299) --------
    # Before the loader starts: its worker draws from the dataset's RNG too
    # (every rank reads the grid, so every rank's dataset RNG moves alike).
    grid_reals, grid_labels = setup_snapshot_image_grid(dataset, setup.seed)
    if chief:
        save_image_grid(grid_reals.astype(np.float32) / 127.5 - 1,
                        os.path.join(run_dir, "reals.jpg"))
    vis_n = min(9, setup.train_cfg.batch_size)
    vis_z = torch.randn((vis_n, setup.gen_cfg.z_dim),
                        generator=torch.Generator().manual_seed(setup.seed + 1))
    vis_c = (grid_labels[:vis_n] if setup.gen_cfg.c_dim > 0 else None)
    vis_T = min(16, setup.sampling_cfg.max_num_frames)
    vis_ts = np.tile(np.arange(vis_T, dtype=np.float32)[None], (vis_n, 1))

    # fakes_init: untrained-G_ema grid before the first step (reference
    # training_loop.py:283)
    if chief:
        init_vids = generate_videos(state.G_ema, vis_z, vis_c, vis_ts, noise_mode="const")
        save_image_grid(init_vids[:, 0] * 2 - 1, os.path.join(run_dir, "fakes_init.jpg"))

    # ---- loader + sinks --------------------------------------------------
    # this rank's share of the rank-strided index stream (reference
    # misc.py:136): its B/W rows of each global batch
    loader = TrainingDataLoader(
        dataset, batch_size=setup.train_cfg.batch_size // world.size,
        gen_sampling=setup.sampling_cfg, use_fractional_t=setup.use_fractional_t,
        seed=setup.seed, num_workers=setup.num_workers,
        rank=world.rank, num_replicas=world.size)
    batches = DeviceLoader(loader, device)
    collector = Collector()
    dstats = DeviceStatsAccumulator()
    jsonl = StatsJsonlWriter(run_dir) if chief else None
    tb = TensorboardWriter(run_dir) if chief else None
    step_gen = torch.Generator(device=device)

    # ---- main loop (reference training_loop.py:330-544) ------------------
    total_steps = max(1, setup.total_kimg * 1000 //
                      (setup.train_cfg.batch_size
                       * setup.sampling_cfg.num_frames_per_video))
    gpl_int = setup.train_cfg.G_reg_interval
    dr1_int = setup.train_cfg.D_reg_interval
    tick_interval_nimg = setup.kimg_per_tick * 1000
    next_tick_nimg = resume_nimg
    cur_tick = 0
    tick_start = time.time()
    step_idx = int(state.step)
    # host-side nimg mirror: the step advances cur_nimg by exactly
    # nimg_per_step, so the loop never asks the state for it
    nimg_per_step = (setup.train_cfg.batch_size
                     * setup.sampling_cfg.num_frames_per_video)
    cur_nimg = int(state.cur_nimg)
    base_nimg, base_step = cur_nimg, step_idx

    log(f"Training for {setup.total_kimg} kimg ({total_steps} steps)...")
    try:
        while True:
            t_step = time.time()
            batch = next(batches)
            t_data = time.time()
            do_gpl = gpl_int is not None and step_idx % gpl_int == 0
            do_dr1 = dr1_int is not None and step_idx % dr1_int == 0
            step_gen.manual_seed(step_seed(setup.seed, step_idx))
            state, stats = step_fn(state, batch, generator=step_gen,
                                   do_gpl=do_gpl, do_dr1=do_dr1)
            dstats.update(stats)         # device-resident accumulation, no sync
            t_disp = time.time()
            # per-variant wall time between dispatches (the JAX loop's
            # Timing/<variant>): once the launch queue back-pressures, its
            # mean converges to the variant's device step time.
            variant = ("Gmain_Dmain" + ("_Gpl" if do_gpl else "")
                       + ("_Dr1" if do_dr1 else ""))
            collector.report("Timing/data_fetch", t_data - t_step)
            collector.report(f"Timing/{variant}", t_disp - t_data)
            step_idx += 1
            cur_nimg = base_nimg + (step_idx - base_step) * nimg_per_step

            done = cur_nimg >= setup.total_kimg * 1000
            if (not done) and cur_nimg < next_tick_nimg + tick_interval_nimg:
                continue

            # ---- per-tick maintenance (reference training_loop.py:417-544) ---
            cur_tick += 1
            next_tick_nimg = cur_nimg
            dstats.drain_into(collector)   # the tick's ONE stats host sync
            collector.reduce_across_ranks(world)
            tick_time = time.time() - tick_start
            fields = [
                f"tick {cur_tick:<5d}",
                f"kimg {cur_nimg / 1e3:<8.1f}",
                f"time {format_time(time.time() - start_time):<12s}",
                f"sec/tick {tick_time:<7.1f}",
                f"sec/kimg {tick_time / max(tick_interval_nimg / 1e3, 1e-8):<7.2f}",
                f"augment {float(state.augment_p):.3f}",
                f"Gloss {collector.mean('Loss/G/loss'):.3f}",
                f"Dreal {collector.mean('Loss/scores/real'):.3f}",
            ]
            log(" ".join(fields))
            if chief:
                jsonl.write({k: v for k, v in collector.as_dict().items()})
                tb.add_scalars(collector, cur_nimg)
            collector.reset()
            tick_start = time.time()

            # snapshots
            if setup.snap_ticks and (cur_tick % setup.snap_ticks == 0 or done):
                log("Saving snapshots...")
                # the ranks' replicated state must agree before it is saved
                # (reference training_loop.py:487-492)
                check_replica_consistency(train_state_tree(state), world)
                consolidate_optimizers_(state)
                if chief:
                    save_panels(setup, state.G_ema, vis_z, vis_c, vis_ts, cur_nimg)
                    save_snapshot(run_dir, state, cur_nimg,
                                  configs={"G": setup.gen_cfg, "D": setup.disc_cfg},
                                  extra_meta=snapshot_meta)
                if world.size > 1 and setup.train_cfg.zero1:
                    log(f"  optimizer state on rank 0: "
                        f"{opt_state_bytes_per_device(state) / 2**20:.1f} MiB (ZeRO-1)")
                if setup.metrics:
                    run_metrics(setup, state.G_ema, device, cur_nimg, log, chief)

            if progress_fn is not None and chief:
                progress_fn(cur_nimg // 1000, setup.total_kimg)
            if abort_fn is not None and _any_rank(abort_fn(), world):
                log("Aborting...")
                done = True
            if done:
                break
    finally:
        batches.close()
        if jsonl is not None:
            jsonl.close()
            tb.close()
    return dict(cur_nimg=cur_nimg, ticks=cur_tick, seconds=time.time() - start_time,
                start_step=base_step, start_nimg=base_nimg, state=state)


def _broadcast_state(state, world: World) -> None:
    """Rank 0's G, D, G_ema (parameters and buffers) and device scalars into
    every rank's state. Nothing happens for one rank."""
    for module in (state.G, state.D, state.G_ema):
        broadcast_module_(module, world)
    broadcast_tensors_([state.pl_mean, state.augment_p, state.ada_sign_acc], world)


def _any_rank(flag: bool, world: World) -> bool:
    """True on every rank when `flag` is true on any (a rank-agreed abort)."""
    if world.size == 1:
        return bool(flag)
    flags = [None] * world.size
    torch.distributed.all_gather_object(flags, bool(flag))
    return any(flags)


def run_metrics(setup: TrainSetup, G_ema, device: torch.device, cur_nimg: int, log,
                chief: bool = True) -> None:
    """setup.metrics on G_ema, one metric-<name>.jsonl row each (reference
    training_loop.py:503-518), written by rank 0 (`chief`); over several
    ranks each rank is one replica (metric_main.calc_metric). Metrics are
    best-effort, as in the JAX loop: a failure is logged with its traceback
    and training goes on."""
    kwargs = dict(setup.metric_kwargs or {})
    kwargs.setdefault("device", device)
    try:
        for metric in setup.metrics:
            r = metric_main.calc_metric(metric=metric, G=G_ema,
                                        dataset_kwargs=setup.dataset_kwargs, **kwargs)
            if chief:
                metric_main.report_metric(r, run_dir=setup.run_dir, snapshot_nimg=cur_nimg)
            log(f"  {metric}: {r['results']}")
    except Exception as e:                     # metrics are best-effort
        import traceback
        log(f"  metric evaluation failed: {e!r}")
        log(traceback.format_exc(limit=3))


def save_panels(setup: TrainSetup, G_ema, vis_z, vis_c, vis_ts, cur_nimg: int) -> None:
    """The snapshot's fakes grid and sample video from G_ema, with the
    same-motion panel when G has motion (reference training_loop.py:443-470)."""
    run_dir = setup.run_dir
    vids = generate_videos(G_ema, vis_z, vis_c, vis_ts, noise_mode="const")
    save_image_grid(vids[:, 0] * 2 - 1, os.path.join(run_dir, f"fakes{cur_nimg:06d}.jpg"))
    panel = videos_as_grids(vids)
    if setup.gen_cfg.has_motion:
        # moco-decomposition panel (reference training_loop.py:448-462):
        # [different-motion grid | white pad | same-motion grid] — ONE motion
        # trajectory repeated across all videos exposes content/motion
        # entanglement at a glance during training.
        L = MotionMappingNetwork.required_traj_len(setup.gen_cfg, float(vis_ts.max()))
        mz = torch.randn((1, L, setup.gen_cfg.motion.z_dim),
                         generator=torch.Generator().manual_seed(setup.seed + 2))
        mz = mz.repeat(len(vis_ts), 1, 1)
        same = videos_as_grids(generate_videos(G_ema, vis_z, vis_c, vis_ts, motion_z=mz,
                                               noise_mode="const"))
        pad = np.ones_like(panel[:, :, :min(64, panel.shape[2])])
        panel = np.concatenate([panel, pad, same], axis=2)
    save_video_frames_as_mp4(panel, setup.sampling_cfg.fps,
                             os.path.join(run_dir, f"fakes{cur_nimg:06d}.mp4"))
