"""Data-parallel training over processes, one per device.

The port's counterpart of stylegan_v_tpu/parallel/mesh.py. The JAX package
runs one sharded program over a device mesh and lets XLA insert the
collectives; the port runs one process per device (reference
train.py:359-366) and issues them itself, on a `torch.distributed` process
group:

  * `init_distributed` / `destroy_distributed` / `world()`: the process
    group and this process's place in it (`World`). The backend is nccl on
    CUDA and gloo on the CPU, unless the caller names one (gloo on CUDA runs
    several ranks on one card, which nccl refuses).
  * `rank_rows`: which rows of the global batch a rank holds, chosen so that
    D's minibatch-std groups (strided across the batch,
    models/discriminator.py:MinibatchStdLayer) are the global batch's groups:
    D's forward needs no collective.
  * `RowsDraws`, `rank_draws` and `frame_rows`: every rank makes a step's
    GLOBAL draws and keeps its rows, so a run's draws do not depend on the
    world size (the per-layer noise of synthesis too, one row a frame).
  * `all_reduce_mean_`, `broadcast_module_`, `broadcast_tensors_`: the
    collectives of the step and of start and resume, over one flat buffer.
  * `all_reduce_sum`: a sum over the ranks that autograd differentiates (its
    backward is the same sum of the gradient), for statistics that a forward
    takes over the global batch: the MoCoGAN video D's batch norms
    (models/mocogan.py), as the JAX package's GSPMD program takes them.
  * `launch`: runs a function in W spawned processes; a rank that raises ends
    the others, and the launch raises.

With one rank nothing here issues a collective.
"""
from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class World:
    """This process's place among the ranks of the default process group:
    its rank, their number and the backend."""
    rank: int = 0
    size: int = 1
    backend: Optional[str] = None

    @property
    def is_chief(self) -> bool:
        return self.rank == 0

    def mean_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of each rank's `x` (a copy; `x` itself for
        one rank). Each rank's x is a mean over as many rows as every
        other's, so this is the mean over the global batch."""
        if self.size == 1:
            return x
        y = x.detach().clone()
        dist.all_reduce(y)
        return y.div_(self.size)


def default_backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(backend: Optional[str], rank: int, world_size: int,
                     init_method: str, device: torch.device,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> World:
    """Join the default process group and return this process's World.

    `backend` None takes `default_backend(device)`. A collective that waits
    longer than `timeout_s` raises, so a rank that died cannot hold the others
    forever. On a CUDA device this process's current card becomes `device`."""
    device = torch.device(device)
    backend = backend or default_backend(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {}
    if backend == "nccl" and device.type == "cuda":
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return World(rank=rank, size=world_size, backend=backend)


def destroy_distributed() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world() -> World:
    """The default process group's World, or one rank when there is none."""
    if not (dist.is_available() and dist.is_initialized()):
        return World()
    return World(rank=dist.get_rank(), size=dist.get_world_size(), backend=dist.get_backend())


# ------------------------------------------------------------ the batch rows

def rank_rows(N: int, G: int, W: int, r: int) -> np.ndarray:
    """The rows of an N-row global batch that rank r of W holds, in order:
    [g*(N/G) + r*m + j for g in 0..G-1 for j in 0..m-1] with m = N/(G*W).

    D's MinibatchStdLayer groups rows {g*n + i} (n = rows/G). On X[I_r] the
    local row g*m + j groups over g, and it is global row g*(N/G) + r*m + j:
    the local groups are the global batch's groups."""
    if G < 1 or N % G != 0:
        raise ValueError(f"the minibatch-std group size {G} does not divide the "
                         f"batch of {N} videos")
    if (N // G) % W != 0:
        raise ValueError(f"{W} ranks do not divide the {N // G} minibatch-std groups "
                         f"of a {N}-video batch (group size {G})")
    m = N // (G * W)
    return np.asarray([g * (N // G) + r * m + j for g in range(G) for j in range(m)],
                      dtype=np.int64)


def mbstd_group(D, N: int, W: int = 1) -> int:
    """The minibatch-std group size, in videos, that `rank_rows` must keep
    whole for D on an N-video round over W ranks (1 without the layer).

    The MoCoGAN D's image D groups frames: it sees the B*F frames of B videos
    (frame v*F + f) as a batch, with a fixed group of 4 (models/mocogan.py),
    so its groups are frames {g*(N*F/4) + i}. With rank_rows(N, 4, W, r) over
    videos (m = N/(4W)), rank r's frame (g*m + j)*F + f is local frame
    g*(m*F) + (j*F + f), whose group member g and position j*F + f are those
    of global frame (g*(N/4) + r*m + j)*F + f = g*(N*F/4) + (r*m*F + j*F + f):
    the image D's local groups, of stride n_loc*F/4 = m*F, are the global
    ones. So the group counted in videos is the image D's 4, and a round
    whose N videos do not split into 4*W raises."""
    image = getattr(D, "image_discr", None)
    if image is not None:
        G = image.b4.mbstd.group_size
        if N % (G * W) != 0:
            raise ValueError(f"the MoCoGAN image discriminator's minibatch-std group of {G} "
                             f"frames needs a round of videos that splits into {G} x {W} "
                             f"ranks; a round holds {N} videos")
        return G
    mbstd = getattr(getattr(D, "b4", None), "mbstd", None)
    if mbstd is None:
        return 1
    return N if mbstd.group_size is None else min(mbstd.group_size, N)


@dataclass(frozen=True)
class RowPlan:
    """The rows a rank takes of one step, of R rounds of N global videos.

    `batch`: global rows of the rank's local batch, round by round (the rows
    of every per-video batch entry and draw); `rows`: rank_rows within one
    round; `gpl`: for Gpl's draws, which take b = N // pl_batch_shrink videos
    a round, the rank's rows among them, round by round, as indices into
    those R*b draws."""
    N: int
    rows: np.ndarray
    batch: np.ndarray
    gpl: np.ndarray


def row_plan(B: int, rounds: int, G: int, W: int, r: int,
             pl_batch_shrink: Optional[int] = None) -> RowPlan:
    """The RowPlan of a B-video global batch; raises where the rows do not
    split evenly over the ranks. Without `pl_batch_shrink` (a step without
    Gpl) `gpl` is empty and Gpl's split is not checked."""
    N = B // rounds
    rows = rank_rows(N, G, W, r)
    batch = np.concatenate([i * N + rows for i in range(rounds)])
    gpl = np.zeros(0, np.int64)
    if pl_batch_shrink is not None:
        n, b = len(rows), N // pl_batch_shrink
        k = n // pl_batch_shrink
        # the port's Gpl runs on the first n // pl_batch_shrink local rows of
        # a round: they must be this rank's share of the round's first b rows
        if b % W != 0 or k != b // W or not (rows[:k] < b).all() or (rows[k:] < b).any():
            raise ValueError(f"Gpl's {b} videos a round do not split evenly over {W} "
                             f"ranks (batch {N} a round, minibatch-std group {G}, "
                             f"pl_batch_shrink {pl_batch_shrink})")
        gpl = np.concatenate([i * b + rows[:k] for i in range(rounds)])
    return RowPlan(N=N, rows=rows, batch=batch, gpl=gpl)


class RowsDraws:
    """A draw source that draws the global leading size of every call from
    `source` and returns rows `rows` of it: rand(shape) and randn(shape) with
    shape[0] the rank's rows take (total, *shape[1:]) from `source`."""

    def __init__(self, source, rows: np.ndarray, total: int):
        self.source = source
        self.rows = torch.as_tensor(np.asarray(rows), dtype=torch.long)
        self.total = total

    def _take(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.rows.to(x.device)]

    def _global(self, shape) -> tuple:
        shape = tuple(shape)
        if shape[0] != len(self.rows):
            raise ValueError(f"a draw of {shape[0]} rows, the rank holds {len(self.rows)}")
        return (self.total,) + shape[1:]

    def rand(self, shape) -> torch.Tensor:
        return self._take(self.source.rand(self._global(shape)))

    def randn(self, shape) -> torch.Tensor:
        return self._take(self.source.randn(self._global(shape)))


def frame_rows(rows: np.ndarray, frames: int) -> np.ndarray:
    """The frame rows [v*frames + f for v in rows for f in 0..frames-1] of
    video rows `rows`: synthesis makes one image a frame."""
    rows = np.asarray(rows, dtype=np.int64)
    return (rows[:, None] * frames + np.arange(frames)).reshape(-1)


def _take_rows(x: torch.Tensor, rows: np.ndarray, per: int = 1) -> torch.Tensor:
    idx = torch.as_tensor(rows, dtype=torch.long, device=x.device)
    if per > 1:        # `per` consecutive entries a row (Gpl's noise: F frames a video)
        idx = (idx[:, None] * per + torch.arange(per, device=x.device)).reshape(-1)
    return x[idx]


def rank_draws(draws: Dict[str, Dict[str, object]], plan: RowPlan,
               frames: int) -> Dict[str, Dict[str, object]]:
    """A rank's share of a step's global draws (training/train_step.py's
    `draws`): the per-video tensors' rows, Gpl's by `plan.gpl`, and every
    augment and video D noise source ("d_noise") wrapped in RowsDraws, so
    each draw of a rank's n rows is those rows of the global draw; the
    per-round mix_cutoff is shared."""
    out = {}
    for phase, d in draws.items():
        rows = plan.gpl if phase == "Gpl" else plan.batch
        mine = {}
        for k, v in d.items():
            if k in ("augment", "d_noise"):
                mine[k] = [RowsDraws(s, plan.rows, plan.N) for s in v]
            elif k == "mix_cutoff":
                mine[k] = v
            elif k == "z":                   # every phase's z has the batch's rows
                mine[k] = _take_rows(v, plan.batch)
            elif k == "pl_noise":
                mine[k] = _take_rows(v, rows, per=frames)
            else:
                mine[k] = _take_rows(v, rows)
        out[phase] = mine
    return out


# -------------------------------------------------------------- collectives

def all_reduce_mean_(tensors: Sequence[torch.Tensor], world: World) -> None:
    """Replace each tensor by its mean over the ranks, in place, through one
    flat buffer (one all_reduce). Nothing happens for one rank."""
    if world.size == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(world.size)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of each rank's x; the gradient of a sum is the
    sum of the gradients, so backward is this Function again (recorded, so
    that it too can be differentiated)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        all_reduce_sum.calls += 1
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor, world: World) -> torch.Tensor:
    """The sum over the ranks of each rank's `x` (a copy; `x` itself for one
    rank), differentiable to any order: the gradient of each rank's loss
    reaches every rank's x, as the reference's SyncBatchNorm carries it.
    `all_reduce_sum.calls` counts the all_reduces it issued, the backward's
    included."""
    if world.size == 1:
        return x
    return _AllReduceSum.apply(x)


all_reduce_sum.calls = 0


def broadcast_tensors_(tensors: Iterable[torch.Tensor], world: World, src: int = 0) -> None:
    """Give every rank rank `src`'s values of `tensors`, in place, through one
    flat buffer per dtype. Nothing happens for one rank."""
    if world.size == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src=src)
        offset = 0
        with torch.no_grad():
            for t in group:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n


def broadcast_module_(module: torch.nn.Module, world: World, src: int = 0) -> None:
    """Rank `src`'s parameters and buffers into every rank's `module`."""
    broadcast_tensors_(list(module.parameters()) + list(module.buffers()), world, src)


# -------------------------------------------------------------- the launcher

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(fn: Callable, world_size: int, args: tuple = ()) -> None:
    """Run fn(rank, world_size, init_method, *args) in `world_size` spawned
    processes (torch.multiprocessing.spawn, as the reference's train.py does)
    and wait for all of them. When a rank raises or dies, the others are ended
    and this raises: no rank is left waiting in a collective. The error names
    every rank that raised, in rank order: torch reports the first rank it
    sees end, and once one rank has raised, a peer waiting in a collective
    with it fails too and may be seen first. The ranks meet at
    tcp://localhost on a free port."""
    import pickle
    import torch.multiprocessing as mp
    init_method = f"tcp://localhost:{free_port()}"
    context = mp.spawn(fn, args=(world_size, init_method) + tuple(args), nprocs=world_size,
                       join=False)
    try:
        while not context.join():
            pass
    except mp.ProcessRaisedException as e:
        raised = []
        for rank, path in enumerate(context.error_files):
            if os.access(path, os.R_OK):
                with open(path, "rb") as f:
                    raised.append(f"-- rank {rank} raised:\n{pickle.load(f)}")
        if len(raised) < 2:
            raise
        raise mp.ProcessRaisedException("\n\n" + "\n".join(raised), e.error_index,
                                        e.error_pid) from None
