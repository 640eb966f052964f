"""Training telemetry: moment-accumulator statistics + Collector.

Behavioral parity with reference src/torch_utils/training_stats.py: every
reported quantity is reduced to [count, sum, sum-of-squares] moments so means
and stds can be aggregated exactly across steps (and, in the reference,
across ranks via one all_reduce, training_stats.py:254-266).

The port's step returns scalar stats as device tensors, so the Collector
aggregates across TIME on the host; over several ranks,
`Collector.reduce_across_ranks` sums every rank's moments into every rank's,
as the reference's _sync does (training_stats.py:254-266). `report()` accepts scalars or
arrays and accumulates moments. `Collector`, `StatsJsonlWriter` and
`TensorboardWriter` are copies of stylegan_v_tpu/utils/training_stats.py;
`DeviceStatsAccumulator` is its torch counterpart (tests/test_torch_data.py
holds it equal to the JAX package's).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch


class Collector:
    """Aggregates per-step stat dicts into mean/std over a collection window
    (reference training_stats.Collector, training_stats.py:113-230)."""

    def __init__(self, regex: str = ".*", keep_previous: bool = True):
        import re
        self._regex = re.compile(regex)
        self._keep_previous = keep_previous
        self._moments: Dict[str, np.ndarray] = {}
        self._cumulative: Dict[str, np.ndarray] = {}

    def report(self, name: str, value) -> None:
        """Accumulate [count, sum, sum_sq] moments for `name`."""
        arr = np.asarray(value, dtype=np.float64).reshape(-1)
        arr = arr[np.isfinite(arr)]
        m = np.array([arr.size, arr.sum(), np.square(arr).sum()], np.float64)
        if name in self._moments:
            self._moments[name] += m
        else:
            self._moments[name] = m

    def update(self, stats: Optional[Dict] = None) -> None:
        if stats:
            for k, v in stats.items():
                self.report(k, v)

    def update_moments(self, name: str, moments: np.ndarray) -> None:
        """Merge pre-reduced [count, sum, sum_sq] moments (exact composition,
        reference training_stats.py:56-99 invariant)."""
        m = np.asarray(moments, np.float64)
        if name in self._moments:
            self._moments[name] += m
        else:
            self._moments[name] = m.copy()

    def names(self):
        return [n for n in self._moments if self._regex.fullmatch(n)]

    def _get(self, name):
        return self._moments.get(name, np.zeros(3))

    def num(self, name) -> int:
        return int(self._get(name)[0])

    def mean(self, name) -> float:
        m = self._get(name)
        return float(m[1] / m[0]) if m[0] > 0 else float("nan")

    def std(self, name) -> float:
        m = self._get(name)
        if m[0] == 0 or not np.isfinite(m[1] / m[0]):
            return float("nan")
        if m[0] == 1:
            return 0.0
        mean = m[1] / m[0]
        raw_var = m[2] / m[0]
        return float(np.sqrt(max(raw_var - mean ** 2, 0)))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """{name: {mean, std, num}} like the reference's EasyDict export
        (training_stats.py:216-230)."""
        return {name: dict(mean=self.mean(name), std=self.std(name),
                           num=self.num(name))
                for name in self.names()}

    def reset(self) -> None:
        self._moments = {}

    def reduce_across_ranks(self, world) -> None:
        """Sum every rank's moments into every rank's (a collective: every
        rank of `world` calls it). A name that some rank lacks counts zero
        there. Nothing happens for one rank."""
        if world.size == 1:
            return
        import torch.distributed as dist
        names = [None] * world.size
        dist.all_gather_object(names, sorted(self._moments))
        names = sorted(set().union(*names))
        mine = np.asarray([self._moments.get(n, np.zeros(3)) for n in names],
                          np.float64).reshape(-1, 3)
        every = [None] * world.size
        dist.all_gather_object(every, mine)
        total = np.sum(every, axis=0)
        self._moments = {n: total[i] for i, n in enumerate(names)}


class DeviceStatsAccumulator:
    """Accumulates per-step scalar stats ON DEVICE: a few fused launches per
    step, one host readback per tick.

    The torch counterpart of the JAX package's accumulator
    (stylegan_v_tpu/utils/training_stats.py:92-151): `update` never reads a
    value on the host, so the step's dispatch never waits on its compute;
    `drain_into` makes the tick's one host sync. Moments are float32
    [finite_count, sum, sum_sq] per name, as the JAX package accumulates
    them, so draining into a `Collector` is exact.

    Key sets differ per step variant (Gpl/Dr1 steps add stats); each distinct
    key set gets its own [K, 3] accumulator.
    """

    def __init__(self):
        self._acc: Dict[Tuple[str, ...], torch.Tensor] = {}

    def update(self, stats: Dict[str, torch.Tensor]) -> None:
        names = tuple(sorted(stats))
        v = torch.stack([torch.as_tensor(stats[k]).reshape(()).float() for k in names])
        ok = torch.isfinite(v)
        v = torch.where(ok, v, torch.zeros_like(v))
        acc = self._acc.get(names)
        if acc is None:
            acc = self._acc[names] = torch.zeros(len(names), 3, device=v.device)
        # sum_sq + v*v rounded once, as the JAX package's fused multiply-add
        # rounds it (exact products in float64, then one rounding to float32)
        sq = (acc[:, 2].double() + v.double() * v.double()).float()
        self._acc[names] = torch.stack([acc[:, 0] + ok.float(), acc[:, 1] + v, sq], dim=1)

    def drain_into(self, collector: "Collector") -> None:
        """Fetch all accumulated moments (ONE host sync) and merge them into
        the collector; resets the accumulator."""
        if not self._acc:
            return
        keys = list(self._acc)
        host = torch.cat([self._acc[k] for k in keys]).cpu().double().numpy()
        self._acc = {}
        row = 0
        for names in keys:
            for name in names:
                collector.update_moments(name, host[row])
                row += 1


class StatsJsonlWriter:
    """stats.jsonl sink (reference training_loop.py:531-535 format)."""

    def __init__(self, run_dir: str, fname: str = "stats.jsonl"):
        os.makedirs(run_dir, exist_ok=True)
        self._f = open(os.path.join(run_dir, fname), "at")

    def write(self, stats_dict: Dict, timestamp: Optional[float] = None) -> None:
        payload = dict(stats_dict)
        payload["timestamp"] = time.time() if timestamp is None else timestamp
        self._f.write(json.dumps(payload) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class TensorboardWriter:
    """Optional tensorboardX sink (reference training_loop.py:308-316, 536-542)."""

    def __init__(self, run_dir: str):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:             # optional sink
            self._w = None
        else:
            self._w = SummaryWriter(run_dir)

    def add_scalars(self, collector: Collector, global_step: int) -> None:
        if self._w is None:
            return
        for name in collector.names():
            self._w.add_scalar(name, collector.mean(name), global_step)

    def add_text(self, tag: str, text: str, global_step: int = 0) -> None:
        if self._w is not None:
            self._w.add_text(tag, text, global_step)

    def flush(self):
        if self._w is not None:
            self._w.flush()

    def close(self):
        if self._w is not None:
            self._w.close()
