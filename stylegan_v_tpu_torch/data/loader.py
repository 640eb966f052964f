"""Host-side infinite data pipeline: sampler + threaded decode + prefetch.

Replaces the reference's torch DataLoader worker processes + InfiniteSampler
(reference misc.py:110-141, training_loop.py:149-151, 330-348) with a
thread-pool pipeline on the TPU-VM host (JPEG decode releases the GIL in
PIL, so threads scale; no fork overhead, no tensor IPC).

Produces exactly the train-step batch dict:
    real_img [B,F,H,W,C] u8 | real_c [B,c] | real_t [B,F]
    gen_c [B,P,c] | gen_t [B,P,F]   (P = Gmain, Greg, Dmain draws,
                                     reference training_loop.py:338-348)

`infinite_indices` and `TrainingDataLoader` are copies of
stylegan_v_tpu/data/loader.py (tests/test_torch_data.py holds their batches
equal). `DeviceLoader` is the port's counterpart of the JAX loop's
`shard_batch` (stylegan_v_tpu/training/loop.py:255): it puts each batch on
the device, with real_img as the step's [B,F,C,H,W] uint8.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..models.config import SamplingConfig
from .dataset import VideoFramesFolderDataset
from .sampling import sample_frames


def infinite_indices(n: int, rank: int = 0, num_replicas: int = 1,
                     shuffle: bool = True, seed: int = 0,
                     window_size: float = 0.5) -> Iterator[int]:
    """Infinite shuffled rank-strided index stream with windowed reshuffle
    (reference misc.py:110-141 InfiniteSampler semantics)."""
    assert n > 0
    order = np.arange(n)
    rnd = None
    window = 0
    if shuffle:
        rnd = np.random.RandomState(seed)
        rnd.shuffle(order)
        window = int(np.rint(order.size * window_size))

    idx = 0
    while True:
        i = idx % order.size
        if idx % num_replicas == rank:
            yield int(order[i])
        if window >= 2:
            j = (i - rnd.randint(window)) % order.size
            order[i], order[j] = order[j], order[i]
        idx += 1


class TrainingDataLoader:
    """Threaded prefetching loader over a VideoFramesFolderDataset.

    num_phases gen-draws per batch element (z is drawn on-device); timestamps
    come from `sample_frames` against per-item video lengths, with fractional
    offsets for the generator when configured (reference
    training_loop.py:345-346 use_fractional_t).
    """

    def __init__(self, dataset: VideoFramesFolderDataset, batch_size: int,
                 gen_sampling: Optional[SamplingConfig] = None,
                 use_fractional_t: bool = False, num_phases: int = 3,
                 rank: int = 0, num_replicas: int = 1, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 4, shuffle: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.gen_sampling = gen_sampling or dataset.sampling
        self.use_fractional_t = use_fractional_t
        self.num_phases = num_phases
        self._index_iter = infinite_indices(len(dataset), rank=rank,
                                            num_replicas=num_replicas,
                                            seed=seed, shuffle=shuffle)
        self._index_lock = threading.Lock()
        self._rngs = [np.random.RandomState(seed * 1000 + rank * 100 + w + 1)
                      for w in range(num_workers)]
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, args=(w,), daemon=True)
            for w in range(num_workers)]
        for t in self._threads:
            t.start()

    def _next_indices(self, k: int):
        with self._index_lock:
            return [next(self._index_iter) for _ in range(k)]

    def _make_batch(self, worker_id: int) -> Dict[str, np.ndarray]:
        rng = self._rngs[worker_id]
        ds = self.dataset
        B, P = self.batch_size, self.num_phases
        idxs = self._next_indices(B)
        items = [ds[i] for i in idxs]
        batch = {
            "real_img": np.stack([it["image"] for it in items]),
            "real_c": np.stack([it["label"] for it in items]).astype(np.float32),
            "real_t": np.stack([it["times"] for it in items]).astype(np.float32),
        }
        # gen draws: labels + video lengths from random dataset items
        # (reference training_loop.py:338-348).
        gen_idx = rng.randint(len(ds), size=(B * P,))
        gen_c = np.stack([ds.get_label(int(i)) for i in gen_idx]).astype(np.float32)
        gen_l = [min(ds.get_video_len(int(i)), self.gen_sampling.max_num_frames)
                 for i in gen_idx]
        gen_t = np.stack([
            sample_frames(self.gen_sampling, total_video_len=l,
                          use_fractional_t=self.use_fractional_t, rng=rng)
            for l in gen_l]).astype(np.float32)
        batch["gen_c"] = gen_c.reshape(B, P, -1)
        batch["gen_t"] = gen_t.reshape(B, P, -1)
        return batch

    def _worker(self, worker_id: int):
        while not self._stop.is_set():
            try:
                batch = self._make_batch(worker_id)
            except Exception as e:   # surface errors to the consumer
                self._queue.put(e)
                return
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)


class DeviceLoader:
    """The batches of a TrainingDataLoader as torch tensors on `device`, with
    real_img permuted there from [B,F,H,W,C] to the step's [B,F,C,H,W] uint8.

    On a CUDA device each numpy batch is pinned and copied with
    non_blocking=True on a copy stream of its own, one batch ahead of the
    step: `next()` hands over the batch staged by the previous call, then
    stages the next one, so its copy overlaps the step that consumes the
    handed-over batch. The consumer's stream waits for the copy on the
    device, not on the host. Each pinned buffer stays referenced until the
    event recorded after its copy has completed. On the CPU the batch is
    wrapped and permuted in place of the copy.
    """

    def __init__(self, loader: TrainingDataLoader, device: torch.device):
        self.loader = loader
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._staged = None          # (device batch, copy-done event) of the next step
        self._in_flight = None       # (pinned buffers, copy-done event) of the last copy

    def _stage(self):
        host = next(self.loader)
        if not self._cuda:
            batch = {k: torch.from_numpy(v) for k, v in host.items()}
            batch["real_img"] = batch["real_img"].permute(0, 1, 4, 2, 3).contiguous()
            return batch, None
        if self._in_flight is not None:   # the previous copy is one step old by now
            self._in_flight[1].synchronize()
        pinned = {k: torch.from_numpy(v).pin_memory() for k, v in host.items()}
        with torch.cuda.stream(self._stream):
            batch = {k: v.to(self.device, non_blocking=True) for k, v in pinned.items()}
            batch["real_img"] = batch["real_img"].permute(0, 1, 4, 2, 3).contiguous()
            done = torch.cuda.Event()
            done.record(self._stream)
        self._in_flight = (pinned, done)
        return batch, done

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self._staged is None:
            self._staged = self._stage()
        batch, done = self._staged
        self._staged = self._stage()
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for v in batch.values():       # allocated on the copy stream, used on this one
                v.record_stream(consumer)
        return batch

    def close(self):
        if self._in_flight is not None:
            self._in_flight[1].synchronize()
            self._in_flight = None
        self.loader.close()
