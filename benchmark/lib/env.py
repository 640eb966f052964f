"""The process around a run: the card, its settings, its clocks and memory,
the build of the program's kernels, and the check that no JAX module was
loaded. Everything that touches the card goes through here, so that the
CPU tests can drive a whole run on a CPU tensor device."""
from __future__ import annotations

import subprocess
import sys
import time
from typing import Dict, List

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "stylegan_v_tpu")


T0 = time.perf_counter()      # run.py sets its own start here


def log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - T0:.2f}s] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of FORBIDDEN as a whole string (stylegan_v_tpu_torch is not)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def describe(device: torch.device) -> Dict[str, str]:
    """The settings that every number of a run depends on, printed early."""
    info = {"torch": torch.__version__, "cuda": str(torch.version.cuda),
            "cudnn.benchmark": str(torch.backends.cudnn.benchmark),
            "cudnn.allow_tf32": str(torch.backends.cudnn.allow_tf32),
            "matmul.allow_tf32": str(torch.backends.cuda.matmul.allow_tf32)}
    if device.type == "cuda":
        info["device"] = torch.cuda.get_device_name(device)
        info["nvidia-smi"] = power_limit()
    return info


class Card:
    """Clocks, synchronisation and memory of the device a run uses; on a CPU
    device (the tests) the host clock and no memory."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def event(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def elapsed_ms(self, start, end) -> float:
        """Milliseconds between two events; call after a sync."""
        if self.cuda:
            return start.elapsed_time(end)
        return (end - start) * 1e3

    def peak_bytes(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def free(self) -> None:
        if self.cuda:
            torch.cuda.empty_cache()

    def kind(self) -> str:
        return torch.cuda.get_device_name(self.device) if self.cuda else "cpu"


def build_kernels(device: torch.device) -> None:
    """Build the program's CUDA kernels (a no-op once they are built in the
    checkout's stylegan_v_tpu_torch/_build/)."""
    if device.type == "cuda":
        from stylegan_v_tpu_torch.ops import cuda_build
        cuda_build.build_libraries()
