"""A traced window under torch.profiler, reduced to what the per-layer
metrics and the result's breakdown read: the window's length, the device's
busy time (the union of the intervals in which any operation ran on it, so
overlapping kernels count once), device time by operation and by class, and
the idle gaps labelled by the host operation running when each began (from
a second traced window that records the host's operations too, whose cost
would otherwise show as idle time).

The classes are those of the program's tools/profile_split.py:CLASSES,
copied here so that the yardstick stays as it is."""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

CLASSES = (  # (class, substrings of the kernel name), the first match wins
    ("K2 upfirdn2d", ("upfirdn2d_kernel", "upfirdn2d_2d_kernel", "upfirdn2d_sep_kernel")),
    ("K1, K1-bwd", ("downfirdn2d_x2",)),
    ("K4, K4-bwd", ("affine_warp",)),
    ("K7, K7-bwd, K8", ("shear_resample", "shear_shift", "shear::line_kernel")),
    ("depthwise convs (plain upfirdn2d)", ("depthwise", "conv2d_grouped")),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convs and GEMMs", ("conv", "cudnn", "xmma", "gemm", "cutlass", "sm90_", "wgrad",
                         "dgrad", "fprop")),
    ("elementwise and reductions", ("elementwise", "reduce", "Reduce", "vectorized",
                                    "unrolled", "CatArray", "index", "fill", "copy",
                                    "softmax", "norm", "scatter", "gather")),
)
FIR_CLASSES = ("K2 upfirdn2d", "K1, K1-bwd", "depthwise convs (plain upfirdn2d)")


def classify(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """Total length of the union of [start, end) intervals, and the gaps
    between its pieces."""
    total, gaps, cur_s, cur_e = 0, [], None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def _host_label(cpu: List[Tuple[int, int, str]], starts: List[int], t: int) -> str:
    """The innermost host operation running at time t: of those that
    contain t, the one that began last (cpu sorted by start)."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(cpu[max(0, i - 100000):i]):
        if e > t:
            return name
    return "no host op"


def _profile(fn, sync, host: bool):
    import torch
    from torch.profiler import ProfilerActivity
    cuda = torch.cuda.is_available()
    acts = ([ProfilerActivity.CUDA] if cuda else []) + \
        ([ProfilerActivity.CPU] if host or not cuda else [])
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    device, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if d <= 0:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((s, s + d, e.name()))
        else:
            cpu.append((s, s + d, e.name()))
    return window_s, device, cpu


def traced(fn: Callable[[], None], sync: Callable[[], None]) -> Dict:
    """Run fn() twice under the profiler and reduce the traces: first with
    the device's activity alone, which costs the host little, for the busy
    time, the window and the device time by operation and class; then with
    the host's operations too, for the idle gaps' labels."""
    window_s, device, _ = _profile(fn, sync, host=False)
    busy_ns, _ = _union([(s, e) for s, e, _ in device])
    by_name, by_class = defaultdict(float), defaultdict(float)
    for s, e, name in device:
        by_name[name] += (e - s) / 1e9
        by_class[classify(name)] += (e - s) / 1e9
    _, device2, cpu = _profile(fn, sync, host=True)
    _, gaps = _union([(s, e) for s, e, _ in device2])
    cpu.sort()
    starts = [s for s, _, _ in cpu]
    gap_labels = defaultdict(float)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        gap_labels[_host_label(cpu, starts, s)] += (e - s) / 1e9
    return {"window_s": window_s, "busy_s": busy_ns / 1e9, "device_ops": len(device),
            "by_name": dict(by_name), "by_class": dict(by_class),
            "idle_gaps": sorted(gap_labels.items(), key=lambda kv: -kv[1])[:10],
            "top_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10]}
