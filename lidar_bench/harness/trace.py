"""What the traced run reads: host syncs, dispatcher operations, and the
device's busy intervals from torch.profiler.

``count_syncs`` is a copy of ``chip_smoke.count_syncs`` and ``count_ops``
of ``tloam_torch/utils/op_count.count_ops``; the reduction of a profile to
busy time, idle share and a breakdown is the benchmark's own.
"""
from __future__ import annotations

import collections
import contextlib
import time
import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

WINDOW_SPAN = "lidar_bench.traced_window"


def percentile(values, q: float) -> float:
    """The q-th percentile of all values (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def count_syncs(fn):
    """(fn(), host syncs fn made), from CUDA's sync debug warnings."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def count_ops(fn):
    """(fn(), aten operations fn issued to the dispatcher)."""
    counter = _OpCounter()
    with counter:
        out = fn()
    return out, counter.n


def union_length(intervals) -> float:
    """Total length covered by [(start, end), ...], overlaps counted once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The gaps in [lo, hi] that no interval covers, [(start, end)]."""
    gaps, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def name_gaps(cpu, gaps) -> list[str]:
    """For each gap (start, end), the innermost host event open at its
    middle (cpu: [(start, end, name)] sorted by start, nested as one
    thread's calls are), or "host, between operations"."""
    names, stack, i = [], [], 0
    for s, e in gaps:
        m = 0.5 * (s + e)
        while i < len(cpu) and cpu[i][0] <= m:
            while stack and stack[-1][1] <= cpu[i][0]:
                stack.pop()
            stack.append(cpu[i])
            i += 1
        while stack and stack[-1][1] <= m:
            stack.pop()
        names.append(stack[-1][2] if stack else "host, between operations")
    return names


@contextlib.contextmanager
def profiled():
    """Profile the block (host and device). Yields a dict that holds, after
    the block, busy_s, window_s, kernels {name: [seconds, launches]},
    device_ops and idle_gaps (each at most 10 [name, seconds], by total).
    The window is the block's wall time; busy is the union of device
    kernel, copy and set intervals inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    out = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            t = time.perf_counter()
            yield out
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    dev, cpu, span = [], [], None
    for ev in prof.events():
        tr = ev.time_range
        if ev.name == WINDOW_SPAN:
            if ev.device_type == DeviceType.CPU:  # the device timeline's copy of the span is no work
                span = (tr.start, tr.end)
        elif ev.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, ev.name))
        else:
            cpu.append((tr.start, tr.end, ev.name))
    lo, hi = span
    dev = [(max(s, lo), min(e, hi), n) for s, e, n in dev if e > lo and s < hi]
    cpu.sort(key=lambda c: (c[0], -c[1]))  # an enclosing call before the calls it makes
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for s, e, n in dev:
        kernels[n][0] += (e - s) / 1e6
        kernels[n][1] += 1
    gaps = collections.Counter()
    holes = idle_gaps([(s, e) for s, e, _ in dev], lo, hi)
    for (s, e), name in zip(holes, name_gaps(cpu, holes)):
        gaps[name] += (e - s) / 1e6
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    out.update(
        busy_s=union_length([(s, e) for s, e, _ in dev]) / 1e6,
        window_s=(hi - lo) / 1e6,
        wall_s=wall,
        kernels=dict(kernels),
        device_ops=[[n[:80], v[0]] for n, v in by_time[:10]],
        idle_gaps=[[n[:80], v] for n, v in gaps.most_common(10)],
    )
