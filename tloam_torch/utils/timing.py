"""Stage timers and profiling hooks.

``STAGES.stage(name)`` brackets a stage of the frame pipeline. It does
nothing unless timing was enabled (``STAGES.enable()``); then it records a
CUDA event pair on the current stream, without a host sync, and
``STAGES.collect()`` synchronizes once and returns the milliseconds of every
stage since the last collect. Stages must run on a CUDA device.

``HostTimer`` is the host-clock timer of the command line (the JAX
package's ``StageTimer``, tloam_tpu/utils/timing.py:17-48): totals, counts
and a report. ``profile_trace`` writes a torch.profiler Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class StageTimer:
    def __init__(self):
        self.enabled = False
        self._events = []

    def enable(self, on: bool = True) -> None:
        self.enabled = on
        self._events = []

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._events.append((name, start, end))

    def collect(self) -> dict[str, float]:
        """{stage: total ms since the last collect} (one device sync)."""
        torch.cuda.synchronize()
        out = defaultdict(float)
        for name, s, e in self._events:
            out[name] += s.elapsed_time(e)
        self._events = []
        return dict(out)


STAGES = StageTimer()


class HostTimer:
    """Accumulating per-stage wall-clock timer."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a block. Yields a holder: assign the block's output tensor to
        ``holder.sync`` and the timer waits for its device before stopping
        the clock (CUDA work is asynchronous)."""

        class _Holder:
            sync = None

        holder = _Holder()
        t0 = time.perf_counter()
        yield holder
        if isinstance(holder.sync, torch.Tensor) and holder.sync.is_cuda:
            torch.cuda.synchronize(holder.sync.device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total:8.3f}s total  {total/n*1e3:8.2f} ms/call  x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the block with torch.profiler (the card's kernels too, when
    there is one) and write ``<logdir>/trace.json``, a Chrome trace that
    Perfetto opens."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
