"""The port's tracer: named spans and counters (``STAGES``).

``STAGES.stage(name)`` brackets a span. While the tracer is off (the
default) it returns one shared null context: no CUDA event, no aten
operation, no allocation. ``STAGES.enable()`` turns spans on; a span then
takes the host clock (``time.perf_counter``) at entry and exit and, where
CUDA is present, a CUDA event pair on the current stream (no host sync).
While a torch.profiler session records, a span also opens
``torch.profiler.record_function(name)``, so a trace shows it on the host
track beside the kernels it launched. Spans nest and may run on any thread.

``STAGES.count(name, n)`` adds to a counter whether spans are on or not;
``STAGES.counts`` holds the totals since the process started.
``STAGES.sync(name)`` is a span and a count in one, around each place where
the port's own code makes the host wait on the device: its host time is
the wait.

``STAGES.collect()`` synchronizes once (where a span recorded CUDA events)
and returns what happened since the last ``collect()`` or ``enable()``:
``{name: device ms}`` for every span that recorded CUDA events,
``{"host:" + name: host ms}`` for every span, and
``{"count:" + name: n}`` for every counter that moved. Spans of one name
are summed.

The names are read by the benchmark's metrics (PERF.md §3): renaming one
nulls its metric.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("timer", "name", "annotation", "start", "t0")

    def __init__(self, timer: "StageTimer", name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.annotation = _profiler.record_function(self.name) if torch.autograd._profiler_enabled() else None
        if self.annotation is not None:
            self.annotation.__enter__()
        self.start = None
        if self.timer._cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        end = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.timer._record(self.name, host_s, self.start, end)
        return False


class StageTimer:
    def __init__(self):
        self.enabled = False
        self._cuda = False
        self.counts = collections.defaultdict(int)
        self._base = {}  # counts at the last enable() or collect()
        self._spans = []  # (name, host seconds, start event or None, end event or None)
        self._lock = threading.Lock()

    def enable(self, on: bool = True) -> None:
        """Turn spans on or off; either way, forget the spans and counts
        since the last collect()."""
        with self._lock:
            self.enabled = on
            self._cuda = on and torch.cuda.is_available()
            self._spans = []
            self._base = dict(self.counts)

    def stage(self, name: str):
        if not self.enabled:
            return _OFF
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] += n

    def sync(self, name: str):
        """A span around a host sync, counted whether spans are on or not."""
        self.counts[name] += 1
        return self.stage(name)

    def _record(self, name, host_s, start, end) -> None:
        with self._lock:
            self._spans.append((name, host_s, start, end))

    def collect(self) -> dict[str, float]:
        """Device ms, host ms ("host:") and counts ("count:") by name since
        the last collect() or enable()."""
        with self._lock:
            spans, self._spans = self._spans, []
            counts = {k: v - self._base.get(k, 0) for k, v in self.counts.items()}
            self._base = dict(self.counts)
        if any(start is not None for _, _, start, _ in spans):
            torch.cuda.synchronize()
        out = collections.defaultdict(float)
        for name, host_s, start, end in spans:
            out["host:" + name] += 1e3 * host_s
            if start is not None:
                out[name] += start.elapsed_time(end)
        out.update({"count:" + k: n for k, n in counts.items() if n})
        return dict(out)


STAGES = StageTimer()


def report(totals: dict[str, float]) -> str:
    """One line a span (host and device ms, largest host time first), then
    one a counter, of what collect() returned (or the sum of several)."""
    spans = sorted((k[5:] for k in totals if k.startswith("host:")), key=lambda n: -totals["host:" + n])
    lines = [f"{'span':24s} {'host ms':>12s} {'device ms':>12s}"]
    for name in spans:
        dev = f"{totals[name]:12.3f}" if name in totals else f"{'-':>12s}"
        lines.append(f"{name:24s} {totals['host:' + name]:12.3f} {dev}")
    lines += [f"{k[6:]:24s} {int(v):12d} (count)" for k, v in sorted(totals.items()) if k.startswith("count:")]
    return "\n".join(lines)
