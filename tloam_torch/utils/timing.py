"""Per-stage device timing with CUDA events.

``STAGES.stage(name)`` brackets a stage of the frame pipeline. It does
nothing unless timing was enabled (``STAGES.enable()``); then it records a
CUDA event pair on the current stream, without a host sync, and
``STAGES.collect()`` synchronizes once and returns the milliseconds of every
stage since the last collect. Stages must run on a CUDA device.
"""
from __future__ import annotations

import contextlib
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
