"""Traffic of kind "stream": one sensor in a closed loop.

The drive's scans are replayed as passes; each pass starts from a fresh
``init_state``, as a user who runs one sequence after another. Each frame
is the program's own intake and step (``Cloud.pack_scan``, then
``odometry_step_packed``) and ends when its pose is on the host; the next
scan goes in then. Frame 0 of a pass seeds the submap and solves nothing;
it counts like any other frame. Where the traffic mix fixes the drive, the
run's seed draws only the sensor noise (``harness/scans.seeded_noise``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from lidar_bench.harness import trace as tr


class Stream:
    def __init__(self, prog, cfg, scans, sensor: dict, traffic: dict, device):
        self.prog, self.cfg, self.scans, self.dev = prog, cfg, scans, torch.device(device)
        self.capacity = int(sensor["capacity"])
        self.traffic = traffic
        self.answers = {"key": [], "pose": []}
        self._diag = []  # (rounds, num_corr) device tensors, read after the window

    def _step(self, state, i):
        q, n = self.prog.Cloud.pack_scan(*self.scans[i], capacity=self.capacity)
        return self.prog.frontend.odometry_step_packed(state, q, n, self.cfg)

    def _keep(self, i, pose_h, diag):
        self.answers["key"].append(i)
        self.answers["pose"].append(pose_h)
        self._diag.append((diag.iterations, diag.num_corr))

    def frames(self, first_pass_only=False):
        """Yield (frame index, state) forever, pass after pass; send the
        new state back with .send()."""
        while True:
            state = self.prog.frontend.init_state(self.cfg, self.dev)
            for i in range(len(self.scans)):
                state = yield i, state
            if first_pass_only:
                return

    def setup(self):
        state = self.prog.frontend.init_state(self.cfg, self.dev)
        for i in range(int(self.traffic["warmup_frames"])):
            state, pose, _ = self._step(state, i)
            pose.cpu()

    def window(self, seconds: float) -> dict:
        """Frames back to back until `seconds` have passed; the window ends
        when the last frame begun inside it has its pose on the host."""
        times, gen = [], self.frames()
        i, state = next(gen)
        t0 = time.perf_counter()
        end = t0
        while end - t0 < seconds:
            ts = time.perf_counter()
            state, pose, diag = self._step(state, i)
            pose_h = pose.cpu().numpy()
            end = time.perf_counter()
            times.append(end - ts)
            self._keep(i, pose_h, diag)
            i, state = gen.send(state)
        window_s = end - t0
        return {"stream_frames_per_s": len(times) / window_s,
                "frame_ms_p90": 1e3 * tr.percentile(times, 90), "frames": len(times), "window_s": window_s,
                "frame_ms_p10_p50_max": [1e3 * tr.percentile(times, 10), 1e3 * tr.percentile(times, 50),
                                         1e3 * max(times)]}

    def traced(self, seconds: float, stages) -> dict:
        """The window with the program's stage timers on; then, on a fresh
        pass, `steady_from` plain frames, host syncs over `sync_frames`,
        dispatcher operations over one frame and a profile of
        `profile_frames` frames. Every frame is an answer."""
        t = self.traffic["trace"]
        stages.enable()
        first = len(self._diag)
        e2e = self.window(seconds)
        stage_ms = stages.collect()
        stages.enable(False)
        rounds = torch.stack([r for r, _ in self._diag[first:]]).cpu().tolist()
        rec = {"kind": "stream", "frames": e2e["frames"], "stage_ms": stage_ms,
               "rounds": rounds, "keys": self.answers["key"][first:]}
        gen = self.frames(first_pass_only=True)
        i, state = next(gen)

        def step(counter=None) -> int:
            nonlocal i, state
            run = lambda: self._step(state, i)  # noqa: E731
            (state, pose, diag), n = counter(run) if counter else (run(), 0)
            self._keep(i, pose.cpu().numpy(), diag)
            i, state = gen.send(state)
            return n

        for _ in range(t["steady_from"]):
            step()
        rec["syncs"] = {"count": sum(step(tr.count_syncs) for _ in range(t["sync_frames"])),
                        "frames": t["sync_frames"]}
        rec["ops"] = {"count": step(tr.count_ops), "frames": 1}
        with tr.profiled() as prof:
            for _ in range(t["profile_frames"]):
                step()
        rec["profile"] = prof
        rec["profile_frames"] = t["profile_frames"]
        return rec

    def collect(self) -> dict:
        """The answers as host arrays (after the window: one read)."""
        a = self.answers
        rounds = torch.stack([r for r, _ in self._diag]).cpu().numpy()
        corr = torch.stack([c for _, c in self._diag]).cpu().numpy()
        return {"key": np.asarray(a["key"]), "pose": np.stack(a["pose"]), "rounds": rounds, "corr": corr}

    def reference(self, answers: dict) -> dict:
        """Frames 0 up to the last the answers hold, of one pass from a
        fresh state: {"pose", "rounds", "corr"} indexed by frame."""
        last = int(np.max(answers["key"]))
        gen = self.frames(first_pass_only=True)
        i, state = next(gen)
        while True:
            state, pose, diag = self._step(state, i)
            self._keep(i, pose.cpu().numpy(), diag)
            if i == last:
                break
            i, state = gen.send(state)
        out = self.collect()
        return {"pose": out["pose"], "rounds": out["rounds"], "corr": out["corr"]}
