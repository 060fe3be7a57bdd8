"""Traffic of kind "batch": offline re-registration of logged frames.

Set-up steps the drive through the program frame by frame and captures,
for each frame of ``problem_frames``, the scan's features, the submap's
features and the motion prediction, each from the program's own state
before the frame (as chip_smoke.capture_entries does). The batch holds
``replicas`` copies of those problems, each copy's planar points moved by
its own N(0, ``planar_noise_m``) draw. Where the traffic mix gives a
``drive_seed``, the drive and the draws come from it, the same in every
run, and the run's seed only shuffles the batch: a solve runs until its
slowest entry converges, so a seed that changed the problems would change
the work. The window runs batched solves back to back, each ending with
its poses on the host.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from lidar_bench.harness import trace as tr


def planar_noise(shape, sigma: float, seed: int, device) -> torch.Tensor:
    """The replicas' planar-point noise (B, cap, 3), made on the device from
    a seed; both sides draw the same."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device) * sigma


class Batch:
    def __init__(self, prog, cfg, scans, sensor: dict, traffic: dict, device, seed: int):
        self.prog, self.cfg, self.scans, self.dev = prog, cfg, scans, torch.device(device)
        self.capacity = int(sensor["capacity"])
        self.traffic, self.seed = traffic, seed
        self.tls = cfg.odometry.tls
        self.answers = {"pose": []}
        self._diag = []

    def problems(self):
        """The batch (scans, submaps, predictions), each leaf with a leading B."""
        fe, (lo, hi) = self.prog.frontend, self.traffic["problem_frames"]
        state = fe.init_state(self.cfg, self.dev)
        entries = []
        for i in range(hi + 1):
            q, n = self.prog.Cloud.pack_scan(*self.scans[i], capacity=self.capacity)
            raw = self.prog.Cloud.from_packed(torch.as_tensor(q).to(self.dev), n)
            if i >= lo:
                feats = fe.preprocess_frame(raw, self.cfg)
                entries.append((feats.scan, fe.submap_features(state.submap, self.cfg), state.predict.clone()))
            state, _, _ = fe.odometry_step(state, raw, self.cfg)
        items = entries * int(self.traffic["replicas"])
        draws = int(self.traffic.get("drive_seed", self.seed))
        noise = planar_noise((len(items),) + tuple(entries[0][0].planar.xyz.shape),
                             float(self.traffic["planar_noise_m"]), draws, self.dev)
        order = torch.randperm(len(items), generator=torch.Generator().manual_seed(self.seed))
        scans, submaps, predict = self.prog.stack_tensors([items[k] for k in order.tolist()])
        noise = noise[order.to(self.dev)]
        scans = scans._replace(planar=dataclasses.replace(scans.planar, xyz=scans.planar.xyz + noise))
        return scans, submaps, predict

    def _solve(self):
        return self.prog.solve(*self.batch, self.tls)

    def _keep(self, pose_h, diag):
        self.answers["pose"].append(pose_h)
        self._diag.append((diag.iterations, diag.num_corr))

    def setup(self):
        self.batch = self.problems()
        for _ in range(int(self.traffic["warmup_solves"])):
            pose, _ = self._solve()
            pose.cpu()

    @property
    def size(self) -> int:
        return int(self.batch[2].shape[0])

    def window(self, seconds: float) -> dict:
        """Solves back to back until `seconds` have passed; the window ends
        when the last solve begun inside it has its poses on the host."""
        solves = 0
        t0 = time.perf_counter()
        end = t0
        while end - t0 < seconds:
            pose, diag = self._solve()
            pose_h = pose.cpu().numpy()
            end = time.perf_counter()
            solves += 1
            self._keep(pose_h, diag)
        window_s = end - t0
        return {"batch_frames_per_s": solves * self.size / window_s, "solves": solves, "window_s": window_s}

    def traced(self, seconds: float, stages) -> dict:
        """The window with the program's stage timers on; then, with them
        off, host syncs over `sync_solves` solves and a profile of
        `profile_solves` solves. Every solve is an answer."""
        t = self.traffic["trace"]
        stages.enable()
        first = len(self._diag)
        e2e = self.window(seconds)
        stage_ms = stages.collect()
        stages.enable(False)
        rounds = torch.stack([r.max() for r, _ in self._diag[first:]]).cpu().tolist()
        rec = {"kind": "batch", "solves": e2e["solves"], "batch": self.size, "stage_ms": stage_ms,
               "rounds_max": rounds}

        def solve(counter=None) -> int:
            (pose, diag), n = counter(self._solve) if counter else (self._solve(), 0)
            self._keep(pose.cpu().numpy(), diag)
            return n

        rec["syncs"] = {"count": sum(solve(tr.count_syncs) for _ in range(t["sync_solves"])),
                        "solves": t["sync_solves"]}
        with tr.profiled() as prof:
            for _ in range(t["profile_solves"]):
                solve()
        rec["profile"] = prof
        rec["profile_solves"] = t["profile_solves"]
        return rec

    def collect(self) -> dict:
        """Every solve's entries as answers, keyed by their index in the batch."""
        B = self.size
        rounds = torch.cat([r for r, _ in self._diag]).cpu().numpy()
        corr = torch.cat([c for _, c in self._diag]).cpu().numpy()
        return {"key": np.tile(np.arange(B), len(self._diag)), "pose": np.concatenate(self.answers["pose"]),
                "rounds": rounds, "corr": corr}

    def reference(self, answers: dict) -> dict:
        """One solve of the batch: {"pose", "rounds", "corr"} by entry."""
        self.batch = self.problems()
        pose, diag = self._solve()
        self._keep(pose.cpu().numpy(), diag)
        out = self.collect()
        return {"pose": out["pose"], "rounds": out["rounds"], "corr": out["corr"]}
