"""The tracer (tloam_torch/utils/timing.STAGES) inside the odometry frame.

Spans of stable names nest as the benchmark's metrics read them, the sync
counters count each pass of the solver's round loop, each 6x6 eigen solve
and the ground segmentation's copy from the host, the tracer adds nothing to a frame while it is off, and its spans
reach a torch.profiler trace only while it is on. Frames are 24 x 768
synthetic scans under the reduced capacities of tests/test_pipeline.py.

This file imports neither JAX nor the JAX package. The test marked `cuda`
skips without a card; on a machine with one, from the repo root:

    python -m pytest --noconftest tests/test_torch_trace.py -q
"""
import contextlib
import warnings

import numpy as np
import pytest
import torch

from tloam_torch.cloud import Cloud
from tloam_torch.config import OdometryConfig, PipelineConfig, TLSConfig
from tloam_torch.pipeline import frontend
from tloam_torch.utils import synthetic, timing
from tloam_torch.utils.op_count import count_ops

STAGES = timing.STAGES
CFG = PipelineConfig(
    odometry=OdometryConfig(scan_edge_cap=2048, scan_sphere_cap=256, scan_planar_cap=1024, scan_ground_cap=4096,
                            submap_edge_cap=8192, submap_ground_cap=8192, tls=TLSConfig(max_per_cell=8)),
    max_voxels=16384, max_clusters=64, frame_planar_cap=2048, frame_sphere_cap=512,
)
RINGS, AZ = 24, 768
FRAMES = 6
# each span of a solving frame and the span it sits in
PARENT = {
    "intake": "frame", "ground": "frame", "dcvc": "frame", "edge": "frame", "features": "frame",
    "voxel": "frame", "solve": "frame", "submap": "frame", "sync.ground.bounds": "ground",
    "solve.grids": "solve", "sync.solve.read": "solve", "solve.correspond": "solve", "solve.gn": "solve",
    "solve.gnc": "solve", "sync.solve.eigh": "solve.gn",
}
NAMES = {"frame", *PARENT}
CHILDREN = ("solve.grids", "sync.solve.read", "solve.correspond", "solve.gn", "solve.gnc")


@pytest.fixture(scope="module")
def drive():
    """Packed scans of a short straight drive, and the state after frames 0
    and 1 (frame 2 is the first with a two-frame submap)."""
    scene = synthetic.Scene.urban(np.random.default_rng(5))
    gt = synthetic.straight_trajectory(FRAMES, step=0.6)
    scans = [Cloud.pack_scan(*synthetic.simulate_scan(gt[i], scene, rings=RINGS, az_steps=AZ,
                                                      rng=np.random.default_rng(i), noise=0.005),
                             capacity=RINGS * AZ) for i in range(FRAMES)]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    # the CPU's accumulating index_put_ adds in a thread-dependent order otherwise
    torch.use_deterministic_algorithms(True)
    try:
        state = frontend.init_state(CFG, "cpu")
        for q, n in scans[:2]:
            state, _, _ = frontend.odometry_step_packed(state, q, n, CFG)
        yield scans, state
    finally:
        torch.use_deterministic_algorithms(False)
        torch.set_num_threads(threads)


@pytest.fixture
def tracer():
    """STAGES on for one test, off after it."""
    STAGES.enable()
    try:
        yield STAGES
    finally:
        STAGES.enable(False)


def step(state, scan):
    return frontend.odometry_step_packed(state, *scan, CFG)


def test_solve_spans_nest_as_named_and_count_each_sync(drive, tracer, monkeypatch):
    scans, state = drive
    seen, stack = set(), ["(top)"]
    stage = tracer.stage

    @contextlib.contextmanager
    def recording(name):
        seen.add((stack[-1], name))
        stack.append(name)
        try:
            with stage(name):
                yield
        finally:
            stack.pop()

    monkeypatch.setattr(tracer, "stage", recording)
    tls = CFG.odometry.tls
    for scan in scans[2:4]:
        state, pose, diag = step(state, scan)
        got = tracer.collect()
        assert seen == {("(top)", "frame")} | {(p, n) for n, p in PARENT.items()}
        assert {k[5:] for k in got if k.startswith("host:")} == NAMES
        # device times wherever CUDA is present, even for a frame on the CPU
        assert NAMES & set(got) == (NAMES if torch.cuda.is_available() else set())
        assert sum(got["host:" + c] for c in CHILDREN) <= got["host:solve"]
        rounds = int(diag.iterations)
        assert 0 < rounds <= tls.max_iterations
        assert got["count:sync.solve.read"] == rounds + (rounds < tls.max_iterations)
        assert got["count:sync.solve.eigh"] == tls.inner_iterations * rounds
        assert got["count:sync.ground.bounds"] == 1
        assert "count:edge_pick.launch" not in got  # the CPU runs the plain picks
        seen.clear()


def test_a_host_bool_allow_fallback_is_a_counted_sync(drive, tracer):
    """The batched solve's default allow_fallback (a host bool) is copied to
    the device: one sync a solve. The frame passes a device tensor: none."""
    from tloam_torch.models.registration import scan_matching

    scans, state = drive
    raw = Cloud.from_packed(torch.as_tensor(scans[2][0]), int(scans[2][1]))
    feats = frontend.preprocess_frame(raw, CFG)
    submap = frontend.submap_features(state.submap, CFG)
    tracer.collect()
    for allow, want in ((True, 1), (torch.ones((), dtype=torch.bool), 0)):
        scan_matching(feats.scan, submap, state.predict, CFG.odometry.tls, allow_fallback=allow)
        got = tracer.collect()
        assert got.get("count:sync.solve.fallback", 0) == want
        assert ("host:sync.solve.fallback" in got) == bool(want)


def test_the_tracer_off_records_no_span_and_adds_no_operation(drive, monkeypatch):
    scans, state = drive
    assert not STAGES.enabled
    STAGES.collect()
    _, ops_off = count_ops(lambda: step(state, scans[2]))
    got = STAGES.collect()
    assert got and all(k.startswith("count:sync.") for k in got)  # counters count, spans do not
    monkeypatch.setattr(STAGES, "stage", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(STAGES, "sync", lambda name: contextlib.nullcontext())
    _, ops_bare = count_ops(lambda: step(state, scans[2]))
    assert ops_off == ops_bare and sum(ops_off.values()) > 1000


def test_enable_resets_spans_and_counters(tracer):
    with tracer.stage("a"):
        tracer.count("b", 3)
    with tracer.sync("c"):
        pass
    tracer.enable()
    assert tracer.collect() == {}
    with tracer.stage("a"):
        tracer.count("b")
    got = tracer.collect()
    assert set(got) - {"a"} == {"host:a", "count:b"} and ("a" in got) == torch.cuda.is_available()
    assert got["count:b"] == 1 and got["host:a"] >= 0.0
    assert tracer.collect() == {}
    tracer.count("b", 2)
    tracer.enable(False)
    assert tracer.collect() == {}
    total = tracer.counts["b"]
    tracer.count("b", 2)
    assert tracer.counts["b"] == total + 2  # the totals only grow
    assert tracer.stage("a") is tracer.stage("d")  # off: one shared null context


def program_events(prof):
    return [(ev.name, ev.time_range.start, ev.time_range.end) for ev in prof.events() if ev.name in NAMES]


def test_spans_reach_a_profiler_only_while_the_tracer_is_on(drive):
    from torch.profiler import ProfilerActivity, profile

    scans, state = drive
    STAGES.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, scans[2])
    finally:
        STAGES.enable(False)
    events = program_events(prof)
    assert {n for n, _, _ in events} == NAMES
    for name, s, e in events:
        if name != "frame":
            assert any(pn == PARENT[name] and ps <= s and e <= pe for pn, ps, pe in events), name
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, scans[2])
    assert program_events(prof) == []


def count_syncs(fn):
    """(fn(), host syncs fn made), from CUDA's sync debug warnings. The
    first switch to "warn" in a process also warns that the mode is a
    prototype; that warning names no sync and is not counted."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


@pytest.mark.cuda
def test_program_counts_every_host_sync_of_steady_frames_on_gpu(drive):
    """Frames 2-4 on the card: the program's sync counters add up to what
    CUDA's sync debug mode counts over the same frames (each pose read
    outside), and every span has a device and a host time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scans, _ = drive
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)  # the card runs its own kernels, as in a deployment
    try:
        state = frontend.init_state(CFG, "cuda")
        for scan in scans[:2]:
            state, pose, _ = step(state, scan)
            pose.cpu()
        STAGES.enable()
        warned, reads, eighs = 0, 0, 0
        tls = CFG.odometry.tls
        for scan in scans[2:5]:
            (state, pose, diag), n = count_syncs(lambda: step(state, scan))
            pose.cpu()
            warned += n
            rounds = int(diag.iterations)
            reads += rounds + (rounds < tls.max_iterations)
            eighs += tls.inner_iterations * rounds
        got = STAGES.collect()
    finally:
        STAGES.enable(False)
        torch.use_deterministic_algorithms(deterministic)
    program = sum(v for k, v in got.items() if k.startswith("count:sync."))
    assert program == warned > 0, got
    assert got["count:sync.solve.read"] == reads and got["count:sync.solve.eigh"] == eighs
    assert got["count:edge_pick.launch"] == 3
    for name in NAMES:
        assert got[name] > 0.0 and got["host:" + name] > 0.0, name
