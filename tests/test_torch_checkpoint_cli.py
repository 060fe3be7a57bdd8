"""tloam_torch.utils.checkpoint, tloam_torch.cli, the host timer and the
drives harness against the JAX package, on the CPU.

Checkpoints cross between the packages leaf for leaf (exactly), and one
more frame from the loaded state agrees with the other package's frame at
tests/test_torch_frontend.py's tolerance. The command line's run over a
KITTI tree equals run_sequence on the same (dequantized) scans to the last
bit, and its resumed run equals its uninterrupted run to the last bit.
Mirrors tests/test_checkpoint_cli.py."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tloam_torch import cli as tcli, config as tcfg
from tloam_torch.cloud import Cloud as TCloud
from tloam_torch.io import pointcloud_io as tio
from tloam_torch.pipeline import frontend as tfront
from tloam_torch.utils import checkpoint as tck, drives as tdrives, synthetic as tsyn, timing, trajectory as ttraj

from tloam_tpu import cli as jcli, config as jcfg
from tloam_tpu.cloud import Cloud as JCloud
from tloam_tpu.pipeline import frontend as jfront
from tloam_tpu.utils import checkpoint as jck, drives as jdrives

from tests.test_pipeline import CFG
from tests.test_torch_common import f32, np_of, small_scan, two_threads  # noqa: F401
from tests.test_torch_frontend import CAP, TCFG, assert_frame_matches

pytestmark = pytest.mark.usefixtures("two_threads")


def test_config_fingerprints_match_jax():
    sets = ["odometry.tls.corr_mode=knn", "odometry.submap_edge_cap=4096", "feature.pca_mode=exact"]
    for ov in ((), sets):
        assert tck.config_fingerprint(tcfg.load_pipeline_config(None, ov)) == \
            jck.config_fingerprint(jcfg.load_pipeline_config(None, ov))
    assert tck.config_fingerprint(TCFG) == jck.config_fingerprint(CFG)
    assert tck.config_fingerprint(TCFG) != tck.config_fingerprint(tcfg.PipelineConfig())


@pytest.fixture(scope="module")
def scans():
    return [small_scan(i) for i in range(3)]


def jax_states(scans):
    """The JAX states after frames 0 and 1 and the poses/diagnostics of
    frames 1 and 2 from each."""
    st = jfront.init_state(CFG, jnp.float32)
    out = []
    for xyz, inten in scans:
        raw = JCloud.from_numpy(f32(xyz), f32(inten), capacity=CAP, dtype=jnp.float32)
        st, pose, diag = jfront.odometry_step_nodonate(st, raw, CFG)
        out.append((st, np.asarray(pose), diag))
    return out


def test_checkpoints_cross_between_packages(tmp_path, scans):
    """JAX -> port -> JAX, leaf for leaf, and a frame from each loaded state
    against the other package's frame."""
    ref = jax_states(scans)
    j_state = ref[1][0]  # after frames 0 and 1
    poses = np.stack([r[1] for r in ref[:2]])
    jck.save_state(tmp_path / "jax.npz", j_state, poses, cfg=CFG)
    t_state, t_poses = tck.load_state(tmp_path / "jax.npz", tfront.init_state(TCFG, "cpu"), cfg=TCFG)
    assert t_state.frame_idx == 2 and np.array_equal(t_poses, poses)
    j_leaves = jax.tree.leaves(j_state)
    t_leaves = tck.state_leaves(t_state)
    assert len(j_leaves) == len(t_leaves) == 25
    for a, b in zip(t_leaves, j_leaves):
        assert np.array_equal(np.asarray(a if isinstance(a, int) else np_of(a)), np.asarray(b))
    xyz, inten = scans[2]
    raw = TCloud.from_numpy(f32(xyz), f32(inten), capacity=CAP, device="cpu")
    _, pose_t, diag_t = tfront.odometry_step(t_state, raw, TCFG)
    assert_frame_matches(pose_t, diag_t, ref[2][1], ref[2][2], 2)

    # port -> JAX: the port's state after its own frames 0 and 1
    st = tfront.init_state(TCFG, "cpu")
    for x, e in scans[:2]:
        st, _, _ = tfront.odometry_step(st, TCloud.from_numpy(f32(x), f32(e), capacity=CAP, device="cpu"), TCFG)
    tck.save_state(tmp_path / "torch.npz", st, poses, cfg=TCFG)
    with np.load(tmp_path / "torch.npz", allow_pickle=False) as z:  # plain arrays only
        assert {k: z[k].dtype.kind for k in ("schema", "config_fp")} == {"schema": "U", "config_fp": "U"}
        for k in z.files:
            assert z[k].dtype != object
    j2, _ = jck.load_state(tmp_path / "torch.npz", jfront.init_state(CFG, jnp.float32), cfg=CFG)
    for a, b in zip(jax.tree.leaves(j2), tck.state_leaves(st)):
        assert np.array_equal(np.asarray(a), np.asarray(b if isinstance(b, int) else np_of(b)))
    raw_j = JCloud.from_numpy(f32(xyz), f32(inten), capacity=CAP, dtype=jnp.float32)
    _, pose_j, diag_j = jfront.odometry_step_nodonate(j2, raw_j, CFG)
    _, pose_t2, diag_t2 = tfront.odometry_step(st, raw, TCFG)
    assert_frame_matches(pose_t2, diag_t2, np.asarray(pose_j), diag_j, 2)


def test_checkpoint_mismatches_fail_loudly(tmp_path):
    """As tests/test_checkpoint_cli.py:36: another config's fingerprint,
    another capacity, or a schema that does not describe the leaves."""
    cfg = tcfg.PipelineConfig()
    state = tfront.init_state(cfg, "cpu")._replace(frame_idx=7)
    path = tmp_path / "state.npz"
    tck.save_state(path, state, np.tile(np.eye(4), (7, 1, 1)), cfg=cfg)
    cfg2 = dataclasses.replace(cfg, odometry=dataclasses.replace(cfg.odometry, fallback_rot_decay=0.9))
    with pytest.raises(ValueError, match="different pipeline config"):
        tck.load_state(path, tfront.init_state(cfg2, "cpu"), cfg=cfg2)
    cfg3 = dataclasses.replace(cfg, odometry=dataclasses.replace(cfg.odometry, submap_edge_cap=4096))
    with pytest.raises(ValueError, match="shape|leaves"):
        tck.load_state(path, tfront.init_state(cfg3, "cpu"))
    restored, poses = tck.load_state(path, tfront.init_state(cfg, "cpu"), cfg=cfg)
    assert restored.frame_idx == 7 and poses.shape == (7, 4, 4)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["schema"] = arrays["schema"][::-1].copy()
    np.savez(tmp_path / "bad.npz", **arrays)
    with pytest.raises(ValueError, match="schema"):
        tck.load_state(tmp_path / "bad.npz", tfront.init_state(cfg, "cpu"))


def _cli_sets():
    """TCFG as --set overrides of the default config."""
    out = []

    def walk(a, b, prefix):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if dataclasses.is_dataclass(x):
                walk(x, y, f"{prefix}{f.name}.")
            elif x != y:
                out.append(f"{prefix}{f.name}={x}")

    walk(TCFG, tcfg.PipelineConfig(), "")
    return [a for s in out for a in ("--set", s)]


@pytest.fixture
def deterministic():
    """On the CPU an accumulating index_put_ (the window moments) adds in a
    thread-dependent order unless PyTorch's deterministic algorithms are on;
    on the card it adds in input order either way."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_cli_run_kitti_resume_and_boxes_match_run_sequence(tmp_path, scans, capsys, deterministic):
    """`tloam-torch run --device cpu` over a 3-frame KITTI tree of 24 x 768
    scans equals the packed step it drives, frame by frame, bit for bit, and
    run_sequence on the same scans as the packed transfer dequantizes them;
    a run stopped after frame 2 and resumed from its checkpoint equals the
    uninterrupted run bit for bit."""
    seq = tmp_path / "kitti" / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    deq = []
    for i, (xyz, inten) in enumerate(scans):
        tio.write_kitti_bin(seq / "velodyne" / f"{i:06d}.bin",
                            TCloud.from_numpy(f32(xyz), f32(inten), device="cpu"))
        q, n = TCloud.pack_scan(f32(xyz), f32(inten), capacity=131072)
        c = TCloud.from_packed(torch.from_numpy(q), n)
        deq.append((c.xyz[:n].numpy(), c.intensity[:n].numpy()))
    Tr = np.eye(4)
    Tr[:3, 3] = [0.27, 0.0, -0.08]
    gt = tsyn.straight_trajectory(3, step=0.6)  # small_scan's drive, sensor relative to frame 0
    gt = np.linalg.inv(gt[0])[None] @ gt
    with open(seq / "calib.txt", "w") as f:
        f.write("Tr: " + " ".join(str(v) for v in Tr[:3, :4].ravel()) + "\n")
    cam = Tr @ gt @ np.linalg.inv(Tr)
    np.savetxt(seq / "00.txt", cam[:, :3, :4].reshape(3, 12))

    base = ["run", "--device", "cpu", "--data", str(tmp_path / "kitti"), *_cli_sets()]
    ck = str(tmp_path / "ck.npz")
    assert tcli.main(base + ["--output", str(tmp_path / "a.txt"), "--dump-boxes", str(tmp_path / "boxes.jsonl")]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(base + ["--frames", "2", "--checkpoint-every", "2", "--checkpoint", ck,
                             "--output", str(tmp_path / "b.txt")]) == 0
    assert tcli.main(base + ["--resume", ck, "--output", str(tmp_path / "c.txt")]) == 0
    a = ttraj.load_kitti(tmp_path / "a.txt")
    st, packed = tfront.init_state(TCFG, "cpu"), []
    for xyz, inten in scans:  # the command line's own path, step by step
        st, pose, _ = tfront.odometry_step_packed(st, *TCloud.pack_scan(f32(xyz), f32(inten), capacity=131072), TCFG)
        packed.append(pose.numpy())
    assert np.array_equal(a, np.stack(packed).astype(np.float64))
    # run_sequence holds the same clouds in another memory layout (a strided
    # view of the packed upload), which CPU reductions may sum in another order
    poses_rs, diags = tfront.run_sequence(list(enumerate(deq)), TCFG, device="cpu", raw_cap=131072)
    np.testing.assert_allclose(a, poses_rs, atol=1e-5)
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "c.txt").read_bytes()
    # the metrics line reads the ground truth through calib.txt and 00.txt
    assert metrics["frames"] == 3 and metrics["ate_rmse_m"] == round(ttraj.ate_rmse(gt, a), 4) < 0.1
    lines = [json.loads(s) for s in (tmp_path / "boxes.jsonl").read_text().splitlines()]
    assert [ln["frame"] for ln in lines] == [0, 1, 2]
    assert len(lines[1]["box_min"]) == int(diags[1].box_valid.sum()) > 0


def test_cli_eval_and_info_match_jax(tmp_path, capsys):
    n = 300
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 250, n)
    est = poses.copy()
    est[:, 1, 3] += 0.05
    ttraj.save_kitti(tmp_path / "gt.txt", poses)
    ttraj.save_kitti(tmp_path / "est.txt", est)
    args = ["eval", "--est", str(tmp_path / "est.txt"), "--gt", str(tmp_path / "gt.txt")]
    assert tcli.main(args) == 0
    got = capsys.readouterr().out
    assert jcli.main(args) == 0
    assert got == capsys.readouterr().out and json.loads(got)["ate_rmse_m"] < 0.06
    assert tcli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["torch"] == torch.__version__ and info["cuda_available"] is False and info["devices"] == []


def test_host_timer_report_and_profile_trace(tmp_path):
    """The tracer's report (host ms a span, largest first, then the
    counters) and its spans in a torch.profiler Chrome trace taken while
    it is on."""
    from torch.profiler import ProfilerActivity, profile

    timing.STAGES.enable()
    try:
        for _ in range(2):
            with timing.STAGES.stage("a"):
                torch.ones(3).sum()
        with timing.STAGES.stage("b"):
            pass
        timing.STAGES.count("c", 2)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with timing.STAGES.stage("traced"):
                torch.ones(100).cumsum(0)
        totals = timing.STAGES.collect()
    finally:
        timing.STAGES.enable(False)
    assert set(totals) == {"host:a", "host:b", "host:traced", "count:c"} and totals["count:c"] == 2
    lines = timing.report(totals).splitlines()
    assert len(lines) == 5 and lines[0].split() == ["span", "host", "ms", "device", "ms"]
    assert {ln.split()[0] for ln in lines[1:4]} == {"a", "b", "traced"} and lines[1].split()[2] == "-"
    assert lines[4].split() == ["c", "2", "(count)"]
    host = [float(ln.split()[1]) for ln in lines[1:4]]
    assert host == sorted(host, reverse=True)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert [e for e in events if e.get("name") == "traced"]


def test_drives_scans_cache_and_drive(tmp_path, monkeypatch):
    """The port's scan stream equals the JAX package's and shares its cache;
    a cache filled by two processes equals the serial one; the drive equals
    run_sequence over the same scans."""
    kw = dict(route="c", world_seed=3, cars_seed=11, occ_seed=12, rings=16, az=256)
    monkeypatch.setenv("TLOAM_SCAN_CACHE", str(tmp_path / "a"))
    serial = list(tdrives.scan_stream(3, **kw))
    assert [s[0] for s in serial] == [0, 1, 2]
    for (i, x, e), (j, y, f) in zip(serial, jdrives.scan_stream(3, cache=False, **kw)):
        assert i == j and np.array_equal(x, y) and np.array_equal(e, f)
    cached = list(jdrives.scan_stream(3, **kw))  # the JAX package reads the port's cache
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(serial, cached))
    monkeypatch.setenv("TLOAM_SCAN_CACHE", str(tmp_path / "b"))
    assert tdrives.fill_scan_cache(3, 2, **{k: kw[k] for k in kw}) > 0
    for a, b in zip(serial, tdrives.scan_stream(3, **kw)):
        assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    assert np.array_equal(tdrives.drive_ground_truth(3, "c"), jdrives.drive_ground_truth(3, "c"))

    est, gt_rel, info = tdrives.hard_town_drive(TCFG, frames=3, packed=False, device="cpu", **kw)
    poses, _ = tfront.run_sequence([(i, (x, e)) for i, x, e in serial], TCFG, device="cpu", raw_cap=4096)
    assert np.array_equal(est, poses) and info["degenerate_frames"] == 0
    m = tdrives.drive_metrics(est, gt_rel)
    assert m == jdrives.drive_metrics(est, gt_rel)
