"""BENCHMARK.json and the files it names: found by name, added as files."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from lidar_bench.harness import programs, spec
from lidar_bench.tests.conftest import SEED, write_piece

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_names_files_that_exist_and_reports_what_it_must():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and (spec.ROOT / c["file"]).is_file()
        assert spec.config(c["name"])["name"] == c["name"]
        assert c["reduced"] == spec.config(c["name"])["reduced"]
        # its reference piece (the frozen reference where it names none) exists and binds what the drivers call
        piece = spec.config(c["name"]).get("reference", programs.DEFAULT_REFERENCE)
        assert (spec.BENCH_DIR / piece / "__init__.py").is_file()
        ref = programs.reference(spec.config(c["name"]))
        assert ref.name == piece
        assert all(callable(f) for f in (ref.Cloud, ref.stack_tensors, ref.load_config, ref.solve))
        assert all(callable(getattr(ref.frontend, f)) for f in (
            "init_state", "odometry_step_packed", "preprocess_frame", "submap_features", "odometry_step"))
        assert callable(ref.Cloud.pack_scan) and callable(ref.Cloud.from_packed)
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert spec.traffic(w["traffic"])["kind"] in ("stream", "batch")
        assert set(spec.limits(w["name"])) <= {"pose_gap_m", "pose_gap_rad", "rounds_gap", "corr_gap"}
        names = {m["name"] for m in spec.metrics_for(bench["end_to_end"], w["name"])}
        assert "setup_s" in names and len(names) >= 2
        layer = spec.metrics_for(bench["per_layer"], w["name"])
        assert layer and all(m["moves"] in names for m in layer)
        for m in layer:
            assert callable(spec.reader(m["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert all(0.0 < m["bound"] <= 0.25 for m in bench["end_to_end"])


def test_a_config_a_traffic_mix_and_a_metric_are_added_as_files_alone(tmp_path, pieces):
    dst = tmp_path / "lidar_bench"
    shutil.copytree(spec.BENCH_DIR, dst, ignore=shutil.ignore_patterns(".scan_cache", "__pycache__"))
    before = {f: f.read_bytes() for f in dst.rglob("*") if f.is_file()}
    bench = spec.benchmark()
    c = spec.config("kitti-hdl64.cell_plane", dst)
    c["name"] = "kitti-hdl64.factor3"
    c["overrides"]["odometry.tls.factor_num"] = 3
    # its own reference piece, a new directory: a registration of its own, the rest frozen
    c["reference"] = "reference_factor3"
    write_piece(dst, "reference_factor3", {
        "__init__.py": "from lidar_bench.reference import cloud, config, frontend\nfrom . import registration\n",
        "registration.py": "from lidar_bench.reference.registration import scan_matching  # noqa: F401\n"})
    (dst / "configs" / "kitti-hdl64.factor3.json").write_text(json.dumps(c))
    t = spec.traffic("batch64-urban", dst)
    t["replicas"] = 1
    (dst / "traffic" / "batch16-urban.json").write_text(json.dumps(t))
    (dst / "limits" / "factor3.batch16-urban.json").write_text(json.dumps({"pose_gap_m": 1e-3}))
    (dst / "metrics" / "solves_in_window.batch.py").write_text(
        "def read(rec):\n    return rec['solves'] if rec.get('kind') == 'batch' else None\n")
    bench["workloads"].append({"name": "factor3.batch16-urban", "config": "kitti-hdl64.factor3",
                               "traffic": "batch16-urban", "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({"name": "solves_in_window.batch", "unit": "solves", "better": "higher",
                               "source": "host_clock", "layer": "batch driver", "moves": "batch_frames_per_s",
                               "workloads": ["factor3.batch16-urban"]})
    w = spec.workload(bench, "factor3.batch16-urban")
    assert spec.config(w["config"], dst)["overrides"]["odometry.tls.factor_num"] == 3
    assert spec.traffic(w["traffic"], dst)["replicas"] == 1
    assert spec.limits(w["name"], dst) == {"pose_gap_m": 1e-3}
    got = [m["name"] for m in spec.metrics_for(bench["per_layer"], w["name"])]
    assert "solves_in_window.batch" in got and "edge_pick_roofline" not in got
    assert spec.reader("solves_in_window.batch", dst)({"kind": "batch", "solves": 7}) == 7
    pieces(dst)
    ref = programs.reference(spec.config(w["config"], dst))
    assert ref.name == "reference_factor3" and ref.solve.__module__ == "lidar_bench.reference.registration"
    assert programs.reference(spec.config("kitti-hdl64.cell_plane", dst)).name == "reference"
    with pytest.raises(KeyError):
        spec.workload(bench, "no.such-cell")
    # every file that was there is as it was: the cell, its configuration and its piece are new files
    after = {f: f.read_bytes() for f in dst.rglob("*") if f.is_file() and "__pycache__" not in f.parts}
    assert {f: after[f] for f in before} == before
    assert {f.relative_to(dst).as_posix() for f in set(after) - set(before)} == {
        "configs/kitti-hdl64.factor3.json", "traffic/batch16-urban.json", "limits/factor3.batch16-urban.json",
        "metrics/solves_in_window.batch.py", "reference_factor3/__init__.py", "reference_factor3/registration.py"}


def test_a_reader_that_finds_nothing_returns_none():
    bench = spec.benchmark()
    for m in bench["per_layer"]:
        kind = "batch" if "stream" in m["name"] or m["name"] == "edge_pick_roofline" else "stream"
        assert spec.reader(m["name"])({"kind": kind, "profile": {"kernels": {}}}) is None


def test_the_seed_may_pass_32_signed_bits():
    assert SEED > 2**31


def test_a_fixed_drive_lets_the_seed_pick_the_noise_alone():
    import numpy as np

    from lidar_bench.harness import scans as scans_mod

    rng = np.random.default_rng(0)
    drive = [(rng.normal(size=(n, 3)).astype(np.float32), np.full(n, 0.5, np.float32)) for n in (500, 700)]
    a = scans_mod.seeded_noise(drive, 0.01, SEED)
    again = scans_mod.seeded_noise(drive, 0.01, SEED)
    other = scans_mod.seeded_noise(drive, 0.01, SEED + 1)
    for (x, t), (xa, ta), (x2, _), (xo, _) in zip(drive, a, again, other):
        assert xa.dtype == np.float32 and xa.shape == x.shape and ta is t
        assert np.array_equal(xa, x2) and not np.array_equal(xa, xo)
        assert 0.008 < float(np.std(xa - x)) < 0.012
    assert spec.traffic("stream-urban")["drive"]["noise"] == 0.0 and "drive_seed" in spec.traffic("stream-urban")
