"""The port's measurement scripts (scripts/torch_{solver_bench,batched_bench,
modes_bench,sweep}.py) against the JAX package's (scripts/solver_bench.py,
batched_bench.py, modes_bench.py, sweep.py): their wiring, on the CPU.

What is held here: the argument parsers (the same flags and defaults; the
port adds --device, --out, --merge and the flags listed in ADDED, and its
--batch is a list that starts with the JAX default), the sweep's run list
(route, world, cars, occlusions, frames, width), the mode table, the sweep
file (sweep._write's payload, field for field, from one call or merged from
two), the mode matrix's scans (bit for bit), and each script's main on the
CPU at 24 x 768 for 2 frames (finite fields).

Trajectories are not compared at this size: the hard-town drive does not
track at reduced width in either package. Measured on the CPU, the drift
after 4 frames at 32 x 600 is 2.92 m (JAX) and 2.71 m (port), ATE 1.09 m
and 1.00 m; after 3 frames at 16 x 256, 1.99 m in both. The full-width
trajectories are held on the card (chip_smoke.py phases 6 and 12, and the
scripts' own limits). The drive and the batched solve are held to the JAX
package at test sizes elsewhere: tests/test_torch_checkpoint_cli.py::
test_drives_scans_cache_and_drive (the drives harness), tests/
test_torch_parallel.py::test_vmap_batched_matches_jax_and_single and
::test_batched_modes_match_single (the batched solve) and
tests/test_torch_modes_frontend.py (every mode's frames)."""
import argparse
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_common import two_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("two_threads")

REPO = Path(__file__).resolve().parents[1]
PAIRS = {"torch_solver_bench": "solver_bench", "torch_batched_bench": "batched_bench",
         "torch_modes_bench": "modes_bench", "torch_sweep": "sweep"}
# flags of the port's scripts that the JAX scripts lack
ADDED = {
    "torch_solver_bench": {"device", "out"},
    "torch_batched_bench": {"device", "out", "workers", "modes"},
    "torch_modes_bench": {"device", "workers", "rest_start_realizations"},
    "torch_sweep": {"device", "workers", "merge"},
}


@pytest.fixture(scope="module")
def scan_cache(tmp_path_factory):
    """One raycast cache for the module: the mode matrix's scans are the
    first frames of the sweep's route-a world-3 run."""
    return str(tmp_path_factory.mktemp("scan_cache"))


def load(name: str):
    spec = importlib.util.spec_from_file_location(f"_harness_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def jax_parser(name: str, monkeypatch) -> argparse.ArgumentParser:
    """The parser a JAX script builds inside its main(), caught at
    parse_args."""
    got = {}

    def catch(self, args=None, namespace=None):
        got["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed):
            load(name).main()
    return got["parser"]


def flags(ap: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs, type(a).__name__)
            for a in ap._actions if a.dest != "help"}


@pytest.mark.parametrize("port", sorted(PAIRS))
def test_parsers_match_the_jax_scripts(port, monkeypatch):
    want = flags(jax_parser(PAIRS[port], monkeypatch))
    got = flags(load(port).parser())
    assert set(got) - ADDED[port] == set(want)
    for dest, spec in want.items():
        if (port, dest) == ("torch_batched_bench", "batch"):
            assert got[dest][0] == spec[0] and got[dest][1].split(",")[0] == str(spec[1])
        else:
            assert got[dest] == spec, dest


def test_sweep_runs_the_jax_loop(tmp_path, monkeypatch):
    """Both sweeps drive the same (route, world, cars, occlusions) list at
    the same frames and width, with the drives harness stubbed out."""
    from tloam_torch.utils import drives as tdrives

    from tloam_tpu.utils import drives as jdrives

    calls = {"jax": [], "port": []}

    def stub(key):
        def drive(cfg, frames, route, world_seed, cars_seed, occ_seed, rings, az, **kw):
            calls[key].append((route, world_seed, cars_seed, occ_seed, frames, rings, az))
            return np.stack([np.eye(4)] * 2), np.stack([np.eye(4)] * 2), {"degenerate_frames": 0, "wall_s": 1.0}
        return drive

    metrics = lambda est, gt: {"kitti_t_err_pct": 1.0, "kitti_r_err_deg_per_100m": 0.1, "ate_rmse_m": 0.1}  # noqa: E731
    monkeypatch.setattr(jdrives, "hard_town_drive", stub("jax"))
    monkeypatch.setattr(jdrives, "drive_metrics", metrics)
    monkeypatch.setattr(tdrives, "hard_town_drive", stub("port"))
    monkeypatch.setattr(tdrives, "drive_metrics", metrics)
    monkeypatch.setattr(tdrives, "fill_scan_cache", lambda frames, processes, **drive: 0.0)
    monkeypatch.setattr(sys, "argv", ["sweep.py", "--out", str(tmp_path / "jax.json")])
    load("sweep").main()
    port = load("torch_sweep")
    port.main(["--device", "cpu", "--out", str(tmp_path / "port.json")])
    assert len(calls["jax"]) == 10 and calls["port"] == calls["jax"]
    assert [r[:5] for r in port.run_list("a,b", 5)] == [(c[0], s % 5, *c[1:4]) for s, c in enumerate(calls["jax"])]


def test_mode_table_matches():
    assert load("torch_modes_bench").MODES == load("modes_bench").MODES


def test_sweep_payload_matches_the_jax_write(tmp_path):
    """sweep._write's payload from one list of runs (SWEEP_r05.json's, one
    with no KITTI segment), and the port's --merge of two part files."""
    runs = json.loads((REPO / "SWEEP_r05.json").read_text())["runs"]
    runs[4] = dict(runs[4], kitti_t_err_pct=None)
    def ns(out):
        return argparse.Namespace(frames=120, set=["odometry.tls.factor_num=3"], out=str(out), round=4)

    want = load("sweep")._write(ns(tmp_path / "jax.json"), runs)
    port = load("torch_sweep")
    got = port._write(ns(tmp_path / "port.json"), runs)
    assert got == want and list(got) == list(want)
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    port._write(ns(tmp_path / "a.json"), runs[:5])
    port._write(ns(tmp_path / "b.json"), runs[5:])
    merged = port.main(["--merge", f"{tmp_path / 'a.json'},{tmp_path / 'b.json'}", "--out", str(tmp_path / "m.json")])
    assert merged == want


def test_modes_scans_match_the_jax_script(tmp_path, monkeypatch, scan_cache):
    """The mode matrix's first 2 scans at 24 x 768, as the JAX script makes
    them (its run_mode stubbed to catch them) and as the port reads them
    back from the scan cache."""
    jax_mb = load("modes_bench")
    caught = []

    def run_mode(overrides, scans, gt_rel, cap, n_warm, extra=()):
        caught.append(scans)
        return {"final_pose_t": [0.0, 0.0, 0.0]}

    monkeypatch.setattr(jax_mb, "run_mode", run_mode)
    monkeypatch.setattr(sys, "argv", ["modes_bench.py", "--frames", "2", "--rings", "24", "--az", "768",
                                      "--modes", "default", "--out", str(tmp_path / "jax.json")])
    jax_mb.main()
    monkeypatch.setenv("TLOAM_SCAN_CACHE", scan_cache)
    got = load("torch_modes_bench").make_scans(2, 24, 768, workers=1)
    assert len(caught[0]) == len(got) == 2
    for (xj, ej), (xt, et) in zip(caught[0], got):
        assert xj.dtype == xt.dtype and ej.dtype == et.dtype
        assert np.array_equal(xj, xt) and np.array_equal(ej, et)


@pytest.mark.parametrize("port", sorted(PAIRS))
def test_scripts_need_a_gpu_unless_cpu_is_named(port, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(port).main(["--out", "unused.json"])


def numbers(tree):
    """Every int and float leaf of a JSON tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from numbers(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from numbers(v)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield tree


SMALL = {
    "torch_solver_bench": ["--frames", "2", "--reps", "1"],
    "torch_batched_bench": ["--batch", "2", "--n", "1", "--modes", "factor3", "--workers", "1"],
    "torch_modes_bench": ["--frames", "2", "--warm", "1", "--rings", "24", "--az", "768", "--modes", "default,factor3",
                          "--workers", "1"],
    "torch_sweep": ["--frames", "2", "--seeds", "1", "--routes", "a", "--rings", "24", "--az", "768",
                    "--workers", "1"],
}


@pytest.mark.parametrize("port", sorted(PAIRS))
def test_main_runs_small_on_the_cpu(port, tmp_path, monkeypatch, scan_cache):
    """Each script end to end on the CPU at 24 x 768 (the benches' fixed
    width and batch of 64 patched down), its file equal to what main
    returns, every number finite."""
    monkeypatch.setenv("TLOAM_SCAN_CACHE", scan_cache)
    mod = load(port)
    if port in ("torch_solver_bench", "torch_batched_bench"):
        monkeypatch.setattr(mod, "RINGS", 24)
        monkeypatch.setattr(mod, "AZ", 768)
        monkeypatch.setattr(mod, "CAP", 1 << 15)
    if port == "torch_batched_bench":
        monkeypatch.setattr(mod, "MODE_BATCH", 2)
    out = tmp_path / "out.json"
    payload = mod.main(SMALL[port] + ["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(payload))
    assert all(math.isfinite(v) for v in numbers(payload))
    assert payload.get("backend", "cpu") == "cpu"
    if port == "torch_solver_bench":
        assert payload["n_solves_timed"] == 2 and payload["mean_outer_iters"] >= 1
        assert payload["value"] == pytest.approx(payload["solves_per_s"] * payload["mean_outer_iters"] * 4)
    elif port == "torch_batched_bench":
        assert list(payload["batches"]) == [2] and list(payload["modes"]) == ["factor3"]
        assert payload["ok"] and payload["modes"]["factor3"]["held_to_single"]["entries"] == 2
    elif port == "torch_modes_bench":
        assert sorted(payload["modes"]) == ["default", "factor3"] and payload["modes"]["factor3"]["corr_last"][3] == 0
    else:
        (run,) = payload["runs"]
        assert run["degenerate_frames"] == 0 and run["finite"] and run["record_r05"]["ate_rmse_m"] == 0.2582
        assert set(payload) == set(load("sweep")._write(argparse.Namespace(
            frames=2, set=[], out=str(tmp_path / "jax.json"), round=4), payload["runs"]))
