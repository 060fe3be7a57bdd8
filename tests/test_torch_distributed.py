"""tloam_torch.parallel across processes: four gloo ranks on the CPU,
spawned once for the module (tests/torch_distributed_worker.py, which
imports only torch and tloam_torch), against the JAX package's one-device
solve computed here. Mirrors tests/test_parallel.py:60-170 and
tests/test_distributed.py on the frame pairs of tests/test_parallel.py
(float64, numpy seed 0):

  * the consensus solve on a (1, 4) mesh: pose within 2e-5 of the JAX
    solve, num_corr exact; the same with caps that bind;
  * `_cap_first_n` with `also_count` sharded over 4 ranks: exactly the JAX
    unsharded mask;
  * `sharded_scan_matching` of 8 frames on a (4, 1) mesh against the port's
    `vmap_scan_matching` at 2e-5;
  * `make_mesh(frames=2)` coordinates, groups and slices;
    `process_frame_range`.

A rank that hangs fails the module: the process group times out after 60 s
and the ranks are joined with a timeout."""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tloam_torch.cloud import stack_tensors as stack
from tloam_torch.parallel import batched as tbatched, mesh as tmesh

from tloam_tpu.models.registration import _cap_first_n, scan_matching

from tests.test_parallel import make_pair
from tests.test_registration import CFG
from tests.test_torch_parallel import TCFG, pairs, torch_features

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
JOIN_TIMEOUT_S = 300
CONFIGS = {
    "base": CFG,
    "consensus": dataclasses.replace(CFG, ground_maxnum=8192, planar_maxnum=8192),
    "caps": dataclasses.replace(CFG, ground_maxnum=300, planar_maxnum=200, edge_maxnum=64, sphere_maxnum=16),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The batched CPU solves run on 2 intra-op threads: the suite runs
    several test processes at once, and more threads than cores slow every
    one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _put(arrays: dict, prefix: str, fs) -> None:
    for name, cloud in zip(fs._fields, fs):
        for f in ("xyz", "intensity", "valid"):
            arrays[f"{prefix}/{name}/{f}"] = np.asarray(getattr(cloud, f))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs, the ranks' outputs and the port's 8-frame batch."""
    tmp = tmp_path_factory.mktemp("torch_dist")
    scan, submap, T_true = make_pair(np.random.default_rng(0), dtype=jnp.float64)
    rng = np.random.default_rng(0)
    valid = rng.uniform(size=1024) < 0.3
    no_hit = (rng.uniform(size=1024) < 0.4) & ~valid
    batch = pairs(4) * 2
    scans, submaps = stack([torch_features(p[0]) for p in batch]), stack([torch_features(p[1]) for p in batch])
    arrays = {"cap_valid": valid, "cap_no_hit": no_hit, "cap_maxnum": np.asarray(64)}
    _put(arrays, "scan", scan)
    _put(arrays, "submap", submap)
    _put(arrays, "scans", scans)
    _put(arrays, "submaps", submaps)
    np.savez(tmp / "inputs.npz", **arrays)
    (tmp / "cfg.json").write_text(json.dumps({k: dataclasses.asdict(v) for k, v in CONFIGS.items()}))

    addr = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_distributed_worker.py"), addr, str(WORLD), str(r),
             str(tmp / "inputs.npz"), str(tmp / "cfg.json"), str(tmp / f"rank{r}.npz")],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    predicts = torch.eye(4, dtype=torch.float64).expand(8, 4, 4).clone()
    vmapped, _ = tbatched.vmap_scan_matching(scans, submaps, predicts, TCFG)
    return dict(scan=scan, submap=submap, T_true=T_true, valid=valid, no_hit=no_hit, ranks=ranks,
                vmapped=vmapped.numpy())


def _jax_single(run, cfg):
    return jax.jit(scan_matching, static_argnums=3)(run["scan"], run["submap"], jnp.eye(4, dtype=jnp.float64), cfg)


@pytest.mark.parametrize("name", ["consensus", "caps"])
def test_consensus_matches_jax_single(run, name):
    """The point-sharded solve with the normal equations all-reduced every
    GN step: pose within 2e-5 of the JAX one-device solve on every rank,
    the same correspondence counts (exactly; caps that bind admit the
    one-device set)."""
    pose_j, diag_j = _jax_single(run, CONFIGS[name])
    for r, out in enumerate(run["ranks"]):
        np.testing.assert_allclose(out[f"{name}_pose"], np.asarray(pose_j), atol=2e-5, err_msg=str(r))
        np.testing.assert_array_equal(out[f"{name}_num_corr"], np.asarray(diag_j.num_corr), err_msg=str(r))
    if name == "caps":  # the caps really bound
        assert run["ranks"][0]["caps_num_corr"][:2].tolist() == [200, 300]


def test_cap_first_n_sharded_matches_jax(run):
    got = np.concatenate([out["cap_local"] for out in run["ranks"]])
    ref = np.asarray(_cap_first_n(jnp.asarray(run["valid"]), 64, also_count=jnp.asarray(run["no_hit"])))
    np.testing.assert_array_equal(got, ref)
    assert ref.sum() < run["valid"].sum()  # the cap bound
    assert not np.array_equal(np.asarray(_cap_first_n(jnp.asarray(run["valid"]), 64)), ref)  # also_count counted


def test_sharded_frames_matches_vmap(run):
    for r, out in enumerate(run["ranks"]):
        np.testing.assert_allclose(out["sharded_poses"], run["vmapped"], atol=2e-5, err_msg=str(r))
        assert out["sharded_iterations"].min() > 0, r  # every frame of the batch was solved somewhere


def test_make_mesh_frames_axis_and_frame_range(run):
    """make_mesh(frames=2) on 4 ranks is 2 x 2 with rank r at (r // 2, r % 2),
    as tloam_tpu/parallel/mesh.py lays its devices out, and the sharding
    helpers cut that coordinate's slices; process_frame_range splits 10
    frames 3/3/3/1, and is the whole stream outside a group."""
    for r, out in enumerate(run["ranks"]):
        assert out["mesh_coordinate"].tolist() == [r // 2, r % 2]
        assert out["mesh_frames_ranks"].tolist() == [r % 2, r % 2 + 2]
        assert out["mesh_points_ranks"].tolist() == [r - r % 2, r - r % 2 + 1]
        assert out["frame_sharding"].tolist() == list(range(4 * (r // 2), 4 * (r // 2) + 4))
        assert out["point_sharding"].tolist() == [list(range(4 * (r % 2), 4 * (r % 2) + 4)),
                                                  list(range(8 + 4 * (r % 2), 12 + 4 * (r % 2)))]
        assert out["replicated"].tolist() == [0, 1, 2]
        assert out["frame_range"].tolist() == [3 * r, min(3 * r + 3, 10)]
    assert tmesh.process_frame_range(10) == (0, 10)
