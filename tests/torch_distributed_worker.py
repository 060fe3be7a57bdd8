"""One rank of the port's multi-process CPU run (gloo), launched by
tests/test_torch_distributed.py:

    python tests/torch_distributed_worker.py <host:port> <world> <rank> <inputs.npz> <cfg.json> <out.npz>

Imports only torch, numpy and tloam_torch. Every rank holds the whole
inputs; it joins the process group, then runs in order (every rank runs
every step, as collectives need):

  1. the consensus solve of one frame on a (1, world) mesh: the scan
     points sharded over "points", with the config "consensus", then with
     "caps" (caps that bind);
  2. `_cap_first_n` of a sharded mask with `also_count` over "points";
  3. `sharded_scan_matching` of the 8-frame batch on a (world, 1) mesh;
  4. a (2, world/2) mesh: this rank's coordinate, the ranks of its two
     axis groups, and its slices by frame_sharding, point_sharding and
     replicated;
  5. `process_frame_range(10)`.

and writes what it got to <out.npz>.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def features(z, prefix, Cloud, FeatureSet, torch):
    return FeatureSet(*(
        Cloud(*(torch.from_numpy(z[f"{prefix}/{name}/{f}"]) for f in ("xyz", "intensity", "valid")))
        for name in FeatureSet._fields
    ))


def main():
    addr, world, rank, inputs, cfg_path, out_path = sys.argv[1:7]
    world, rank = int(world), int(rank)
    import numpy as np
    import torch
    import torch.distributed as dist

    from tloam_torch.cloud import Cloud
    from tloam_torch.config import TLSConfig
    from tloam_torch.models.registration import FeatureSet, _cap_first_n
    from tloam_torch.parallel import batched, mesh as mesh_lib

    torch.set_num_threads(2)
    mesh_lib.bootstrap_distributed(addr, world, rank, backend="gloo", timeout_s=60)
    mesh_lib.bootstrap_distributed(addr, world, rank, backend="gloo")  # idempotent
    with open(cfg_path) as f:
        cfgs = {k: TLSConfig(**v) for k, v in json.load(f).items()}
    z = np.load(inputs)
    out = {}

    points = mesh_lib.make_mesh(frames=1, device="cpu")  # 1 x world
    scan, submap = features(z, "scan", Cloud, FeatureSet, torch), features(z, "submap", Cloud, FeatureSet, torch)
    eye = torch.eye(4, dtype=torch.float64)
    for name in ("consensus", "caps"):
        pose, diag = batched.distributed_scan_matching(scan, submap, eye, cfgs[name], points)
        out[f"{name}_pose"], out[f"{name}_num_corr"] = pose.numpy(), diag.num_corr.numpy()
        out[f"{name}_iterations"] = diag.iterations.numpy()

    sl = mesh_lib.axis_slice(points, "points", z["cap_valid"].shape[0])
    valid, no_hit = torch.from_numpy(z["cap_valid"][sl]), torch.from_numpy(z["cap_no_hit"][sl])
    out["cap_local"] = _cap_first_n(valid, int(z["cap_maxnum"]), also_count=no_hit,
                                    group=points.get_group("points")).numpy()

    frames = mesh_lib.make_mesh(device="cpu")  # world x 1
    scans, submaps = features(z, "scans", Cloud, FeatureSet, torch), features(z, "submaps", Cloud, FeatureSet, torch)
    predicts = eye.expand(scans.planar.xyz.shape[0], 4, 4).clone()
    poses, diags = batched.sharded_scan_matching(scans, submaps, predicts, cfgs["base"], frames)
    out["sharded_poses"], out["sharded_iterations"] = poses.numpy(), diags.iterations.numpy()

    grid = mesh_lib.make_mesh(frames=2, device="cpu")
    out["mesh_coordinate"] = np.asarray(grid.get_coordinate())
    for axis in ("frames", "points"):
        out[f"mesh_{axis}_ranks"] = np.asarray(dist.get_process_group_ranks(grid.get_group(axis)))
    out["frame_sharding"] = mesh_lib.frame_sharding(grid)(torch.arange(8)).numpy()
    out["point_sharding"] = mesh_lib.point_sharding(grid)(torch.arange(16).view(2, 8)).numpy()
    out["replicated"] = mesh_lib.replicated(grid)(torch.arange(3)).numpy()
    out["frame_range"] = np.asarray(mesh_lib.process_frame_range(10))
    np.savez(out_path, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
