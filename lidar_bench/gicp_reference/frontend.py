"""Odometry front end: the per-frame pipeline + rolling submap.

A copy of the frozen reference's ``frontend.py``, line for line, but for
its imports: ``scan_matching`` (and the ``Diagnostics`` and ``FeatureSet``
it returns) come from this package's ``registration``, the configuration
from its ``config``, and the rest from ``lidar_bench.reference``. The
frame path binds ``scan_matching`` when it is imported, so a batch's
problems, captured through ``odometry_step``, come from GICP solves.

Upstream's FrontEnd (zhoupengwei/tloam, src/front_end/front_end.cpp:14-338)
is the same whatever the surface factor: close-point filtering, ground
removal, DCVC, edges, PCA features, voxels, the scan-to-map solve and the
submap update.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_bench.reference import dcvc, edge as edge_mod, features, se3, segmentation, voxel
from lidar_bench.reference.cloud import Cloud

from .config import PipelineConfig  # noqa: F401  (re-exported)
from .registration import Diagnostics, FeatureSet, scan_matching


class ScanFeatures(NamedTuple):
    """Everything one frame contributes downstream."""

    scan: FeatureSet  # solver inputs (downsampled / scan-class)
    planar_frame: Cloud  # submap-class planar features (sensor frame)
    sphere_frame: Cloud  # submap-class sphere features (sensor frame)
    edge_raw: Cloud  # full edge cloud (first-frame submap seed)
    ground_ds: Cloud  # ground at 0.3 voxels
    edge_ds: Cloud  # edge at 0.1 voxels
    num_clusters: torch.Tensor
    box_min: torch.Tensor  # per-cluster AABBs in the sensor frame
    box_max: torch.Tensor
    box_valid: torch.Tensor


class SubmapState(NamedTuple):
    planar_frames: Cloud  # (Wp, cap) ring buffer, sensor frame
    sphere_frames: Cloud  # (Ws, cap)
    frame_poses: torch.Tensor  # (Wp,4,4)
    sphere_poses: torch.Tensor  # (Ws,4,4)
    frames_filled: torch.Tensor  # () int32
    edge_map: Cloud  # world frame, fixed capacity
    ground_map: Cloud  # world frame


class OdometryState(NamedTuple):
    submap: SubmapState
    pose: torch.Tensor  # (4,4) latest world_T_scan
    last_pose: torch.Tensor
    predict: torch.Tensor
    frame_idx: int  # host int: the first-frame branch is plain Python
    unhealthy_streak: torch.Tensor  # () int32
    imp_streak: torch.Tensor  # () int32


# ---------------------------------------------------------------------------
# Per-frame preprocessing (Segmentation + featureExtract + processCloud)
# ---------------------------------------------------------------------------


def segment_objects(raw: Cloud, cfg: PipelineConfig):
    """Close-point filtering, ground removal, object compaction and DCVC:
    (ground segmentation, object cloud, its ring ids, DCVC result)."""
    cloud = raw.remove_nonfinite().remove_close(cfg.sensor.near_dis)
    seg = segmentation.ground_remove(cloud, cfg.sensor, cfg.ground)
    objects, obj_ring = seg.objects, seg.ring
    if cfg.general_cap and cfg.general_cap < objects.capacity:
        # stable compaction of the object cloud (scan order preserved)
        key = (~objects.valid).to(torch.int32)
        _, sx, sy, sz, si, sv, sr = voxel.sort_with_payload(
            key, objects.xyz[:, 0], objects.xyz[:, 1], objects.xyz[:, 2],
            objects.intensity, objects.valid, obj_ring,
        )
        cap = cfg.general_cap
        objects = Cloud(torch.stack([sx[:cap], sy[:cap], sz[:cap]], dim=1), si[:cap], sv[:cap])
        obj_ring = sr[:cap]

    clusters = dcvc.dcvc_segment(
        objects, cfg.dcvc, cfg.sensor, cfg.max_voxels, cfg.max_clusters, cc_iters=cfg.dcvc_cc_iters
    )
    return seg, objects, obj_ring, clusters


def edge_order_key(clusters, n: int) -> torch.Tensor:
    """Per-ring point order of the reference: cluster-major, then scan order."""
    return clusters.labels * n + torch.arange(n, dtype=torch.int32, device=clusters.labels.device)


def preprocess_frame(raw: Cloud, cfg: PipelineConfig) -> ScanFeatures:
    od = cfg.odometry
    seg, objects, obj_ring, clusters = segment_objects(raw, cfg)
    edges = edge_mod.extract_edges(
        clusters.segmented, obj_ring, edge_order_key(clusters, objects.capacity),
        sensor_model=cfg.sensor.sensor_model, ring_min_num=cfg.ground.ring_min_num,
        ring_width=cfg.edge_ring_width,
    )
    edge_cloud = clusters.segmented.mask(edges.edge_mask)
    general_cloud = clusters.segmented.mask(edges.general_mask)

    sel = features.extract_planar_sphere(general_cloud, cfg.feature)
    flat = sel.pca.flatness
    S = cfg.pick_sectors
    planar_frame = features.gather_top(general_cloud, sel.planar_submap, flat, cfg.frame_planar_cap, sectors=S)
    sphere_frame = features.gather_top(general_cloud, sel.sphere_submap, flat, cfg.frame_sphere_cap, sectors=S)
    sphere_scan = features.gather_top(general_cloud, sel.sphere_scan, flat, od.scan_sphere_cap, sectors=S)
    planar_scan = features.gather_top(general_cloud, sel.planar_scan, flat, od.scan_planar_cap, sectors=S)

    ground_ds = Cloud(*voxel.voxel_downsample(
        seg.ground.xyz, seg.ground.intensity, seg.ground.valid, od.ground_down_sample, od.scan_ground_cap
    ))
    edge_ds = Cloud(*voxel.voxel_downsample(
        edge_cloud.xyz, edge_cloud.intensity, edge_cloud.valid, od.edge_down_sample, od.scan_edge_cap
    ))
    return ScanFeatures(
        scan=FeatureSet(edge=edge_ds, sphere=sphere_scan, planar=planar_scan, ground=ground_ds),
        planar_frame=planar_frame,
        sphere_frame=sphere_frame,
        edge_raw=edge_cloud,
        ground_ds=ground_ds,
        edge_ds=edge_ds,
        num_clusters=clusters.num_clusters,
        box_min=clusters.box_min,
        box_max=clusters.box_max,
        box_valid=clusters.box_valid,
    )


# ---------------------------------------------------------------------------
# Submap management (updateSubmap, front_end.cpp:201-275)
# ---------------------------------------------------------------------------


def empty_submap(cfg: PipelineConfig, device=None, dtype=torch.float32) -> SubmapState:
    od = cfg.odometry
    dev = torch.device(device)
    Wp, Ws = od.planar_frame_size, od.sphere_frame_size
    eye = torch.eye(4, dtype=dtype, device=dev)
    return SubmapState(
        planar_frames=Cloud.empty(cfg.frame_planar_cap, dtype, batch=(Wp,), device=dev),
        sphere_frames=Cloud.empty(cfg.frame_sphere_cap, dtype, batch=(Ws,), device=dev),
        frame_poses=eye.expand(Wp, 4, 4).clone(),
        sphere_poses=eye.expand(Ws, 4, 4).clone(),
        frames_filled=torch.zeros((), dtype=torch.int32, device=dev),
        edge_map=Cloud.empty(od.submap_edge_cap, dtype, device=dev),
        ground_map=Cloud.empty(od.submap_ground_cap, dtype, device=dev),
    )


def _flatten_window(frames: Cloud, poses: torch.Tensor) -> Cloud:
    """Each window frame into the map frame, flattened (W,cap) -> (W*cap,)."""
    world = frames.transform(poses)
    return Cloud(world.xyz.reshape(-1, 3), world.intensity.reshape(-1), world.valid.reshape(-1))


def submap_features(state: SubmapState, cfg: PipelineConfig) -> FeatureSet:
    planar = _flatten_window(state.planar_frames, state.frame_poses)
    sphere = _flatten_window(state.sphere_frames, state.sphere_poses)
    return FeatureSet(edge=state.edge_map, sphere=sphere, planar=planar, ground=state.ground_map)


def _push(buf: torch.Tensor, new: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """Functional ring-buffer write buf[at] = new with a device index."""
    return buf.index_copy(0, at.reshape(1).long(), new[None].to(buf.dtype))


def _push_cloud(frames: Cloud, new: Cloud, at: torch.Tensor) -> Cloud:
    return Cloud(_push(frames.xyz, new.xyz, at), _push(frames.intensity, new.intensity, at),
                 _push(frames.valid, new.valid, at))


def update_submap_window_only(state: SubmapState, feats: ScanFeatures, pose: torch.Tensor,
                              cfg: PipelineConfig) -> SubmapState:
    od = cfg.odometry
    slot = state.frames_filled % od.planar_frame_size
    slot_s = state.frames_filled % od.sphere_frame_size
    return state._replace(
        planar_frames=_push_cloud(state.planar_frames, feats.planar_frame, slot),
        sphere_frames=_push_cloud(state.sphere_frames, feats.sphere_frame, slot_s),
        frame_poses=_push(state.frame_poses, pose, slot),
        sphere_poses=_push(state.sphere_poses, pose, slot_s),
        frames_filled=state.frames_filled + 1,
    )


def update_submap(state: SubmapState, feats: ScanFeatures, pose: torch.Tensor, cfg: PipelineConfig) -> SubmapState:
    """Push the window frames, then accumulate -> crop +-L -> downsample the
    edge and ground maps (front_end.cpp:201-275)."""
    od = cfg.odometry
    state = update_submap_window_only(state, feats, pose, cfg)
    pos = pose[:3, 3]

    def accumulate(map_cloud: Cloud, add: Cloud, crop_l: float, vs: float, cap: int) -> Cloud:
        merged = map_cloud.concat(add.transform(pose))
        merged = merged.crop_aabb(pos - crop_l, pos + crop_l)
        return Cloud(*voxel.voxel_downsample(merged.xyz, merged.intensity, merged.valid, vs, cap))

    return state._replace(
        edge_map=accumulate(state.edge_map, feats.edge_ds, od.edge_crop_box_length,
                            od.edge_down_sample_submap, od.submap_edge_cap),
        ground_map=accumulate(state.ground_map, feats.ground_ds, od.ground_crop_box_length,
                              od.ground_down_sample_submap, od.submap_ground_cap),
    )


def seed_submap(state: SubmapState, feats: ScanFeatures, cfg: PipelineConfig) -> SubmapState:
    """First-frame initialisation (front_end.cpp:285-305): raw edge cloud,
    0.3-voxel ground, submap-class planar/sphere at the identity pose."""
    od = cfg.odometry
    e = feats.edge_raw
    edge_map = Cloud(*voxel.voxel_downsample(e.xyz, e.intensity, e.valid, 1e-4, od.submap_edge_cap))
    g = feats.ground_ds
    ground_map = Cloud(*voxel.voxel_downsample(g.xyz, g.intensity, g.valid, od.ground_down_sample,
                                               od.submap_ground_cap))
    eye = torch.eye(4, dtype=g.xyz.dtype, device=g.device)
    state = update_submap_window_only(state, feats, eye, cfg)
    return state._replace(edge_map=edge_map, ground_map=ground_map)


# ---------------------------------------------------------------------------
# The per-frame odometry step (updateLidarOdometry, front_end.cpp:278-337)
# ---------------------------------------------------------------------------


def init_state(cfg: PipelineConfig, device=None, dtype=torch.float32) -> OdometryState:
    """Empty state on `device` (``cuda`` unless the caller asks for another;
    raises when no GPU is present and no device was named)."""
    dev = torch.device(device)
    eye = torch.eye(4, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return OdometryState(
        submap=empty_submap(cfg, dev, dtype),
        pose=eye.clone(),
        last_pose=eye.clone(),
        predict=eye.clone(),
        frame_idx=0,
        unhealthy_streak=zero.clone(),
        imp_streak=zero.clone(),
    )


def _where_cloud(c: torch.Tensor, new: Cloud, old: Cloud) -> Cloud:
    return Cloud(*(None if n is None and o is None else torch.where(c, n, o)
                   for n, o in zip(new.channels(), old.channels())))


def _where_submap(c: torch.Tensor, new: SubmapState, old: SubmapState) -> SubmapState:
    out = []
    for n, o in zip(new, old):
        out.append(_where_cloud(c, n, o) if isinstance(n, Cloud) else torch.where(c, n, o))
    return SubmapState(*out)


def _first_frame(st: OdometryState, feats: ScanFeatures, raw: Cloud, cfg: PipelineConfig):
    dtype, dev = raw.xyz.dtype, raw.device
    mi = cfg.odometry.tls.max_iterations
    i0 = torch.zeros((), dtype=torch.int32, device=dev)
    f = torch.zeros((), dtype=torch.bool, device=dev)
    diag = Diagnostics(
        i0, torch.zeros((), dtype=dtype, device=dev), torch.zeros(4, dtype=dtype, device=dev),
        torch.zeros(4, dtype=torch.int32, device=dev), f,
        misaligned=f, never_aligned=f,
        corr_trace=torch.zeros((mi, 4), dtype=torch.int32, device=dev),
        cost_trace=torch.zeros(mi, dtype=dtype, device=dev),
        coarse_trace=torch.zeros(mi, dtype=torch.bool, device=dev),
        aligned_trace=torch.zeros(mi, dtype=torch.bool, device=dev),
    )
    submap = seed_submap(st.submap, feats, cfg)
    return st._replace(submap=submap, frame_idx=st.frame_idx + 1), st.pose, diag


def _normal_frame(st: OdometryState, feats: ScanFeatures, raw: Cloud, cfg: PipelineConfig):
    od = cfg.odometry
    submap = submap_features(st.submap, cfg)
    # fallback veto at frame 1 and after 3 consecutive fallbacks
    allow_fb = (st.frame_idx > 1) & (st.unhealthy_streak < 3)
    pose, diag = scan_matching(feats.scan, submap, st.predict, od.tls, allow_fallback=allow_fb)
    unhealthy = diag.degenerate | diag.misaligned
    # physical step clamp (OdometryConfig.max_step_accel)
    pred_speed = torch.linalg.norm((se3.inv(st.pose) @ st.predict)[:3, 3])
    step_t = torch.linalg.norm((se3.inv(st.last_pose) @ pose)[:3, 3])
    cap = pred_speed + od.max_step_accel * (1.0 + st.imp_streak.to(pred_speed.dtype))
    implausible = (step_t > cap) & (st.frame_idx > 1)
    pose = torch.where(implausible, st.predict.to(pose.dtype), pose)
    unhealthy = unhealthy | implausible
    imp_streak = torch.where(implausible, st.imp_streak + 1, 0).to(torch.int32)
    # constant-velocity prediction (front_end.cpp:329-332), rotation
    # decayed on unhealthy frames (OdometryConfig.fallback_rot_decay)
    xi_step = se3.log(se3.inv(st.last_pose) @ pose)
    rot_scale = torch.where(unhealthy, od.fallback_rot_decay, 1.0).to(xi_step.dtype)
    predict = pose @ se3.exp(torch.cat([xi_step[:3], xi_step[3:] * rot_scale]))
    new_submap = update_submap(st.submap, feats, pose, cfg)
    # submap health gate (OdometryConfig.submap_gate_streak)
    streak = torch.where(unhealthy, st.unhealthy_streak + 1, 0).to(torch.int32)
    push = (~unhealthy) | (streak >= od.submap_gate_streak)
    new_submap = _where_submap(push, new_submap, st.submap)
    return (
        OdometryState(
            submap=new_submap, pose=pose, last_pose=pose, predict=predict,
            frame_idx=st.frame_idx + 1, unhealthy_streak=streak, imp_streak=imp_streak,
        ),
        pose,
        diag,
    )


def odometry_step(state: OdometryState, raw: Cloud, cfg: PipelineConfig):
    """Process one scan on the state's device; returns (state', world_T_scan
    pose, diagnostics)."""
    feats = preprocess_frame(raw, cfg)
    if state.frame_idx == 0:
        state, pose, diag = _first_frame(state, feats, raw, cfg)
    else:
        state, pose, diag = _normal_frame(state, feats, raw, cfg)
    diag = diag._replace(
        box_min=feats.box_min, box_max=feats.box_max, box_valid=feats.box_valid,
        num_clusters=feats.num_clusters,
    )
    return state, pose, diag


def odometry_step_packed(state: OdometryState, q_scan, n_valid: int, cfg: PipelineConfig):
    """One step from a Cloud.pack_scan transfer: ONE (cap,4) int16 array
    (8 bytes a point) moved to the state's device and dequantized there."""
    q = torch.as_tensor(q_scan).to(state.pose.device, non_blocking=True)
    return odometry_step(state, Cloud.from_packed(q, int(n_valid)), cfg)
