"""The TLS-GNC solve with GICP's covariance-weighted surface factor.

A frozen copy of the GICP path of ``tloam_torch/models/registration.py``
(the JAX package's, which follows upstream's LocalRegistration,
zhoupengwei/tloam ``src/lidar_odometry/registration.cpp:182-1133``) over
the frozen reference's unchanged helpers (``lidar_bench/reference/
registration.py``: cell tables, caps, the kNN edge and sphere families,
the yaw fan). A configuration that does not set
``plane_residual="gicp"`` is solved by the frozen reference's
``scan_matching``.

What GICP changes, against upstream:

- covariances (``calculateCov``, :385-415): kNN(k_corr + 1) without the
  self slot, eigenvalues over the largest, clamped at 1e-3. Departures: the
  neighbours come from a 1 m hash window with ``max_per_cell`` candidates a
  cell, where upstream's KD-tree always finds k; a point with fewer than 3
  falls back to the identity; and the middle eigenvalue is floored at 0.1
  (upstream clamps all three at 1e-3, :404-409), so that a point keeps one
  sharp direction: far ground rings with two would pin the along-track
  direction;
- matches (``addSurfCostFactor2`` :649-702, ``addGroundCostFactor2``
  :792-845): the 1-NN within ``gicp_dist_thres`` with no plane gate, for
  the planar and the ground family (upstream's radius is
  ``planar_dist_thres``); edges always take the kNN line fits;
- the family (``PlaneToPlaneErr``, :119-160; ``residuals.plane_to_plane``),
  its Cauchy loss on the covariance-normalized scale ``gicp_noise_bound``;
- GNC's bound is ``gicp_noise_bound`` (upstream: the metric
  ``noise_bound``), and a round is aligned when the mean matched distance
  at its input pose is at most ``gicp_align_dist`` (upstream has no gate).
  The gates that need the planar cost's metric meaning (best round, stall
  exit, starved revert, misaligned fallback) are off;
- a coarse round matches the planar family as its projection onto the
  coarse cell plane, with the identity covariance.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lidar_bench.reference import eig3, se3, voxel
from lidar_bench.reference import registration as frozen
from lidar_bench.reference.cloud import Cloud, map_tensors
from lidar_bench.reference.registration import (  # noqa: F401  (Diagnostics, FeatureSet: re-exported)
    Diagnostics, FeatureSet, _build_surf_cells, _cap_first_n, _cells_cap, _edge_correspondences, _keep,
    _plane_correspondences_cell, _sphere_correspondences, _State, _Weights, _where, _yaw_fan,
)

from . import covariance, residuals as res
from .config import TLSConfig


class _Corr(NamedTuple):
    """Per-family correspondence buffers: the planar and ground TARGET
    points with their covariances, and the scan's own covariances."""

    plane_t: torch.Tensor
    plane_valid: torch.Tensor
    ground_t: torch.Tensor
    ground_valid: torch.Tensor
    edge_a: torch.Tensor
    edge_b: torch.Tensor
    edge_valid: torch.Tensor
    sphere_t: torch.Tensor
    sphere_valid: torch.Tensor
    plane_tgt_cov: torch.Tensor
    ground_tgt_cov: torch.Tensor
    plane_src_cov: torch.Tensor
    ground_src_cov: torch.Tensor


def calculate_covariances(cloud: Cloud, k_corr: int, radius: float = 1.0, max_per_cell: int = 8) -> torch.Tensor:
    """Each point's regularized neighbourhood covariance ([F,] Q, 3, 3)."""
    grid = voxel.build_hash_grid(cloud.xyz, cloud.valid, radius)
    idx, _, ok = voxel.query_knn(grid, cloud.xyz, cloud.valid, k=k_corr + 1, radius=radius, max_per_cell=max_per_cell)
    idx, ok = idx[..., 1:], ok[..., 1:]  # drop the self slot (nearest, distance 0)
    a00, a01, a02, a11, a12, a22 = covariance.neighbour_covariance(cloud.xyz, idx, ok)
    cov = torch.stack(
        [torch.stack([a00, a01, a02], -1), torch.stack([a01, a11, a12], -1), torch.stack([a02, a12, a22], -1)],
        dim=-2,
    )
    w, V = eig3.eigh3(cov)
    w_reg = torch.clamp(w / torch.clamp(w[..., 2:3], min=1e-12), min=1e-3)
    w_reg = torch.cat([w_reg[..., :1], torch.clamp(w_reg[..., 1:2], min=0.1), w_reg[..., 2:]], dim=-1)
    out = (V * w_reg[..., None, :]) @ V.transpose(-1, -2)
    degenerate = (torch.sum(ok, dim=-1) < 3) | (w[..., 2] < 1e-9)
    eye = torch.eye(3, dtype=out.dtype, device=out.device)
    return torch.where(degenerate[..., None, None], eye, out)


def _gicp_correspondences(grid: voxel.HashGrid, submap: Cloud, submap_covs, scan_w, scan_valid,
                          dist_thres: float, maxnum: int, max_per_cell: int):
    """The 1-NN within the threshold: its point, its covariance, valid."""
    idx, _, ok = voxel.query_knn(grid, scan_w, scan_valid, k=1, radius=dist_thres, max_per_cell=max_per_cell)
    nn = idx[..., 0]
    frames = submap.xyz.ndim == 3
    return (voxel.take(submap.xyz, nn, frames), voxel.take(submap_covs, nn, frames),
            _cap_first_n(scan_valid & ok[..., 0], maxnum))


def _build_correspondences(xi, scan: FeatureSet, submap: FeatureSet, grids: dict, covs: dict, cfg: TLSConfig,
                           use_coarse) -> _Corr:
    """All four families at pose xi ([B,] 6). `use_coarse` is a host bool
    for every frame, or a ([B],) bool tensor: then the planar family is
    matched both ways and each frame takes its own."""
    mixed = isinstance(use_coarse, torch.Tensor)
    coarse = mixed or bool(use_coarse)
    T = se3.exp(xi)
    planar_w = se3.transform(T, scan.planar.xyz)
    ground_w = se3.transform(T, scan.ground.xyz)
    edge_w = se3.transform(T, scan.edge.xyz)
    pt, p_cov, pv = _gicp_correspondences(grids["planar"], submap.planar, covs["submap_planar"], planar_w,
                                          scan.planar.valid, cfg.gicp_dist_thres, cfg.planar_maxnum,
                                          cfg.max_per_cell)
    if coarse:
        cn, cd, cv = _plane_correspondences_cell(grids["planar_coarse"], planar_w, scan.planar.valid,
                                                 cfg.planar_maxnum, 1.5)
        cp = planar_w - cn * (torch.sum(planar_w * cn, dim=-1) + cd)[..., None]
        c_cov = torch.eye(3, dtype=pt.dtype, device=pt.device).expand_as(p_cov)
        if mixed:
            pt, p_cov, pv = _where(use_coarse, cp, pt), _where(use_coarse, c_cov, p_cov), _where(use_coarse, cv, pv)
        else:
            pt, p_cov, pv = cp, c_cov, cv
    gt, g_cov, gv = _gicp_correspondences(grids["ground"], submap.ground, covs["submap_ground"], ground_w,
                                          scan.ground.valid, cfg.gicp_dist_thres, cfg.ground_maxnum,
                                          cfg.max_per_cell)
    ea, eb, ev = _edge_correspondences(grids["edge"], submap.edge, edge_w, scan.edge.valid, cfg)
    st, sv = _sphere_correspondences(grids["sphere"], submap.sphere, se3.transform(T, scan.sphere.xyz),
                                     scan.sphere.valid, cfg)
    return _Corr(pt, pv, gt, gv, ea, eb, ev, st, sv, p_cov, g_cov, covs["scan_planar"], covs["scan_ground"])


def _evaluate(xi, scan: FeatureSet, corr: _Corr, w: _Weights, gicp_scale: float):
    """(H ([B,] 6, 6), g ([B,] 6), per-point GNC costs, zero where not
    valid) of every family at pose xi ([B,] 6)."""
    T = se3.exp(xi)
    dtype = xi.dtype

    def vec_family(r, J, cost, valid, scale=1.0):
        m = valid.to(dtype)
        irls = res.cauchy_weight(torch.sum(r * r, dim=-1), scale) * m
        lead = J.shape[:-3]
        Jf = J.reshape(lead + (-1, 6))
        Jw = (J * irls[..., None, None]).reshape(lead + (-1, 6))
        Jwt = Jw.transpose(-1, -2)
        return Jf.transpose(-1, -2) @ Jw, (Jwt @ r.reshape(lead + (-1, 1)))[..., 0], cost * m

    def gicp_family(cloud, tgt, src_cov, tgt_cov, valid, weights):
        r, J, cost = res.plane_to_plane(T, cloud.xyz, src_cov, tgt, tgt_cov, weights)
        return vec_family(r, J, cost, valid, gicp_scale)

    Hp, gp, cost_p = gicp_family(scan.planar, corr.plane_t, corr.plane_src_cov, corr.plane_tgt_cov,
                                 corr.plane_valid, w.planar)
    Hg, gg, cost_g = gicp_family(scan.ground, corr.ground_t, corr.ground_src_cov, corr.ground_tgt_cov,
                                 corr.ground_valid, w.ground)
    He, ge, cost_e = vec_family(*res.point_to_line(T, scan.edge.xyz, corr.edge_a, corr.edge_b, w.edge),
                                corr.edge_valid)
    Hs, gs, cost_s = vec_family(*res.point_to_point(T, scan.sphere.xyz, corr.sphere_t, w.sphere),
                                corr.sphere_valid)
    return Hp + Hg + He + Hs, gp + gg + ge + gs, _Weights(cost_p, cost_g, cost_e, cost_s)


def _gn_inner(xi, scan: FeatureSet, corr: _Corr, w: _Weights, cfg: TLSConfig, hard_floor_on, w_scale):
    """Damped, degeneracy-aware Gauss-Newton on xi ([B,] 6): block
    normalized 6x6 eigen solve, degenerate directions zeroed, step clamped
    to the trust region (as the frozen reference's, over this module's
    families)."""
    dtype = xi.dtype
    eye6 = torch.eye(6, dtype=dtype, device=xi.device)
    for _ in range(cfg.inner_iterations):
        H, g, _ = _evaluate(xi, scan, corr, w, cfg.gicp_noise_bound)
        dH = torch.diagonal(H, dim1=-2, dim2=-1)
        s_t = 1.0 / torch.sqrt(torch.clamp(torch.mean(dH[..., :3], dim=-1), min=1e-12))
        s_r = 1.0 / torch.sqrt(torch.clamp(torch.mean(dH[..., 3:], dim=-1), min=1e-12))
        S = torch.stack([s_t, s_t, s_t, s_r, s_r, s_r], dim=-1)
        Hn = H * S[..., :, None] * S[..., None, :]
        # a non-finite system yields a zero step; LAPACK must not see the NaNs
        finite = torch.isfinite(Hn).all(dim=-1).all(dim=-1) & torch.isfinite(g).all(dim=-1)
        lam, V = torch.linalg.eigh(_where(finite, Hn, eye6.expand_as(Hn)))
        lam_max = torch.clamp(lam[..., -1:], min=1e-12)
        u_sq = torch.sum((S[..., :, None] * V) ** 2, dim=-2)
        lam_raw = lam / torch.clamp(u_sq, min=1e-30) / torch.clamp(w_scale, min=1e-12)[..., None]
        degen = ((lam < cfg.degen_rel_thres * lam_max) & (lam_raw < cfg.degen_abs_thres)) | (
            hard_floor_on[..., None] & (lam_raw < cfg.degen_abs_hard)
        )
        inv = torch.where(degen, 0.0, 1.0 / (lam + cfg.lm_lambda))
        delta = -S * ((V * inv[..., None, :]) @ (V.transpose(-1, -2) @ (S * g)[..., None]))[..., 0]
        tn = torch.linalg.norm(delta[..., :3], dim=-1)
        rn = torch.linalg.norm(delta[..., 3:], dim=-1)
        scale = torch.clamp(
            torch.minimum(
                cfg.max_step_trans / torch.clamp(tn, min=1e-12),
                cfg.max_step_rot / torch.clamp(rn, min=1e-12),
            ),
            max=1.0,
        )
        delta = delta * scale[..., None]
        delta = _where(finite & torch.isfinite(delta).all(dim=-1), delta, torch.zeros_like(delta))
        xi = se3.boxplus_left(xi, delta)
    return xi


def scan_matching(scan: FeatureSet, submap: FeatureSet, predict_pose: torch.Tensor, cfg: TLSConfig,
                  allow_fallback=True):
    """Register one frame's features against the submap: (pose (4,4),
    Diagnostics), or B frames with a leading B on every input."""
    if cfg.plane_residual != "gicp":
        return frozen.scan_matching(scan, submap, predict_pose, cfg, allow_fallback)
    if predict_pose.ndim == 2:
        one = lambda x: x[None]  # noqa: E731
        pose, diag = scan_matching(map_tensors(scan, one), map_tensors(submap, one), predict_pose[None], cfg,
                                   allow_fallback)
        return pose[0], map_tensors(diag, lambda x: x[0])
    return _solve(scan, submap, predict_pose, cfg)


def _solve(scan: FeatureSet, submap: FeatureSet, predict_pose: torch.Tensor, cfg: TLSConfig):
    B = predict_pose.shape[0]
    dtype = scan.planar.xyz.dtype
    dev = scan.planar.xyz.device
    # device scalars by a fill: torch.tensor(v, device=cuda) copies from the host and syncs
    f32 = lambda v: torch.full((), v, dtype=dtype, device=dev)  # noqa: E731
    per_frame = lambda v, dt=dtype: torch.full((B,), v, dtype=dt, device=dev)  # noqa: E731
    xi0 = se3.log(predict_pose.to(dtype))
    # tiny-rotation degeneracy guard (registration.cpp:884-886), fixed axis
    tiny = torch.ones(3, dtype=dtype, device=dev) / math.sqrt(3.0) * 1e-4
    omega_small = torch.linalg.norm(xi0[:, 3:], dim=-1) < 1e-2
    xi0 = _where(omega_small, torch.cat([xi0[:, :3], tiny.expand(B, 3)], dim=-1), xi0)

    has_coarse = bool(cfg.coarse_scale)
    noise_bound_sq = cfg.gicp_noise_bound**2
    if noise_bound_sq < 1e-16:
        noise_bound_sq = 1e-2  # registration.cpp:962-964
    grid = lambda c, pitch: voxel.build_hash_grid(c.xyz, c.valid, pitch)  # noqa: E731
    grids = {
        "edge": grid(submap.edge, cfg.edge_dist_thres),
        "sphere": grid(submap.sphere, cfg.sphere_dist_thres),
        "planar": grid(submap.planar, cfg.gicp_dist_thres),
        "ground": grid(submap.ground, cfg.gicp_dist_thres),
    }
    covs = {
        name: calculate_covariances(c, cfg.k_corr, max_per_cell=cfg.max_per_cell)
        for name, c in (("scan_planar", scan.planar), ("scan_ground", scan.ground),
                        ("submap_planar", submap.planar), ("submap_ground", submap.ground))
    }

    ones = lambda c: torch.ones(c.valid.shape, dtype=dtype, device=dev)  # noqa: E731
    n_planar_cand = torch.clamp(torch.sum(scan.planar.valid, dim=-1), max=cfg.planar_maxnum)

    mi = cfg.max_iterations
    false = per_frame(False, torch.bool)
    st = _State(
        xi=xi0, weights=_Weights(ones(scan.planar), ones(scan.ground), ones(scan.edge), ones(scan.sphere)),
        mu=per_frame(1.0), mu_inited=false, want_coarse=false, prev_planar_cost=per_frame(math.inf),
        cost_sums=torch.zeros((B, 4), dtype=dtype, device=dev),
        num_corr=torch.full((B, 4), 1 << 20, dtype=torch.int32, device=dev), done=false,
        prev_mean_planar=per_frame(math.inf), xi_best=xi0, best_score=per_frame(math.inf), best_seen=false,
        best_it=per_frame(0, torch.int32),
    )
    iterations = per_frame(0, torch.int32)
    corr_trace = torch.zeros((mi, B, 4), dtype=torch.int32, device=dev)
    cost_trace = torch.zeros((mi, B), dtype=dtype, device=dev)
    coarse_trace = torch.zeros((mi, B), dtype=torch.bool, device=dev)
    aligned_trace = torch.zeros((mi, B), dtype=torch.bool, device=dev)

    for it in range(mi):
        # one host read a round for the whole batch: the frames' done and
        # want_coarse flags
        done_h, coarse_h = torch.stack([st.done, st.want_coarse]).tolist()
        live = [not d for d in done_h]
        if not any(live):
            break
        n_coarse = sum(has_coarse and c and a for c, a in zip(coarse_h, live))
        active = ~st.done
        uc = st.want_coarse if has_coarse else false
        # a coarse round for every live frame, for none, or per frame
        use_coarse = n_coarse > 0 if n_coarse in (0, sum(live)) else uc
        if n_coarse and "planar_coarse" not in grids:
            # lazy coarse grid: built on the first round any frame needs it
            grids["planar_coarse"] = _build_surf_cells(
                submap.planar, cfg.planar_dist_thres * cfg.coarse_scale, _cells_cap(submap.planar, 2),
                precise_thres=0.2 * cfg.coarse_scale,
            )
        xi_in = st.xi
        if n_coarse and cfg.yaw_fan_half > 0:
            xi_in = _where(uc, _yaw_fan(st.xi, scan, grids["planar_coarse"], cfg), st.xi)
        corr = _build_correspondences(xi_in, scan, submap, grids, covs, cfg, use_coarse)
        w = st.weights

        w_mass = (
            torch.sum(torch.square(w.planar) * corr.plane_valid, dim=-1)
            + torch.sum(torch.square(w.ground) * corr.ground_valid, dim=-1)
            + torch.sum(torch.square(w.edge) * corr.edge_valid, dim=-1)
            + torch.sum(torch.square(w.sphere) * corr.sphere_valid, dim=-1)
        )
        n_valid = (
            torch.sum(corr.plane_valid, dim=-1) + torch.sum(corr.ground_valid, dim=-1)
            + torch.sum(corr.edge_valid, dim=-1) + torch.sum(corr.sphere_valid, dim=-1)
        )
        w_scale = w_mass / torch.clamp(n_valid, min=1)
        planar_empty = torch.sum(corr.plane_valid, dim=-1) == 0
        xi_new = _gn_inner(xi_in, scan, corr, w, cfg, planar_empty, w_scale)

        _, _, costs = _evaluate(xi_new, scan, corr, w, cfg.gicp_noise_bound)
        planar_cost = torch.sum(costs.planar, dim=-1)
        ncorr = torch.stack(
            [torch.sum(corr.plane_valid, dim=-1), torch.sum(corr.ground_valid, dim=-1),
             torch.sum(corr.edge_valid, dim=-1), torch.sum(corr.sphere_valid, dim=-1)], dim=-1
        ).to(torch.int32)
        n_planar = ncorr[:, 0]
        mean_planar = planar_cost / torch.clamp(n_planar, min=1)

        # monotonicity guard on weighted rounds
        prev_mu_inited = st.mu_inited
        revert = (
            prev_mu_inited & ~uc
            & (mean_planar > torch.clamp(4.0 * st.prev_mean_planar, min=cfg.coarse_cost_thres))
            & (n_planar > 0)
        )
        # the alignment gate: the mean matched distance at the round's INPUT pose
        pw_in = se3.transform(se3.exp(xi_in), scan.planar.xyz)
        nn_d = torch.linalg.norm(pw_in - corr.plane_t, dim=-1)
        mean_nn = torch.sum(torch.where(corr.plane_valid, nn_d, 0.0), dim=-1) / torch.clamp(n_planar, min=1)
        aligned = (n_planar > 0) & (mean_nn <= cfg.gicp_align_dist) & ~uc & ~revert
        # mu seeded on the first aligned round, from its residuals
        first_fine = ~st.mu_inited & aligned
        max_r = torch.maximum(
            torch.amax(costs.planar, dim=-1),
            torch.maximum(torch.amax(costs.edge, dim=-1), torch.amax(costs.sphere, dim=-1)),
        )
        mu = torch.where(first_fine, res.gnc_init_mu(max_r, noise_bound_sq, inlier_mu=1e6), st.mu)
        mu_inited = st.mu_inited | first_fine

        th1, th2 = res.gnc_thresholds(mu[:, None], noise_bound_sq)
        new_w = _Weights(*(
            res.gnc_update_weights(old, c, noise_bound_sq, th1, th2, mu[:, None])
            for old, c in zip(w, costs)
        ))
        do_update = mu_inited & ~uc
        new_w = _Weights(*(_where(do_update, n, o) for o, n in zip(w, new_w)))
        new_w = _Weights(*(_where(revert, torch.ones_like(v), v) for v in new_w))
        mu = torch.where(do_update, res.gnc_next_mu(mu, f32(float(it)), cfg.gnc_factor), mu)
        planar_cost_out = torch.where(uc, f32(math.inf), planar_cost)
        if has_coarse:
            # a fine round matching under relocal_frac of its candidates is lost too
            lost = ~aligned | (n_planar < cfg.relocal_corr_thres) | (n_planar < cfg.relocal_frac * n_planar_cand)
            want_coarse = lost & ~uc & ~revert
        else:
            want_coarse = st.want_coarse
        cost_sums = torch.stack(
            [planar_cost, torch.sum(costs.ground, dim=-1), torch.sum(costs.edge, dim=-1),
             torch.sum(costs.sphere, dim=-1)], dim=-1
        )
        # planar-only convergence gate (registration.cpp:1108-1111) + fail-safes
        done = (
            (torch.abs(planar_cost - st.prev_planar_cost) < cfg.cost_threshold)
            & (n_planar > 0) & ~uc & ~want_coarse & ~revert
        )
        if cfg.exit_cost_thres and it >= 2:
            # gated on mu seeded on a PREVIOUS round: the seeding round
            # solved unweighted
            done = done | (aligned & prev_mu_inited & (mean_planar < cfg.exit_cost_thres))
        xi_new = _where(revert, st.xi, xi_new)
        prev_mean = torch.where(uc | revert, st.prev_mean_planar, mean_planar)
        # a frame that was done before this round keeps everything
        st = _keep(active, _State(xi_new, new_w, mu, mu_inited, want_coarse, planar_cost_out, cost_sums, ncorr,
                                  done, prev_mean, st.xi_best, st.best_score, st.best_seen, st.best_it), st)
        corr_trace[it] = ncorr * active[:, None]
        cost_trace[it] = torch.where(active, mean_planar, 0.0)
        coarse_trace[it] = uc & active
        aligned_trace[it] = aligned & active
        iterations = iterations + active.to(torch.int32)

    pose = se3.exp(st.xi)
    num_corr = st.num_corr
    degenerate = torch.sum(num_corr, dim=-1) < cfg.min_total_corr
    pose = _where(degenerate, predict_pose.to(dtype), pose)
    return pose, Diagnostics(
        iterations, st.mu, st.cost_sums, num_corr, degenerate, misaligned=false, never_aligned=false,
        corr_trace=corr_trace.movedim(0, 1), cost_trace=cost_trace.movedim(0, 1),
        coarse_trace=coarse_trace.movedim(0, 1), aligned_trace=aligned_trace.movedim(0, 1),
    )
