"""tloam_torch.ops (se3, eig3, residuals) and tloam_torch.cloud against the
JAX package, on float32 inputs made with numpy.

Tolerances: se3 1e-6 absolute (radian/metre scale inputs, float32);
eig3 and plane/line fits 1e-5 relative to the eigenvalue scale."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tloam_torch.cloud import Cloud as TCloud
from tloam_torch.ops import eig3 as teig, residuals as tres, se3 as tse3

from tloam_tpu.cloud import Cloud as JCloud
from tloam_tpu.ops import eig3 as jeig, residuals as jres, se3 as jse3

from tests.test_torch_common import f32, np_of, tt

ATOL_SE3 = 1e-6


def random_xi(rng, n, max_angle=0.95 * np.pi, scale_trans=3.0):
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    theta = rng.uniform(0.0, max_angle, size=(n, 1))
    if n >= 4:  # Taylor and near-pi branches
        theta[:4] = [[0.0], [1e-5], [1e-3], [np.pi - 5e-4]]
    return f32(np.concatenate([rng.normal(size=(n, 3)) * scale_trans, w * theta], axis=-1))


@pytest.mark.parametrize("fn", ["hat", "exp_so3", "left_jacobian_so3", "inv_left_jacobian_so3", "exp"])
def test_se3_forward_functions(rng, fn):
    xi = random_xi(rng, 64)
    arg = xi if fn == "exp" else xi[:, 3:]
    want = np.asarray(getattr(jse3, fn)(jnp.asarray(arg)))
    got = np_of(getattr(tse3, fn)(tt(arg)))
    np.testing.assert_allclose(got, want, atol=ATOL_SE3)


def test_se3_log_inv_transform_boxplus_adjoint(rng):
    xi = random_xi(rng, 64)
    T = f32(jse3.exp(jnp.asarray(xi)))
    np.testing.assert_allclose(np_of(tse3.log(tt(T))), np.asarray(jse3.log(jnp.asarray(T))), atol=2e-5)
    np.testing.assert_allclose(np_of(tse3.log_so3(tt(T[:, :3, :3]))),
                               np.asarray(jse3.log_so3(jnp.asarray(T[:, :3, :3]))), atol=2e-5)
    np.testing.assert_allclose(np_of(tse3.inv(tt(T))), np.asarray(jse3.inv(jnp.asarray(T))), atol=ATOL_SE3 * 10)
    np.testing.assert_allclose(np_of(tse3.vee(tse3.hat(tt(xi[:, :3])))), xi[:, :3])
    pts = f32(rng.normal(size=(100, 3)) * 20)
    np.testing.assert_allclose(np_of(tse3.transform(tt(T[0]), tt(pts))),
                               np.asarray(jse3.transform(jnp.asarray(T[0]), jnp.asarray(pts))), atol=1e-4)
    np.testing.assert_allclose(np_of(tse3.transform(tt(T[0]), tt(pts[0]))),
                               np.asarray(jse3.transform(jnp.asarray(T[0]), jnp.asarray(pts[0]))), atol=1e-4)
    d = random_xi(rng, 64, max_angle=0.1, scale_trans=0.1)
    small = random_xi(rng, 64, max_angle=1.0, scale_trans=1.0)
    np.testing.assert_allclose(np_of(tse3.boxplus_left(tt(small), tt(d))),
                               np.asarray(jse3.boxplus_left(jnp.asarray(small), jnp.asarray(d))), atol=1e-5)
    np.testing.assert_allclose(np_of(tse3.adjoint(tt(T))), np.asarray(jse3.adjoint(jnp.asarray(T))), atol=1e-5)


def _sym(rng, n, scale=1.0):
    A = rng.normal(size=(n, 3, 3)) * scale
    A = A @ np.swapaxes(A, -1, -2)
    A[:3] = np.diag([2.0, 2.0, 2.0]) * scale  # isotropic
    A[3] = np.diag([1.0, 1.0, 3.0]) * scale  # repeated eigenvalue
    return f32(A)


def test_eig3_values_vectors_and_fits(rng):
    A = _sym(rng, 200, scale=0.3)
    lam_j = np.asarray(jeig.eigvalsh3(jnp.asarray(A)))
    lam_t = np_of(teig.eigvalsh3(tt(A)))
    scale = np.abs(lam_j).max(axis=-1, keepdims=True)
    np.testing.assert_allclose(lam_t / scale, lam_j / scale, atol=1e-5)
    w_j, V_j = jeig.eigh3(jnp.asarray(A))
    w_t, V_t = teig.eigh3(tt(A))
    np.testing.assert_allclose(np_of(w_t) / scale, np.asarray(w_j) / scale, atol=1e-5)
    # eigenvectors of well-separated eigenvalues agree up to sign
    gap = np.min(np.diff(np.asarray(w_j), axis=-1), axis=-1) / scale[:, 0]
    ok = gap > 1e-2
    dots = np.abs(np.sum(np_of(V_t) * np.asarray(V_j), axis=-2))[ok]
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)

    pts = f32(rng.normal(size=(300, 6, 3)) * [3.0, 2.0, 0.05])
    mask = rng.uniform(size=(300, 6)) > 0.2
    mask[:, :4] = True  # >= 4 points: a well-posed fit
    for fj, ft in ((jeig.plane_from_points, teig.plane_from_points), (jeig.line_from_points, teig.line_from_points)):
        outs_j = fj(jnp.asarray(pts), jnp.asarray(mask))
        outs_t = ft(tt(pts), tt(mask))
        for a, b in zip(outs_t, outs_j):
            a, b = np_of(a), np.asarray(b)
            if a.ndim == 2:  # direction vectors: sign-free comparison
                a, b = a * np.sign(np.sum(a * b, -1, keepdims=True)), b
            # 1e-5 relative to the coordinate scale (float32 covariance
            # rounding moves a normal by ~eps * lam_max / gap)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(pts).max())


def test_residual_families_match(rng):
    n = 256
    T = f32(jse3.exp(jnp.asarray(random_xi(rng, 1, max_angle=0.2)[0])))
    src = f32(rng.normal(size=(n, 3)) * 10)
    a, b = f32(rng.normal(size=(n, 3)) * 10), f32(rng.normal(size=(n, 3)) * 10)
    nrm = f32(rng.normal(size=(n, 3)))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    d = f32(rng.normal(size=n))
    w = f32(rng.uniform(0.2, 1.0, size=n))
    cases = [
        (jres.point_to_point, tres.point_to_point, (T, src, a, w)),
        (jres.point_to_line, tres.point_to_line, (T, src, a, b, w)),
        (jres.point_to_plane, tres.point_to_plane, (T, src, nrm, d, w)),
    ]
    for fj, ft, args in cases:
        for x, y in zip(ft(*map(tt, args)), fj(*map(jnp.asarray, args))):
            y = np.asarray(y)
            np.testing.assert_allclose(np_of(x), y, rtol=1e-5, atol=1e-5 * np.abs(y).max())


def test_gnc_schedule_matches(rng):
    costs = f32(np.concatenate([[0.0], rng.uniform(0, 2e-4, 300)]))
    old = f32(rng.uniform(size=301))
    for mu in (1e-3, 0.5, 20.0):
        th1, th2 = jres.gnc_thresholds(jnp.float32(mu), 1e-4)
        tth1, tth2 = tres.gnc_thresholds(torch.tensor(mu), 1e-4)
        np.testing.assert_allclose([float(tth1), float(tth2)], [float(th1), float(th2)], rtol=1e-6)
        wj = jres.gnc_update_weights(jnp.asarray(old), jnp.asarray(costs), 1e-4, th1, th2, jnp.float32(mu))
        wt = tres.gnc_update_weights(tt(old), tt(costs), 1e-4, tth1, tth2, torch.tensor(mu))
        np.testing.assert_allclose(np_of(wt), np.asarray(wj), rtol=1e-5, atol=1e-6)
    for r in (1e-6, 1e-3, 0.4):
        assert float(tres.gnc_init_mu(torch.tensor(r), 1e-4, 1e6)) == pytest.approx(
            float(jres.gnc_init_mu(jnp.float32(r), 1e-4, 1e6)), rel=1e-6)
    assert float(tres.gnc_next_mu(torch.tensor(3.0), torch.tensor(2.0), 11.8)) == pytest.approx(
        float(jres.gnc_next_mu(jnp.float32(3.0), jnp.float32(2.0), 11.8)), rel=1e-6)
    np.testing.assert_allclose(np_of(tres.cauchy_weight(tt(costs))), np.asarray(jres.cauchy_weight(jnp.asarray(costs))))


def test_cloud_ops_match(rng):
    xyz = f32(rng.normal(size=(300, 3)) * 8)
    inten = f32(rng.uniform(size=300))
    xyz[5] = np.nan
    cj = JCloud.from_numpy(xyz, inten, capacity=512, dtype=jnp.float32)
    ct = TCloud.from_numpy(xyz, inten, capacity=512, device="cpu")
    T = f32(jse3.exp(jnp.asarray(random_xi(rng, 1, max_angle=0.5)[0])))
    lo, hi = f32([-5, -5, -2]), f32([6, 4, 3])
    ops = [
        (lambda c: c.remove_nonfinite(), lambda c: c.remove_nonfinite()),
        (lambda c: c.remove_nonfinite().remove_close(3.0), lambda c: c.remove_nonfinite().remove_close(3.0)),
        (lambda c: c.transform(jnp.asarray(T)), lambda c: c.transform(tt(T))),
        (lambda c: c.crop_aabb(jnp.asarray(lo), jnp.asarray(hi)), lambda c: c.crop_aabb(tt(lo), tt(hi))),
        (lambda c: c.concat(c.mask(c.valid & False)), lambda c: c.concat(c.mask(c.valid & False))),
    ]
    for oj, ot in ops:
        a, b = ot(ct), oj(cj)
        assert np.array_equal(np_of(a.valid), np.asarray(b.valid))
        m = np.asarray(b.valid)
        np.testing.assert_allclose(np_of(a.xyz)[m], np.asarray(b.xyz)[m], atol=1e-5)
        np.testing.assert_allclose(np_of(a.intensity), np.asarray(b.intensity))
    assert int(ct.count()) == int(cj.count()) == 300
    e = TCloud.empty(7, batch=(2,), device="cpu")
    assert e.xyz.shape == (2, 7, 3) and not bool(e.valid.any())
