"""The port's geometry, camera models and minimal solvers against the JAX
package, on the same noise-free numpy inputs.

Minimal solvers return several models whose order follows the polynomial
roots, so their outputs are compared as sets, each model up to scale and
sign (f32 solvers; the two packages' SVDs and root iterations round
differently; each tolerance is stated at its test and in PERF.md).
Elementwise functions are compared within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from colmap_tpu.estimators import essential_matrix as jem
from colmap_tpu.estimators import fundamental_matrix as jfm
from colmap_tpu.estimators import homography_matrix as jhm
from colmap_tpu.geometry import essential as jess
from colmap_tpu.geometry import homography as jhom
from colmap_tpu.geometry import rotation as jrot
from colmap_tpu.geometry import triangulation as jtri
from colmap_tpu.math import polynomial as jpoly
from colmap_tpu.sensor import models as jmodels
from colmap_tpu_torch.estimators import essential_matrix as tem
from colmap_tpu_torch.estimators import fundamental_matrix as tfm
from colmap_tpu_torch.estimators import homography_matrix as thm
from colmap_tpu_torch.geometry import essential as tess
from colmap_tpu_torch.geometry import homography as thom
from colmap_tpu_torch.geometry import rotation as trot
from colmap_tpu_torch.geometry import triangulation as ttri
from colmap_tpu_torch.math import polynomial as tpoly
from colmap_tpu_torch.sensor import models as tmodels

torch.set_num_threads(2)


def _rotation(rng):
    aa = 0.2 * rng.standard_normal(3)
    a = np.linalg.norm(aa)
    k = aa / a
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def _two_view(rng, n, planar=False):
    """Noise-free rays of n points seen from identity and (R, t), the
    setup of tests/test_estimators.py (unit baseline, depth 4-8)."""
    R = _rotation(rng)
    t = rng.standard_normal(3)
    t /= np.linalg.norm(t)
    X = rng.uniform(-2, 2, (n, 3))
    X[:, 2] = 6.0 + (0.3 * X[:, 0] if planar else X[:, 2])
    Y = X @ R.T + t
    r1 = (X[:, :2] / X[:, 2:]).astype(np.float32)
    r2 = (Y[:, :2] / Y[:, 2:]).astype(np.float32)
    return r1, r2, R, t


def _unit(M):
    M = np.asarray(M, np.float64)
    return M / np.linalg.norm(M)


def _assert_same_model_sets(jm_, jv, tm_, tv, res_fn, tol=1e-4):
    """Every accurate (small-residual) valid model of one side has a
    counterpart on the other side, up to scale and sign."""
    def accurate(models, valid):
        return [_unit(m) for m, v in zip(models, valid)
                if v and res_fn(m) < 1e-4]

    a = accurate(np.asarray(jm_), np.asarray(jv))
    b = accurate(tm_.numpy(), tv.numpy())
    assert a and b
    for xs, ys in ((a, b), (b, a)):
        for x in xs:
            d = min(min(np.abs(x - y).max(), np.abs(x + y).max())
                    for y in ys)
            assert d < tol, d


def _epi(p1, p2):
    def res(E):
        h1 = np.concatenate([p1, np.ones((len(p1), 1))], 1)
        h2 = np.concatenate([p2, np.ones((len(p2), 1))], 1)
        return np.abs(np.einsum("ni,ij,nj->n", h2, _unit(E), h1)).max()
    return res


def _dist_sign(x, y):
    x, y = _unit(x), _unit(y)
    return min(np.abs(x - y).max(), np.abs(x + y).max())


def test_essential_5pt_recovers_what_jax_recovers():
    """The 4-dim nullspace basis of the 5x9 system is LAPACK's choice, so
    the degree-10 polynomial (and its conditioning) differs between the
    packages; the solution sets agree only to each problem's conditioning.
    Held: over 12 problems the port recovers the true E (1e-3) at least as
    often as JAX, and where both do, their recovered models agree (1e-3)."""
    hits_j = hits_t = 0
    jsolve = jax.jit(jem.solve_5pt)
    for seed in range(12):
        rng = np.random.default_rng(seed)
        r1, r2, R, t = _two_view(rng, 5)
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                       [-t[1], t[0], 0]])
        gt = tx @ R
        jE, jv = jsolve(jnp.asarray(r1), jnp.asarray(r2))
        tE, tv = tem.solve_5pt(torch.as_tensor(r1), torch.as_tensor(r2))
        assert tE.shape == (10, 3, 3) and tv.shape == (10,)
        js = [e for e, v in zip(np.asarray(jE), np.asarray(jv)) if v]
        ts = [e for e, v in zip(tE.numpy(), tv.numpy()) if v]
        bj = min(js, key=lambda e: _dist_sign(e, gt)) if js else None
        bt = min(ts, key=lambda e: _dist_sign(e, gt)) if ts else None
        ok_j = bj is not None and _dist_sign(bj, gt) < 1e-3
        ok_t = bt is not None and _dist_sign(bt, gt) < 1e-3
        hits_j += ok_j
        hits_t += ok_t
        if ok_j and ok_t:
            assert _dist_sign(bj, bt) < 1e-3
    assert hits_t >= hits_j and hits_t >= 6, (hits_t, hits_j)


def test_essential_8pt_and_batched_solver():
    rng = np.random.default_rng(3)
    r1, r2, _, _ = _two_view(rng, 12)
    jE, _ = jax.jit(jem.solve_8pt)(jnp.asarray(r1), jnp.asarray(r2))
    tE, tok = tem.solve_8pt(torch.as_tensor(r1), torch.as_tensor(r2))
    assert bool(tok[0])
    a, b = _unit(jE[0]), _unit(tE[0].numpy())
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) < 1e-4
    # a batch of problems solves like each problem alone
    p1 = torch.as_tensor(np.stack([r1[:5], r1[5:10]]))
    p2 = torch.as_tensor(np.stack([r2[:5], r2[5:10]]))
    bE, bv = tem.solve_5pt(p1, p2)
    sE, sv = tem.solve_5pt(p1[1], p2[1])
    assert bE.shape == (2, 10, 3, 3)
    np.testing.assert_allclose(bE[1].numpy()[sv.numpy()],
                               sE.numpy()[sv.numpy()], atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_fundamental_7pt_and_8pt(seed):
    rng = np.random.default_rng(seed + 10)
    r1, r2, _, _ = _two_view(rng, 10)
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    p1 = (r1 * 300 + [160, 120]).astype(np.float32)
    p2 = (r2 * 300 + [160, 120]).astype(np.float32)
    del K
    jF, jv = jax.jit(jfm.solve_7pt)(jnp.asarray(p1[:7]), jnp.asarray(p2[:7]))
    tF, tv = tfm.solve_7pt(torch.as_tensor(p1[:7]), torch.as_tensor(p2[:7]))
    assert tF.shape == (3, 3, 3)

    def res(F):  # normalized algebraic residual on pixel coords
        h1 = np.concatenate([p1[:7], np.ones((7, 1))], 1) / 300.0
        h2 = np.concatenate([p2[:7], np.ones((7, 1))], 1) / 300.0
        return np.abs(np.einsum("ni,ij,nj->n", h2, _unit(F), h1)).max()

    _assert_same_model_sets(jF, jv, tF, tv, res, tol=1e-3)
    jF8, _ = jax.jit(jfm.solve_8pt)(jnp.asarray(p1), jnp.asarray(p2))
    tF8, _ = tfm.solve_8pt(torch.as_tensor(p1), torch.as_tensor(p2))
    a, b = _unit(jF8[0]), _unit(tF8[0].numpy())
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) < 1e-4
    # Sampson residuals elementwise
    np.testing.assert_allclose(
        tfm.sampson_residuals(tF8[0], (torch.as_tensor(p1),
                                       torch.as_tensor(p2))).numpy(),
        np.asarray(jfm.sampson_residuals(jF8[0], (jnp.asarray(p1),
                                                  jnp.asarray(p2)))),
        atol=1e-5)


def _transfer(H, p):
    h = np.concatenate([p, np.ones((len(p), 1))], 1) @ np.asarray(
        H, np.float64).T
    return h[:, :2] / h[:, 2:]


def test_homography_4pt_and_refit():
    """H entries in pixel units carry the f32 rounding of the DLT scaled by
    the Hartley normalization, so the models are compared through the
    points they map: within 1e-2 px."""
    rng = np.random.default_rng(4)
    H = np.array([[1.1, 0.05, 3.0], [-0.04, 0.95, -2.0], [1e-4, -2e-4, 1.0]])
    p1 = rng.uniform(0, 640, (30, 2)).astype(np.float32)
    p2 = _transfer(H, p1).astype(np.float32)
    jH, _ = jax.jit(jhm.solve_4pt)(jnp.asarray(p1[:4]), jnp.asarray(p2[:4]))
    tH, tok = thm.solve_4pt(torch.as_tensor(p1[:4]), torch.as_tensor(p2[:4]))
    assert bool(tok[0])
    assert np.abs(_transfer(tH[0], p1) - _transfer(jH[0], p1)).max() < 1e-2
    w = (rng.random(30) > 0.3).astype(np.float32)
    jR, _ = jax.jit(jhm.refit)(None, (jnp.asarray(p1), jnp.asarray(p2)),
                               jnp.asarray(w))
    tR, _ = thm.refit(None, (torch.as_tensor(p1), torch.as_tensor(p2)),
                      torch.as_tensor(w))
    assert np.abs(_transfer(tR, p1) - _transfer(jR, p1)).max() < 1e-2
    assert np.abs(_transfer(tR, p1) - p2).max() < 1e-2
    np.testing.assert_allclose(
        thm.residuals(tR, (torch.as_tensor(p1), torch.as_tensor(p2))).numpy(),
        np.asarray(jhm.residuals(jR, (jnp.asarray(p1), jnp.asarray(p2)))),
        atol=1e-3)


def test_pose_from_essential_and_triangulation():
    rng = np.random.default_rng(5)
    r1, r2, R, t = _two_view(rng, 40)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = (tx @ R).astype(np.float32)
    jpose, jcnt, jX = jess.pose_from_essential_matrix(
        jnp.asarray(E), jnp.asarray(r1), jnp.asarray(r2))
    tpose, tcnt, tX = tess.pose_from_essential_matrix(
        torch.as_tensor(E), torch.as_tensor(r1), torch.as_tensor(r2))
    assert int(jcnt) == int(tcnt) == 40
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), atol=1e-4)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=1e-4,
                               atol=1e-4)
    q = trot.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32))
    assert float(trot.quat_angle_deg(q, tpose[:4])) < 1e-2
    np.testing.assert_allclose(
        q.numpy(), np.asarray(jrot.rotmat_to_quat(jnp.asarray(R, jnp.float32))),
        atol=1e-6)
    # triangulation angle elementwise
    c1 = np.zeros(3, np.float32)
    c2 = np.array([0.3, 0.1, 0.0], np.float32)
    np.testing.assert_allclose(
        ttri.calculate_triangulation_angle(
            torch.as_tensor(c1), torch.as_tensor(c2), tX).numpy(),
        np.asarray(jtri.calculate_triangulation_angle(
            jnp.asarray(c1), jnp.asarray(c2), jX)), atol=1e-5)


def test_pose_from_homography():
    rng = np.random.default_rng(6)
    r1, r2, R, t = _two_view(rng, 40, planar=True)
    jH, _ = jhm.refit(None, (jnp.asarray(r1), jnp.asarray(r2)),
                      jnp.ones(40, jnp.float32))
    jpose, jcnt, _ = jhom.pose_from_homography(jH, jnp.asarray(r1),
                                               jnp.asarray(r2))
    tpose, tcnt, _ = thom.pose_from_homography(
        torch.as_tensor(np.asarray(jH)), torch.as_tensor(r1),
        torch.as_tensor(r2))
    assert int(tcnt) == int(jcnt)
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), atol=1e-3)


@pytest.mark.parametrize("name,params", [
    ("SIMPLE_PINHOLE", [300.0, 160.0, 120.0]),
    ("PINHOLE", [300.0, 310.0, 160.0, 120.0]),
    ("SIMPLE_RADIAL", [300.0, 160.0, 120.0, 0.05]),
    ("RADIAL", [300.0, 160.0, 120.0, 0.05, -0.02]),
    ("OPENCV", [300.0, 310.0, 160.0, 120.0, 0.05, -0.02, 0.001, -0.002]),
])
def test_camera_models(name, params):
    mid = int(tmodels.MODEL_IDS_BY_NAME[name])
    assert mid == int(jmodels.MODEL_IDS_BY_NAME[name])
    p = tmodels.pad_params(params)
    np.testing.assert_array_equal(p, np.asarray(jmodels.pad_params(params)))
    rng = np.random.default_rng(7)
    uv = rng.uniform(-0.5, 0.5, (64, 2)).astype(np.float32)
    t_xy = tmodels.img_from_cam(mid, torch.as_tensor(p), torch.as_tensor(uv))
    j_xy = jmodels.img_from_cam(mid, jnp.asarray(p), jnp.asarray(uv))
    np.testing.assert_allclose(t_xy.numpy(), np.asarray(j_xy), atol=1e-4)
    t_uv = tmodels.cam_from_img(mid, torch.as_tensor(p), t_xy)
    j_uv = jmodels.cam_from_img(mid, jnp.asarray(p), j_xy)
    np.testing.assert_allclose(t_uv.numpy(), np.asarray(j_uv), atol=1e-5)
    np.testing.assert_allclose(t_uv.numpy(), uv, atol=1e-5)


def test_unported_camera_model_raises():
    p = torch.zeros(12)
    with pytest.raises(NotImplementedError):
        tmodels.cam_from_img(int(tmodels.CameraModelId.FOV), p,
                             torch.zeros(3, 2))


def test_polynomial_roots():
    rng = np.random.default_rng(8)
    roots = rng.uniform(-3, 3, (4, 5)).astype(np.float32)
    coeffs = np.stack([np.poly(r) for r in roots]).astype(np.float32)
    tz = tpoly.find_roots_durand_kerner(torch.as_tensor(coeffs)).numpy()
    jz = np.asarray(jpoly.find_roots_durand_kerner(jnp.asarray(coeffs)))
    for a, b, r in zip(tz, jz, roots):
        assert np.allclose(np.sort(a.real), np.sort(b.real), atol=1e-3)
        assert np.allclose(np.sort(a.real), np.sort(r), atol=1e-2)
    c = rng.normal(size=(4, 4)).astype(np.float32)
    tr, tv = tpoly.cubic_real_roots(*torch.as_tensor(c.T))
    jr, jv = jpoly.cubic_real_roots(*jnp.asarray(c.T))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tr.numpy()[tv.numpy()],
                               np.asarray(jr)[np.asarray(jv)], atol=1e-4)
