"""The port's estimator and geometry leftovers against the JAX package, on
the same numpy inputs: RANSAC's derived budget and inlier-count support,
multi-model two-view estimation, translation and 2D affine fits, quaternion
averaging, multi-view triangulation, E and H from a pose, the cheirality
test, the mixed-model camera dispatch, the timers and the visibility
pyramid.

Tolerances (PERF.md, "Parity tolerances"): integers and booleans exactly;
float32 results within 1e-5 (both packages solve the same small systems in
float32, in another order); the multi-model estimator draws from another
generator, so it is held by outcome: the same number of models, each
model's inlier mask agreeing with JAX's on >= 95% of the matches.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from colmap_tpu.estimators import similarity_transform as jst
from colmap_tpu.estimators import two_view_geometry as jtvg
from colmap_tpu.geometry import essential as jess
from colmap_tpu.geometry import homography as jhom
from colmap_tpu.geometry import rotation as jrot
from colmap_tpu.geometry import triangulation as jtri
from colmap_tpu.optim.ransac import RansacOptions as JRansacOptions
from colmap_tpu.optim.ransac import draw_minimal_samples as jdraw
from colmap_tpu.optim.ransac import ransac as jransac
from colmap_tpu.scene.visibility_pyramid import (
    VisibilityPyramid as JPyramid)
from colmap_tpu.sensor import models as jmodels
from colmap_tpu_torch.estimators import similarity_transform as tst
from colmap_tpu_torch.estimators import two_view_geometry as ttvg
from colmap_tpu_torch.geometry import essential as tess
from colmap_tpu_torch.geometry import homography as thom
from colmap_tpu_torch.geometry import rotation as trot
from colmap_tpu_torch.geometry import triangulation as ttri
from colmap_tpu_torch.optim.ransac import RansacOptions as TRansacOptions
from colmap_tpu_torch.optim.ransac import ransac_from_samples
from colmap_tpu_torch.scene.visibility_pyramid import (
    VisibilityPyramid as TPyramid)
from colmap_tpu_torch.sensor import models as tmodels
from colmap_tpu_torch.util.timer import StageTimings, Timer

torch.set_num_threads(2)


def T(a):
    return torch.as_tensor(np.array(a))


def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _poses(rng, n):
    """(n, 7) cam_from_world poses looking at the origin from ~5 away."""
    q = _quats(rng, n) * np.array([4.0, 1, 1, 1], np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = np.concatenate([rng.normal(0, 0.5, (n, 2)),
                        rng.uniform(4, 6, (n, 1))], 1)
    return np.concatenate([q, t], 1).astype(np.float32)


def test_resolved_num_samples_matches_jax():
    for ratio in (0.05, 0.1, 0.25, 0.33, 0.5, 0.7, 0.9, 0.99):
        for conf in (0.9, 0.99, 0.999, 0.9999, 0.999999):
            for size in (2, 3, 4, 5, 7, 8):
                for trials in (1000, 65536):
                    kw = dict(num_samples=None, min_inlier_ratio=ratio,
                              confidence=conf, max_num_trials=trials)
                    n_j = JRansacOptions(**kw).resolved_num_samples(size)
                    n_t = TRansacOptions(**kw).resolved_num_samples(size)
                    assert n_t == n_j and isinstance(n_t, int)
                    assert n_t % 64 == 0 and 64 <= n_t <= trials + 63
    # a fixed budget is returned as it is
    assert TRansacOptions(num_samples=300).resolved_num_samples(5) == 300


def test_verification_chunks_fit_the_adaptive_budget(monkeypatch):
    """match_and_verify_blocks with the adaptive budget (num_samples=None):
    each verification chunk holds F's 7-point budget, the largest of the
    three solvers', within VERIFY_ELEMS, and the pairs still verify."""
    from colmap_tpu_torch.controllers import feature_matching as fm
    from colmap_tpu_torch.scene import synthetic as tsyn
    from colmap_tpu_torch.scene.database import Database

    db = Database(":memory:")
    gt = tsyn.synthesize_dataset(tsyn.SyntheticDatasetOptions(
        num_cameras=1, num_images=3, num_points3D=100, seed=0), db)
    # the synthetic descriptors are random: give each track one descriptor,
    # plus noise per observation, for the matcher to find
    rng = np.random.default_rng(1)
    desc = {iid: db.read_descriptors(iid) for iid in db.read_images()}
    for p in gt.points3D.values():
        d = rng.integers(20, 236, 128)
        for iid, k in p.track:
            desc[iid][k] = d + rng.integers(-8, 9, 128)
    for iid, d in desc.items():
        db.write_descriptors(iid, d)
    ver = fm.FeatureMatchingOptions().verification
    # a trial cap of 16384 keeps the three budgets apart (H 2368, E 9472,
    # F 16384) at a quarter of the default cap's CPU time
    opts = fm.FeatureMatchingOptions(verification=dataclasses.replace(
        ver, ransac=dataclasses.replace(ver.ransac, num_samples=None,
                                        max_num_trials=16384)))
    budget = opts.verification.ransac.resolved_num_samples(7)
    assert budget > opts.verification.ransac.resolved_num_samples(5) > (
        opts.verification.ransac.resolved_num_samples(4))
    # room for two pairs at 64 matches: F's budget binds, H's would not
    monkeypatch.setattr(fm, "VERIFY_ELEMS", 2 * budget * 64)
    chunks = []
    estimate = fm.tvg.estimate_two_view_geometry

    def spy(generator, rays1, *args, **kw):
        chunks.append(tuple(rays1.shape[:2]))
        return estimate(generator, rays1, *args, **kw)

    monkeypatch.setattr(fm.tvg, "estimate_two_view_geometry", spy)
    stats = fm.match_and_verify_blocks(db, [[(1, 2), (1, 3), (2, 3)]], opts,
                                       device="cpu")
    assert sum(c for c, _ in chunks) == 3
    for c, mcap in chunks:
        assert c == 1 or c * budget * mcap <= fm.VERIFY_ELEMS, (c, mcap)
    assert stats.num_verified_pairs == 3


def _line_problem(rng, n=120, inlier_ratio=0.6):
    pts = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    k = int(n * inlier_ratio)
    pts[:k, 1] = 0.5 * pts[:k, 0] + 0.1 + rng.normal(0, 0.01, k)
    return pts


def _jline_solver(s):  # (2, 2) -> models (1, 3), valid (1,)
    d = s[1] - s[0]
    nrm = jnp.stack([-d[1], d[0]]) / jnp.maximum(jnp.linalg.norm(d), 1e-12)
    return jnp.concatenate([nrm, -nrm @ s[0][:, None]])[None], \
        jnp.linalg.norm(d)[None] > 1e-6


def _jline_res(m, data):
    (p,) = data
    return (p @ m[:2] + m[2]) ** 2


def _tline_solver(s):  # (B, S, 2, 2) -> (B, S, 1, 3), (B, S, 1)
    d = s[..., 1, :] - s[..., 0, :]
    ln = torch.linalg.norm(d, dim=-1, keepdim=True)
    nrm = torch.stack([-d[..., 1], d[..., 0]], -1) / torch.clamp(ln, min=1e-12)
    c = -(nrm * s[..., 0, :]).sum(-1, keepdim=True)
    return torch.cat([nrm, c], -1)[..., None, :], (ln > 1e-6)


def _tline_res(m, data):
    (p,) = data
    return ((p * m[..., None, :2]).sum(-1) + m[..., None, 2]) ** 2


@pytest.mark.parametrize("support", ["inlier_count", "msac"])
def test_support_scores_match_jax_on_fixed_hypotheses(support):
    """Both packages score the same hypotheses (the JAX package's own
    draws): the same best score, inlier count and inlier mask."""
    rng = np.random.default_rng(3)
    pts = _line_problem(rng)
    valid = np.ones(len(pts), bool)
    valid[-5:] = False
    key = jax.random.PRNGKey(7)
    jopts = JRansacOptions(max_error=0.03, num_samples=64, lo_iterations=0,
                           support=support)
    jres = jransac(key, _jline_solver, _jline_res, None, (jnp.asarray(pts),),
                   jnp.asarray(valid), 2, jopts)
    idx = jdraw(jax.random.split(key)[0], jnp.asarray(valid), 64, 2)
    topts = TRansacOptions(max_error=0.03, num_samples=64, lo_iterations=0,
                           support=support)
    tres = ransac_from_samples(
        T(np.asarray(idx))[None].long(), _tline_solver, _tline_res, None,
        (T(pts)[None],), T(valid)[None], 2, topts)
    assert int(tres.num_inliers[0]) == int(jres.num_inliers)
    np.testing.assert_array_equal(tres.inlier_mask[0].numpy(),
                                  np.asarray(jres.inlier_mask))
    np.testing.assert_allclose(float(tres.score[0]), float(jres.score),
                               rtol=1e-5)
    if support == "inlier_count":
        assert float(tres.score[0]) == int(jres.num_inliers)


def _two_motion_scene(rng):
    """A static background (120 points, depth 6-10) and an object moving
    on its own (80 points, depth 4-6) seen by two cameras, plus 20 random
    matches: two rigid motions with two different essential matrices."""
    from scipy.spatial.transform import Rotation

    f, w, h = 500.0, 640.0, 480.0

    def view(n, rotvec, t, lo, hi):
        X = rng.uniform(lo, hi, (n, 3))
        Y = X @ Rotation.from_rotvec(rotvec).as_matrix().T + t
        return (X[:, :2] / X[:, 2:] * f + [w / 2, h / 2],
                Y[:, :2] / Y[:, 2:] * f + [w / 2, h / 2])

    a1, a2 = view(120, [0, 0.1, 0.02], [-1.0, 0.1, 0.05], [-3, -2, 6],
                  [3, 2, 10])
    b1, b2 = view(80, [0.05, -0.15, 0.1], [0.6, -0.5, 0.3], [-1, -1, 4],
                  [1, 1, 6])
    o1, o2 = rng.uniform(100, 500, (2, 20, 2))
    pix1 = np.concatenate([a1, b1, o1]).astype(np.float32)
    pix2 = np.concatenate([a2, b2, o2]).astype(np.float32)
    rays1 = ((pix1 - [w / 2, h / 2]) / f).astype(np.float32)
    rays2 = ((pix2 - [w / 2, h / 2]) / f).astype(np.float32)
    return rays1, rays2, pix1, pix2, f


def test_multiple_two_view_geometries_match_jax():
    rays1, rays2, pix1, pix2, f = _two_motion_scene(np.random.default_rng(42))
    n = len(rays1)
    kw = dict(min_num_inliers=30, max_error_px=2.0, detect_watermark=False)
    jg, jconfig = jtvg.estimate_multiple_two_view_geometries(
        jax.random.PRNGKey(0), jnp.asarray(rays1), jnp.asarray(rays2),
        jnp.asarray(pix1), jnp.asarray(pix2), jnp.ones(n, bool),
        jnp.asarray(f, jnp.float32), jtvg.TwoViewGeometryOptions(**kw))
    tg, tconfig = ttvg.estimate_multiple_two_view_geometries(
        torch.Generator().manual_seed(0), T(rays1), T(rays2), T(pix1),
        T(pix2), torch.ones(n, dtype=torch.bool), torch.tensor(f),
        ttvg.TwoViewGeometryOptions(**kw))
    assert tconfig == jconfig == int(ttvg.TwoViewConfig.MULTIPLE)
    assert len(tg) == len(jg) == 2
    for a, b in zip(tg, jg):
        assert (a.inlier_mask == np.asarray(b.inlier_mask)).mean() >= 0.95
    assert not np.any(tg[0].inlier_mask & tg[1].inlier_mask)
    # the background first, then the object
    assert tg[0].inlier_mask[:120].mean() >= 0.95
    assert tg[1].inlier_mask[120:200].mean() >= 0.95


def test_translation_and_affine2d_match_jax(rng):
    src = rng.normal(0, 10, (40, 2)).astype(np.float32)
    M = np.array([[1.1, 0.2, 3.0], [-0.15, 0.9, -2.0]], np.float32)
    dst = (src @ M[:, :2].T + M[:, 2] + rng.normal(0, 0.01, (40, 2))
           ).astype(np.float32)
    np.testing.assert_allclose(
        tst.estimate_translation(T(src), T(dst)).numpy(),
        np.asarray(jst.estimate_translation(jnp.asarray(src),
                                            jnp.asarray(dst))), atol=1e-5)
    A_j = np.asarray(jst.estimate_affine2d(jnp.asarray(src), jnp.asarray(dst)))
    A_t = tst.estimate_affine2d(T(src), T(dst)).numpy()
    np.testing.assert_allclose(A_t, A_j, atol=1e-5)
    # batched: each problem as it is alone
    srcs = np.stack([src, src[::-1] * 2])
    dsts = np.stack([dst, dst[::-1]])
    A_b = tst.estimate_affine2d(T(srcs), T(dsts)).numpy()
    np.testing.assert_allclose(A_b[0], A_t, atol=1e-6)
    np.testing.assert_allclose(
        A_b[1], np.asarray(jst.estimate_affine2d(jnp.asarray(srcs[1]),
                                                 jnp.asarray(dsts[1]))),
        atol=1e-5)


def test_quat_average_matches_jax(rng):
    base = _quats(rng, 1)[0]
    qs = base + rng.normal(0, 0.05, (12, 4)).astype(np.float32)
    qs[::3] *= -1  # the sign of a quaternion does not matter
    w = rng.uniform(0.5, 2.0, 12).astype(np.float32)
    for weights in (None, w):
        j = np.asarray(jrot.quat_average(
            jnp.asarray(qs), None if weights is None else jnp.asarray(weights)))
        t = trot.quat_average(T(qs), None if weights is None
                              else T(weights)).numpy()
        np.testing.assert_allclose(t, j, atol=1e-5)
    # batched over a leading axis
    qb = np.stack([qs, qs[::-1] * -1])
    tb = trot.quat_average(T(qb)).numpy()
    np.testing.assert_allclose(tb[0], tb[1], atol=1e-5)


def test_triangulate_multi_view_matches_jax(rng):
    from colmap_tpu.geometry import rigid3 as jr3

    K, V = 30, 5
    poses = _poses(rng, V)
    P = np.asarray(jr3.to_matrix(jnp.asarray(poses)))  # (V, 3, 4)
    X = rng.uniform(-1, 1, (K, 3)).astype(np.float32)
    Xh = np.concatenate([X, np.ones((K, 1), np.float32)], 1)
    pc = np.einsum("vij,kj->kvi", P, Xh)
    uv = (pc[..., :2] / pc[..., 2:] + rng.normal(0, 1e-3, (K, V, 2))
          ).astype(np.float32)
    Pk = np.broadcast_to(P, (K, V, 3, 4)).astype(np.float32)
    mask = rng.random((K, V)) > 0.3
    mask[:, :2] = True
    for m in (None, mask):
        j = np.asarray(jtri.triangulate_multi_view(
            jnp.asarray(Pk), jnp.asarray(uv),
            None if m is None else jnp.asarray(m)))
        t = ttri.triangulate_multi_view(T(Pk), T(uv),
                                        None if m is None else T(m)).numpy()
        np.testing.assert_allclose(t, j, atol=1e-5)
        assert np.abs(t - X).max() < 0.05


def test_has_point_positive_depth_matches_jax(rng):
    poses = _poses(rng, 50)
    pts = rng.normal(0, 6, (50, 3)).astype(np.float32)
    j = np.asarray(jtri.has_point_positive_depth(jnp.asarray(poses),
                                                 jnp.asarray(pts)))
    t = ttri.has_point_positive_depth(T(poses), T(pts)).numpy()
    np.testing.assert_array_equal(t, j)
    assert 0 < t.mean() < 1


def test_essential_and_homography_from_pose_match_jax(rng):
    poses = _poses(rng, 8)
    E_j = np.asarray(jess.essential_from_pose(jnp.asarray(poses)))
    E_t = tess.essential_from_pose(T(poses)).numpy()
    np.testing.assert_allclose(E_t, E_j, atol=1e-5)
    R = np.asarray(jrot.quat_to_rotmat(jnp.asarray(poses[:, :4])))
    t = poses[:, 4:]
    n = rng.normal(0, 1, (8, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = rng.uniform(2, 5, 8).astype(np.float32)
    K1 = np.array([[500, 0, 320], [0, 510, 240], [0, 0, 1]], np.float32)
    K2 = np.array([[480, 0, 300], [0, 470, 250], [0, 0, 1]], np.float32)
    K1b, K2b = np.broadcast_to(K1, (8, 3, 3)), np.broadcast_to(K2, (8, 3, 3))
    H_j = np.asarray(jhom.homography_from_pose(*map(jnp.asarray,
                                                    (K1b, K2b, R, t, n, d))))
    H_t = thom.homography_from_pose(*map(T, (K1b, K2b, R, t, n, d))).numpy()
    np.testing.assert_allclose(H_t, H_j, atol=1e-5 * np.abs(H_j).max())


def test_apply_model_mixed_ids_matches_jax(rng):
    ids = np.array([0, 1, 2, 4, 2, 0, 4, 1, 1, 2], np.int32)
    params = np.zeros((len(ids), 12), np.float32)
    for i, m in enumerate(ids):
        n = tmodels.NUM_PARAMS[tmodels.CameraModelId(int(m))]
        p = [400.0 + 10 * i, 410.0, 320.0, 240.0] + list(
            rng.normal(0, 0.02, 8))
        if m in (0, 2):  # f, cx, cy (+ k)
            p = [400.0 + 10 * i, 320.0, 240.0, 0.03]
        params[i, :n] = p[:n]
    uv = rng.normal(0, 0.3, (len(ids), 6, 2)).astype(np.float32)
    table_ids = (0, 1, 2, 4)
    jtable = {m: jmodels.img_from_cam for m in table_ids}
    ttable = {m: tmodels.img_from_cam for m in table_ids}
    j = np.asarray(jax.vmap(lambda m, p, u: jmodels.apply_model(
        jtable, m, p, u))(jnp.asarray(ids), jnp.asarray(params),
                          jnp.asarray(uv)))
    t = tmodels.apply_model(ttable, T(ids), T(params), T(uv)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * np.abs(j).max())
    # each row equals its own model's function
    for i, m in enumerate(ids):
        np.testing.assert_allclose(
            t[i], tmodels.img_from_cam(int(m), T(params[i]), T(uv[i])).numpy(),
            rtol=1e-6)


def test_timer_accumulates():
    t = Timer(start=True)
    time.sleep(0.02)
    t.pause()
    s1 = t.elapsed_seconds()
    assert s1 >= 0.015
    time.sleep(0.02)
    assert abs(t.elapsed_seconds() - s1) < 1e-9  # paused
    t.resume()
    time.sleep(0.01)
    assert t.elapsed_seconds() > s1
    t.restart()
    assert t.elapsed_seconds() < s1


def test_stage_timings_and_trace(tmp_path):
    st = StageTimings()
    with st.stage("a"):
        pass
    with st.stage("a"):
        pass
    with st.stage("b"):
        pass
    assert st.counts["a"] == 2 and st.counts["b"] == 1
    assert "a" in st.report()
    from colmap_tpu_torch.util.timer import trace

    with trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_visibility_pyramid_scores_match_jax(rng):
    w, h = 640, 480
    pj, pt = JPyramid(6, w, h), TPyramid(6, w, h)
    pts = rng.uniform(0, [w, h], (200, 2))
    for k, (x, y) in enumerate(pts):
        pj.add_point(x, y)
        pt.add_point(x, y)
        assert pt.score == pj.score
        if k % 3 == 2:  # remove an earlier point
            x0, y0 = pts[k - 2]
            pj.remove_point(x0, y0)
            pt.remove_point(x0, y0)
            assert pt.score == pj.score
    assert pt.score > 0
    pt.reset()
    assert pt.score == 0
