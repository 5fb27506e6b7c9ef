"""The port's absolute pose estimators against the JAX package's, on the
CPU. Tolerances (float32 on both sides):
- P3P on noise-free problems: a solution within 1e-2 of the true pose (all
  7 entries) in at least as many problems as JAX, less one;
- gn_refine_pose from the same start: 1e-5 abs against JAX;
- EPnP: 1e-4 abs against JAX;
- PnP LO-RANSAC (the mapper's batch) with 30% outliers: every true inlier
  found, no outlier kept, pose within 1e-3 of the truth.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from colmap_tpu.estimators import absolute_pose as jap
from colmap_tpu.geometry import rigid3 as jrigid3, rotation as jrot
from colmap_tpu_torch.estimators import absolute_pose as tap
from colmap_tpu_torch.sfm.incremental_mapper import _pnp_ransac_batch

torch.set_num_threads(2)


def _poses(rng, B):
    aa = rng.normal(0, 0.3, (B, 3)).astype(np.float32)
    t = rng.normal(0, 0.5, (B, 3)).astype(np.float32)
    t[:, 2] += 4.0
    q = np.asarray(jrot.quat_from_axis_angle(jnp.asarray(aa)))
    return np.concatenate([q, t], 1).astype(np.float32)


def _project(pose, X):
    pc = np.asarray(jrigid3.apply(jnp.asarray(pose)[:, None],
                                  jnp.asarray(X)))
    return (pc[..., :2] / pc[..., 2:]).astype(np.float32)


def test_p3p_finds_the_true_pose_as_often_as_jax():
    rng = np.random.default_rng(0)
    B = 64
    pose = _poses(rng, B)
    X = rng.uniform(-1, 1, (B, 3, 3)).astype(np.float32)
    uv = _project(pose, X)
    jp, jv = jax.vmap(jap.solve_p3p)(jnp.asarray(X), jnp.asarray(uv))
    tp, tv = tap.solve_p3p(torch.as_tensor(X), torch.as_tensor(uv))
    assert tp.shape == (B, 4, 7) and tv.shape == (B, 4)

    def hits(P, V):
        err = np.abs(np.asarray(P) - pose[:, None]).max(-1)
        return int(((err < 1e-2) & np.asarray(V)).any(-1).sum())

    n_jax, n_port = hits(jp, jv), hits(tp.numpy(), tv.numpy())
    assert n_jax >= 0.7 * B
    assert n_port >= n_jax - 1, (n_port, n_jax)


def test_gn_refine_and_epnp_match_jax():
    rng = np.random.default_rng(1)
    B, N = 16, 40
    pose = _poses(rng, B)
    X = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    uv = _project(pose, X) + rng.normal(0, 1e-3, (B, N, 2)).astype(
        np.float32)
    start = np.asarray(jrigid3.exp_update(
        jnp.asarray(pose),
        jnp.asarray(rng.normal(0, 0.02, (B, 6)).astype(np.float32))))
    w = (rng.random((B, N)) > 0.2).astype(np.float32)
    jg = jax.vmap(lambda p, x, u, ww: jap.gn_refine_pose(
        p, x, u, ww, num_iters=10))(*map(jnp.asarray, (start, X, uv, w)))
    tg = tap.gn_refine_pose(*map(torch.as_tensor, (start, X, uv, w)),
                            num_iters=10)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)
    assert np.abs(tg.numpy() - pose).max() < 0.02

    je, jev = jax.vmap(jap.solve_epnp)(jnp.asarray(X), jnp.asarray(uv))
    te, tev = tap.solve_epnp(torch.as_tensor(X), torch.as_tensor(uv))
    assert bool(tev.all()) and bool(np.asarray(jev).all())
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-4)


def test_pnp_lo_ransac_with_outliers():
    rng = np.random.default_rng(2)
    K, N = 4, 120
    pose = _poses(rng, K)
    X = rng.uniform(-1, 1, (K, N, 3)).astype(np.float32)
    uv = _project(pose, X)
    outlier = rng.random((K, N)) < 0.3
    uv[outlier] += rng.uniform(-0.3, 0.3, (int(outlier.sum()), 2)).astype(
        np.float32)
    valid = np.ones((K, N), bool)
    valid[1, 100:] = False  # a shorter problem in the batch
    g = torch.Generator().manual_seed(0)
    err = np.full(K, 4.0 / 500.0, np.float32)  # 4 px at a focal of 500
    poses, inliers = _pnp_ransac_batch(
        g, *map(torch.as_tensor, (X, uv, valid, err)), num_samples=256)
    assert poses.shape == (K, 7) and inliers.shape == (K, N)
    truth = ~outlier & valid
    # an outlier displaced by less than the threshold is an inlier
    near = np.linalg.norm(uv - _project(pose, X), axis=-1) < 4.0 / 500.0
    np.testing.assert_array_equal(inliers, near & valid)
    assert (inliers >= truth).all()
    np.testing.assert_allclose(poses, pose, atol=1e-3)


def test_focal_search_recovers_the_focal_factor():
    """estimate_pose_with_focal_search on rays normalized with a focal 1.4x
    too small: the best factor of the 9-sample grid in [0.5, 2] is the one
    nearest 1.4, and the pose is near the truth."""
    rng = np.random.default_rng(3)
    pose = _poses(rng, 1)
    X = rng.uniform(-1, 1, (1, 80, 3)).astype(np.float32)
    uv = _project(pose, X)[0] * 1.4
    g = torch.Generator().manual_seed(0)
    p, factor, ninl, mask = tap.estimate_pose_with_focal_search(
        g, torch.as_tensor(X[0]), torch.as_tensor(uv),
        torch.ones(80, dtype=torch.bool), 2.0 / 500.0)
    grid = np.exp(np.linspace(np.log(0.5), np.log(2.0), 9))
    assert float(factor) == pytest.approx(grid[np.argmin(abs(grid - 1.4))],
                                          rel=1e-5)
    assert int(ninl) >= 40 and int(mask.sum()) == int(ninl)
    assert np.abs(p.numpy()[:4] - pose[0, :4]).max() < 0.05
