"""The port's generalized (rig) absolute and relative pose against the JAX
package's, on the CPU, on tests/test_rigs.py's problems.

RANSAC draws differ (JAX keys against a torch.Generator), so both are held
by outcome on the same inputs: each recovers the true rig pose (absolute:
rotation 0.5 deg and translation 0.02, the JAX test's bounds; relative:
rotation 1 deg, translation 0.1) and the two inlier masks agree on >= 95%
of the observations. The batched form (a leading axis of problems) gives
each problem's own answer.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from colmap_tpu.estimators import generalized_pose as jgp
from colmap_tpu.geometry import rigid3 as jrigid3
from colmap_tpu.optim.ransac import RansacOptions as JRansacOptions
from colmap_tpu_torch.estimators import generalized_pose as tgp
from colmap_tpu_torch.optim.ransac import RansacOptions as TRansacOptions
from test_rigs import _quat, _rig_setup

torch.set_num_threads(2)


def _rot_err_deg(pose, gt):
    q = np.asarray(pose[:4], np.float64)
    dq = abs(np.dot(q / np.linalg.norm(q), gt[:4]))
    return np.degrees(2 * np.arccos(min(dq, 1.0)))


def _absolute_problem(rng):
    cams_from_rig = _rig_setup(rng)
    rig_gt = np.concatenate([_quat(rng), rng.normal(0, 1, 3)
                             + [0, 0, 4]]).astype(np.float32)
    n = 150
    X = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    cam_idx = rng.integers(0, 3, n).astype(np.int32)
    cfw = np.stack([np.asarray(jrigid3.compose(
        jnp.asarray(cams_from_rig[c]), jnp.asarray(rig_gt)))
        for c in cam_idx])
    pc = np.asarray(jrigid3.apply(jnp.asarray(cfw), jnp.asarray(X)))
    ok = pc[:, 2] > 0.5
    X, cam_idx, pc = X[ok], cam_idx[ok], pc[ok]
    uv = (pc[:, :2] / pc[:, 2:]).astype(np.float32)
    bad = rng.choice(len(uv), len(uv) // 5, replace=False)
    uv[bad] += rng.normal(0, 0.3, (len(bad), 2))
    return X, uv, cam_idx, cams_from_rig, rig_gt, bad


def test_generalized_absolute_pose_matches_jax(rng):
    X, uv, cam_idx, cams_from_rig, rig_gt, bad = _absolute_problem(rng)
    n = len(uv)
    jr = jgp.estimate_generalized_absolute_pose(
        jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(uv),
        jnp.asarray(cam_idx), jnp.asarray(cams_from_rig),
        jnp.ones(n, bool), options=JRansacOptions(
            num_samples=1024, lo_iterations=2, max_error=4.0 / 800.0))
    opts = TRansacOptions(num_samples=1024, lo_iterations=2,
                          max_error=4.0 / 800.0)
    args = (torch.as_tensor(X), torch.as_tensor(uv),
            torch.as_tensor(cam_idx), torch.as_tensor(cams_from_rig),
            torch.ones(n, dtype=torch.bool))
    tr = tgp.estimate_generalized_absolute_pose(
        torch.Generator().manual_seed(0), *args, options=opts)
    for r in (jr, tr):
        pose = np.asarray(r.rig_from_world)
        assert bool(r.success)
        assert _rot_err_deg(pose, rig_gt) < 0.5
        np.testing.assert_allclose(pose[4:], rig_gt[4:], atol=0.02)
        assert int(r.num_inliers) > 0.7 * (n - len(bad))
    agree = (np.asarray(jr.inlier_mask) == tr.inlier_mask.numpy()).mean()
    assert agree >= 0.95, agree

    # a batch of two problems: the second has its observations reversed
    rev = [a.flip(0) if a.dim() and a.shape[0] == n else a for a in args]
    batch = [torch.stack([a, b]) if a.shape[0] == n else a
             for a, b in zip(args, rev)]
    br = tgp.estimate_generalized_absolute_pose(
        torch.Generator().manual_seed(1), *batch, options=opts)
    assert br.rig_from_world.shape == (2, 7)
    for b in range(2):
        pose = br.rig_from_world[b].numpy()
        assert _rot_err_deg(pose, rig_gt) < 0.5
        np.testing.assert_allclose(pose[4:], rig_gt[4:], atol=0.02)
    np.testing.assert_array_equal(br.inlier_mask[1].flip(0).numpy(),
                                  br.inlier_mask[0].numpy())


def test_generalized_relative_pose_matches_jax():
    rng = np.random.default_rng(0)
    cams_from_rig = _rig_setup(rng, num_cams=2)
    gt = np.concatenate([_quat(rng, 0.15), [0.8, 0.1, 0.3]]).astype(
        np.float32)
    n = 200
    X = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    X[:, 2] += 8
    c1 = rng.integers(0, 2, n).astype(np.int32)
    c2 = np.where(rng.uniform(size=n) < 0.5, c1,
                  rng.integers(0, 2, n)).astype(np.int32)

    def project(rig_pose, cidx):
        cfw = np.stack([np.asarray(jrigid3.compose(
            jnp.asarray(cams_from_rig[c]), jnp.asarray(rig_pose)))
            for c in cidx])
        pc = np.asarray(jrigid3.apply(jnp.asarray(cfw), jnp.asarray(X)))
        return (pc[:, :2] / pc[:, 2:]).astype(np.float32), pc[:, 2] >= 0.5

    uv1, ok1 = project(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), c1)
    uv2, ok2 = project(gt, c2)
    keep = ok1 & ok2
    uv1, uv2, c1, c2 = uv1[keep], uv2[keep], c1[keep], c2[keep]
    m = int(keep.sum())
    bad = rng.choice(m, m // 7, replace=False)
    uv2[bad] += rng.normal(0, 0.2, (len(bad), 2)).astype(np.float32)

    jr = jgp.estimate_generalized_relative_pose(
        jax.random.PRNGKey(1), jnp.asarray(uv1), jnp.asarray(uv2),
        jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(cams_from_rig),
        jnp.ones(m, bool), options=JRansacOptions(
            num_samples=1024, lo_iterations=3, max_error=2e-3))
    tr = tgp.estimate_generalized_relative_pose(
        torch.Generator().manual_seed(1), torch.as_tensor(uv1),
        torch.as_tensor(uv2), torch.as_tensor(c1), torch.as_tensor(c2),
        torch.as_tensor(cams_from_rig), torch.ones(m, dtype=torch.bool),
        options=TRansacOptions(num_samples=1024, lo_iterations=3,
                               max_error=2e-3))
    for r in (jr, tr):
        pose = np.asarray(r.rig_from_world)
        assert _rot_err_deg(pose, gt) < 1.0
        np.testing.assert_allclose(pose[4:], gt[4:], atol=0.1)
    agree = (np.asarray(jr.inlier_mask) == tr.inlier_mask.numpy()).mean()
    assert agree >= 0.95, agree
