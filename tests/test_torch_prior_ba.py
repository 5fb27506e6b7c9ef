"""The port's pose-prior BA and pose-prior mapper against the JAX
package's, on the CPU.

Tolerances:
- reprojection and prior residuals at the same parameters: 1e-5;
- solve_prior_ba, 4 LM x 10 CG on the same problem: cost 1e-3 relative,
  poses and points 1e-4;
- refine_with_priors on tests/test_prior_ba_rectification.py:15's problem
  (25 LM x 50 CG): poses and points within 2e-3 of JAX's, and both
  packages' median centre error below that test's 0.01;
- run_pose_prior_mapper on a synthetic database with Cartesian priors
  (coordinate_system 0, sigma = 1% of the spread of the true centres),
  held to the ground truth with no Sim3 alignment: every image
  registered, rotations <= 1 deg, centres within 0.05 x the diameter of
  the true centres, median |centre - prior| <= 2 sigma;
- WGS84 priors (coordinate_system 1) convert to ENU in float64: within
  1e-6 m of a numpy float64 reference; the JAX package's float32
  conversion is shown to be off by more than 1e-3 m on the same input.
"""

import copy

import numpy as np
import torch

import jax.numpy as jnp

from colmap_tpu.estimators import pose_prior_ba as jpba
from colmap_tpu.geometry import gps as jgps
from colmap_tpu.scene import synthetic as jsyn
from colmap_tpu.scene.database import Database as JDatabase
from colmap_tpu_torch.estimators import pose_prior_ba as tpba
from colmap_tpu_torch.estimators.similarity_transform import (
    compare_reconstructions)
from colmap_tpu_torch.geometry import rotation as trot
from colmap_tpu_torch.scene import reconstruction as trec
from colmap_tpu_torch.scene import synthetic as tsyn
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.tools import sfm_tools

torch.set_num_threads(2)


def port_rec(rec):
    """The port's Reconstruction holding a copy of a JAX Reconstruction."""
    out = trec.Reconstruction()
    for c in rec.cameras.values():
        out.add_camera(trec.Camera(camera_id=c.camera_id,
                                   model_id=c.model_id, width=c.width,
                                   height=c.height,
                                   params=np.array(c.params, np.float64)))
    for im in rec.images.values():
        out.add_image(trec.Image(
            image_id=im.image_id, name=im.name, camera_id=im.camera_id,
            cam_from_world=None if im.cam_from_world is None
            else np.array(im.cam_from_world, np.float64),
            xys=np.array(im.xys), point3D_ids=np.array(im.point3D_ids)))
    for pid, p in rec.points3D.items():
        out.points3D[pid] = trec.Point3D(xyz=np.array(p.xyz),
                                         color=np.array(p.color),
                                         error=p.error, track=list(p.track))
    out._next_point3D_id = rec._next_point3D_id
    return out


def _perturbed(rng):
    """tests/test_prior_ba_rectification.py:15's problem."""
    gt = jsyn.synthesize_dataset(jsyn.SyntheticDatasetOptions(
        num_cameras=1, num_images=8, num_points3D=150, seed=6),
        JDatabase(":memory:"))
    rec = copy.deepcopy(gt)
    for iid in rec.registered_image_ids():
        rec.images[iid].cam_from_world = rec.images[iid].cam_from_world.copy()
        rec.images[iid].cam_from_world[4:] += rng.normal(0, 0.01, 3) + 0.3
    for pid in rec.points3D:
        rec.points3D[pid].xyz = rec.points3D[pid].xyz + rng.normal(
            0, 0.005, 3)
    priors = {iid: gt.images[iid].projection_center()
              for iid in gt.registered_image_ids()}
    return gt, rec, priors


def _problems(rec, priors, model_id):
    """The same PriorBAProblem in both packages (JAX's refine_with_priors
    assembly)."""
    reg = rec.registered_image_ids()
    pids = sorted(rec.points3D)
    obs = [(reg.index(iid), pids.index(pid), rec.images[iid].xys[f])
           for pid in pids for iid, f in rec.points3D[pid].track]
    prior_pos = np.stack([priors[i] for i in reg]).astype(np.float32)
    jp = jpba.PriorBAProblem(
        poses=jnp.asarray(np.stack([rec.images[i].cam_from_world
                                    for i in reg]), jnp.float32),
        cam_params=jnp.asarray(np.stack([rec.cameras[c].padded_params()
                                         for c in sorted(rec.cameras)])),
        points=jnp.asarray(np.stack([rec.points3D[p].xyz for p in pids]),
                           jnp.float32),
        obs_pose_idx=jnp.asarray([o[0] for o in obs], jnp.int32),
        obs_cam_idx=jnp.zeros(len(obs), jnp.int32),
        obs_point_idx=jnp.asarray([o[1] for o in obs], jnp.int32),
        obs_xy=jnp.asarray(np.stack([o[2] for o in obs]), jnp.float32),
        obs_weight=jnp.ones(len(obs), jnp.float32),
        prior_positions=jnp.asarray(prior_pos),
        prior_weight=jnp.full((len(reg), 3), 100.0, jnp.float32),
        pose_mask=jnp.ones((len(reg), 6), jnp.float32),
        point_mask=jnp.ones((len(pids), 3), jnp.float32))
    tp = tpba.problem_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    return jp, tp


def test_prior_and_reprojection_residuals_match_jax(rng):
    gt, rec, priors = _perturbed(rng)
    model_id = int(gt.cameras[1].model_id)
    jp, tp = _problems(rec, priors, model_id)
    for scale in (1.0, 0.01):
        np.testing.assert_allclose(
            tpba._prior_residuals(tp, tp.poses, scale).numpy(),
            np.asarray(jpba._prior_residuals(jp, jp.poses, scale)),
            atol=1e-5)
    np.testing.assert_allclose(
        tpba._reproj_residuals(tp, tp.poses, tp.points, model_id).numpy(),
        np.asarray(jpba._reproj_residuals(jp, jp.poses, jp.points,
                                          model_id)), atol=1e-5)


def test_solve_prior_ba_matches_jax(rng):
    gt, rec, priors = _perturbed(rng)
    model_id = int(gt.cameras[1].model_id)
    jp, tp = _problems(rec, priors, model_id)
    opts = dict(max_iterations=4, cg_iterations=10, camera_model_id=model_id)
    js, jc = jpba.solve_prior_ba(jp, jpba.PriorBAOptions(**opts))
    stats = {}
    ts, tc = tpba.solve_prior_ba(tp, tpba.PriorBAOptions(**opts),
                                 stats=stats)
    assert stats == dict(lm_iterations=4, cg_steps=stats["cg_steps"],
                         syncs=0) and 0 < stats["cg_steps"] <= 40
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-3)
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses),
                               atol=1e-4)
    np.testing.assert_allclose(ts.points.numpy(), np.asarray(js.points),
                               atol=1e-4)


def test_refine_with_priors_matches_jax(rng):
    gt, rec, priors = _perturbed(rng)
    model_id = int(gt.cameras[1].model_id)
    tr = port_rec(rec)
    opts = dict(max_iterations=25, cg_iterations=50, camera_model_id=model_id)
    jpba.refine_with_priors(rec, priors, sigma=0.01,
                            options=jpba.PriorBAOptions(**opts))
    tpba.refine_with_priors(tr, priors, sigma=0.01,
                            options=tpba.PriorBAOptions(**opts), device="cpu")
    for r in (rec, tr):
        errs = [np.linalg.norm(r.images[i].projection_center() - priors[i])
                for i in priors]
        assert np.median(errs) < 0.01
    for iid in priors:
        np.testing.assert_allclose(tr.images[iid].cam_from_world,
                                   rec.images[iid].cam_from_world, atol=2e-3)
    for pid in rec.points3D:
        np.testing.assert_allclose(tr.points3D[pid].xyz, rec.points3D[pid].xyz,
                                   atol=2e-3)


def test_run_pose_prior_mapper_cartesian_priors():
    db = Database(":memory:")
    gt = tsyn.synthesize_dataset(tsyn.SyntheticDatasetOptions(
        num_cameras=1, num_images=12, num_points3D=400, point2D_stddev=0.5,
        match_config=tsyn.MatchConfig.CHAINED, match_overlap=6,
        point_visibility_images=8, seed=5), db)
    centres = {iid: gt.images[iid].projection_center()
               for iid in gt.registered_image_ids()}
    C = np.stack(list(centres.values()))
    sigma = 0.01 * np.std(C, axis=0).mean()
    rng = np.random.default_rng(5)
    priors = {iid: c + rng.normal(0, sigma, 3) for iid, c in centres.items()}
    for iid, p in priors.items():
        db.write_pose_prior(iid, p, coordinate_system=0)
    db.commit()
    stats = {}
    rec = sfm_tools.run_pose_prior_mapper(db, device="cpu", stats=stats)
    assert stats["lm_iterations"] == 30 and stats["syncs"] == 0
    assert rec.num_registered_images() == 12
    diameter = np.linalg.norm(C.max(0) - C.min(0))
    for iid in centres:
        im = rec.images[iid]
        q = torch.as_tensor(im.cam_from_world[:4])
        ang = float(trot.quat_angle_deg(
            q, torch.as_tensor(gt.images[iid].cam_from_world[:4])))
        assert ang <= 1.0, (iid, ang)
        assert (np.linalg.norm(im.projection_center() - centres[iid])
                <= 0.05 * diameter)
    med = np.median([np.linalg.norm(rec.images[i].projection_center()
                                    - priors[i]) for i in priors])
    assert med <= 2 * sigma, (med, sigma)
    # the aligned model already sits in the prior frame: a Sim3 alignment
    # to the ground truth is near the identity
    cmp = compare_reconstructions(rec, gt, device="cpu")
    assert abs(cmp["sim3"][0] - 1.0) < 0.01


def _enu_float64(lla):
    """WGS84 geodetic -> ENU about the first point, numpy float64."""
    a, f = 6378137.0, 1.0 / 298.257223563
    e2 = f * (2 - f)
    lat, lon = np.radians(lla[:, 0]), np.radians(lla[:, 1])
    N = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    ecef = np.stack([(N + lla[:, 2]) * np.cos(lat) * np.cos(lon),
                     (N + lla[:, 2]) * np.cos(lat) * np.sin(lon),
                     (N * (1 - e2) + lla[:, 2]) * np.sin(lat)], 1)
    sl, cl = np.sin(lat[0]), np.cos(lat[0])
    so, co = np.sin(lon[0]), np.cos(lon[0])
    R = np.array([[-so, co, 0], [-sl * co, -sl * so, cl],
                  [cl * co, cl * so, sl]])
    return (ecef - ecef[0]) @ R.T


def test_wgs84_priors_convert_in_float64():
    rng = np.random.default_rng(3)
    lla = np.stack([47.3769 + rng.uniform(-1e-3, 1e-3, 6),
                    8.5417 + rng.uniform(-1e-3, 1e-3, 6),
                    400 + rng.uniform(-5, 5, 6)], 1)
    db = Database(":memory:")
    for k in range(6):
        db.write_image(f"im{k}.png", 1, image_id=k + 1)
    for k in range(6):
        db.write_pose_prior(k + 1, lla[k], coordinate_system=1)
    positions = sfm_tools.prior_positions(db)
    ref = _enu_float64(lla)
    got = np.stack([positions[f"im{k}.png"] for k in range(6)])
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # the JAX package converts in float32 (sfm_tools.py:192): metres off
    jax_enu = np.asarray(jgps.ell_to_enu(jnp.asarray(lla)))
    assert np.abs(jax_enu - ref).max() > 1e-3
