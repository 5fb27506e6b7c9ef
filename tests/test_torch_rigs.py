"""The port's camera rigs and rig bundle adjustment against the JAX
package's, on the CPU.

Inputs are tests/test_rigs.py's and tests/test_prior_ba_rectification.py's
rig problems, handed to both packages as the same numpy arrays.
Tolerances:
- CameraRig poses (float32 compositions on both sides): 1e-6;
- rig BA residuals at the start: 1e-5 px;
- rig BA after 25 LM x 40 CG with JAX's unpreconditioned CG
  (block_jacobi=False; CG never converges here, so float32 sums in another
  order drift): both recover the true extrinsics to 5e-3 and the port's rig
  poses, extrinsics and points agree with JAX's to 5e-3; the port's
  default block-Jacobi CG reaches a cost no higher in fewer CG steps;
- load_rig_config: snapshots and extrinsics exact;
- run_rig_bundle_adjustment: the rig constraint to 5e-3 (the JAX test's
  bound); with JAX's CG, image poses within 5e-3 of JAX's.
"""

import functools
import json

import numpy as np
import torch

import jax.numpy as jnp

from colmap_tpu.estimators import rig_bundle_adjustment as jrba
from colmap_tpu.geometry import rigid3 as jrigid3
from colmap_tpu.scene import reconstruction as jrec
from colmap_tpu.scene.camera_rig import CameraRig as JCameraRig
from colmap_tpu.sensor import models as jcm
from colmap_tpu.tools import rig_tools as jrt
from colmap_tpu_torch.estimators import rig_bundle_adjustment as trba
from colmap_tpu_torch.scene import reconstruction as trec
from colmap_tpu_torch.scene.camera_rig import CameraRig as TCameraRig
from colmap_tpu_torch.tools import rig_tools as trt
from test_rigs import _quat, _rig_setup

torch.set_num_threads(2)


def _both(build):
    """The same model built with each package's Reconstruction classes."""
    return build(jrec), build(trec)


def _rig_scene(mod, cams_from_rig, rig_gt):
    rec = mod.Reconstruction()
    for c in range(3):
        rec.add_camera(mod.Camera(camera_id=c + 1, model_id=0, width=100,
                                  height=100,
                                  params=np.array([100.0, 50, 50])))
        pose = np.asarray(jrigid3.compose(
            jnp.asarray(cams_from_rig[c], jnp.float32),
            jnp.asarray(rig_gt, jnp.float32)), np.float64)
        rec.add_image(mod.Image(image_id=c + 1, name=f"c{c}.png",
                                camera_id=c + 1, cam_from_world=pose))
    return rec


def test_camera_rig_matches_jax(rng):
    cams_from_rig = _rig_setup(rng)
    rig_gt = np.concatenate([_quat(rng), rng.normal(0, 1, 3)])
    jr, tr = _both(lambda mod: _rig_scene(mod, cams_from_rig, rig_gt))
    rigs = []
    for Rig in (JCameraRig, TCameraRig):
        rig = Rig()
        for c in range(3):
            rig.add_camera(c + 1, cams_from_rig[c])
        rig.add_snapshot([1, 2, 3])
        rigs.append(rig)
    assert rigs[0].check(jr) and rigs[1].check(tr)
    est_j = rigs[0].compute_rig_from_world(0, jr)
    est_t = rigs[1].compute_rig_from_world(0, tr)
    np.testing.assert_allclose(est_t, est_j, atol=1e-6)
    np.testing.assert_allclose(est_t[4:], rig_gt[4:], atol=1e-4)
    # perturb the extrinsics, then calibrate them back from the images
    for rig in rigs:
        rig.cams_from_rig[2] = rig.cams_from_rig[2] + 0.01
        rig.compute_cams_from_rigs(jr if isinstance(rig, JCameraRig) else tr)
    for c in range(1, 4):
        np.testing.assert_allclose(rigs[1].cams_from_rig[c],
                                   rigs[0].cams_from_rig[c], atol=1e-6)
        np.testing.assert_allclose(rigs[1].cams_from_rig[c][4:],
                                   cams_from_rig[c - 1][4:], atol=1e-4)


def _rig_ba_problem(rng):
    """tests/test_rigs.py:107's problem."""
    cams_from_rig = _rig_setup(rng)
    num_snapshots, num_points = 6, 120
    X = rng.uniform(-2, 2, (num_points, 3)).astype(np.float32)
    X[:, 2] += 6
    rig_poses = np.stack([np.concatenate([
        _quat(rng, 0.1), np.array([s * 0.5 - 1.5, 0, 0])
        + rng.normal(0, 0.1, 3)]).astype(np.float32)
        for s in range(num_snapshots)])
    f = 500.0
    cam_params = np.stack([jcm.pad_params([f, 0.0, 0.0])] * 3)
    obs_s, obs_c, obs_p, obs_xy = [], [], [], []
    for s in range(num_snapshots):
        for c in range(3):
            pose = np.asarray(jrigid3.compose(jnp.asarray(cams_from_rig[c]),
                                              jnp.asarray(rig_poses[s])))
            pc = np.asarray(jrigid3.apply(
                jnp.asarray(np.tile(pose, (num_points, 1))), jnp.asarray(X)))
            vis = np.nonzero(pc[:, 2] > 1)[0]
            obs_s += [s] * len(vis)
            obs_c += [c] * len(vis)
            obs_p += list(vis)
            obs_xy.append(f * pc[vis, :2] / pc[vis, 2:])
    rig_noisy = rig_poses.copy()
    rig_noisy[1:, 4:] += rng.normal(0, 0.03, (num_snapshots - 1, 3))
    cams_noisy = cams_from_rig.copy()
    cams_noisy[1:, 4:] += rng.normal(0, 0.02, (2, 3))
    X_noisy = X + rng.normal(0, 0.02, X.shape).astype(np.float32)
    jp = jrba.make_rig_problem(
        rig_noisy, cams_noisy, cam_params, X_noisy,
        np.array(obs_s, np.int32), np.array(obs_c, np.int32),
        np.array(obs_p, np.int32), np.concatenate(obs_xy).astype(np.float32))
    tp = trba.problem_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    return jp, tp, cams_from_rig


def test_rig_bundle_adjustment_matches_jax(rng):
    jp, tp, cams_from_rig = _rig_ba_problem(rng)
    r_j = np.asarray(jrba._residuals(jp, jp.rig_poses, jp.cams_from_rig,
                                     jp.points, 0))
    r_t = trba._residuals(tp, tp.rig_poses, tp.cams_from_rig, tp.points, 0)
    np.testing.assert_allclose(r_t.numpy(), r_j, atol=1e-5)

    js, _ = jrba.solve_rig(jp, jrba.RigBAOptions(max_iterations=25,
                                                 cg_iterations=40))
    stats = {}
    ts, cost = trba.solve_rig(tp, trba.RigBAOptions(
        max_iterations=25, cg_iterations=40, block_jacobi=False), stats=stats)
    assert stats["lm_iterations"] == 25 and stats["syncs"] == 0
    assert 0 < stats["cg_steps"] <= 25 * 40
    r = trba._residuals(ts, ts.rig_poses, ts.cams_from_rig, ts.points, 0)
    assert float(torch.sqrt((r ** 2).sum(-1).mean())) < 0.1
    for cams in (np.asarray(js.cams_from_rig), ts.cams_from_rig.numpy()):
        np.testing.assert_allclose(cams[1:, 4:], cams_from_rig[1:, 4:],
                                   atol=5e-3)
    for name in ("rig_poses", "cams_from_rig", "points"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=5e-3,
                                   err_msg=name)
    # the port's default, block-Jacobi-preconditioned CG converges: the
    # same optimum, nearer the truth, in fewer CG steps
    stats_pc = {}
    tpc, cost_pc = trba.solve_rig(tp, trba.RigBAOptions(
        max_iterations=25, cg_iterations=40), stats=stats_pc)
    assert float(cost_pc) <= float(cost)
    assert stats_pc["cg_steps"] < stats["cg_steps"]
    np.testing.assert_allclose(tpc.cams_from_rig.numpy()[1:, 4:],
                               cams_from_rig[1:, 4:], atol=5e-3)
    for s in (ts, tpc):  # the gauge: the first snapshot, the reference camera
        np.testing.assert_array_equal(s.rig_poses[0].numpy(),
                                      tp.rig_poses[0].numpy())
        np.testing.assert_array_equal(s.cams_from_rig[0].numpy(),
                                      tp.cams_from_rig[0].numpy())


def test_rig_bundle_adjustment_fixed_relative_poses(rng):
    """refine_relative_poses=False zeroes the camera mask: the extrinsics
    come back unchanged while the rig poses and points move."""
    _, tp, _ = _rig_ba_problem(rng)
    ts, _ = trba.solve_rig(tp, trba.RigBAOptions(
        max_iterations=3, cg_iterations=10, refine_relative_poses=False))
    np.testing.assert_array_equal(ts.cams_from_rig.numpy(),
                                  tp.cams_from_rig.numpy())
    assert not torch.equal(ts.rig_poses, tp.rig_poses)


def _config_scene(mod, rng_seed=0):
    """tests/test_prior_ba_rectification.py:95's rig scene: 2 cameras, 4
    snapshots, 100 points, camera-2 poses perturbed."""
    rng = np.random.default_rng(rng_seed)
    cams_from_rig = np.stack([np.array([1, 0, 0, 0, 0, 0, 0.0]),
                              np.array([1, 0, 0, 0, 0.5, 0, 0.0])])
    f = 400.0
    rec = mod.Reconstruction()
    for c in range(2):
        rec.add_camera(mod.Camera(camera_id=c + 1, model_id=0, width=640,
                                  height=480,
                                  params=np.array([f, 320.0, 240.0])))
    X = rng.uniform(-2, 2, (100, 3))
    X[:, 2] += 6
    iid = 1
    for s in range(4):
        rig_pose = np.array([1, 0, 0, 0, s * 0.4 - 0.8, 0, 0.0])
        for c in range(2):
            pose = np.asarray(jrigid3.compose(
                jnp.asarray(cams_from_rig[c], jnp.float32),
                jnp.asarray(rig_pose, jnp.float32))).astype(np.float64)
            rec.add_image(mod.Image(
                image_id=iid, name=f"cam{c + 1}/frame{s:03d}.png",
                camera_id=c + 1, cam_from_world=pose,
                xys=np.zeros((100, 2)),
                point3D_ids=np.full(100, -1, np.int64)))
            iid += 1
    for m in range(100):
        track = []
        for img_id, im in rec.images.items():
            pc = np.asarray(jrigid3.apply(
                jnp.asarray(im.cam_from_world, jnp.float32),
                jnp.asarray(X[m], jnp.float32)))
            if pc[2] <= 0.5:
                continue
            im.xys[m] = f * pc[:2] / pc[2] + np.array([320.0, 240.0])
            track.append((img_id, m))
        if len(track) >= 2:
            rec.add_point3D(X[m], track)
    for im in rec.images.values():
        if im.camera_id == 2:
            im.cam_from_world = im.cam_from_world + np.concatenate(
                [np.zeros(4), rng.normal(0, 0.02, 3)])
    return rec


def _write_config(path):
    config = [{
        "ref_camera_id": 1,
        "cameras": [
            {"camera_id": 1, "image_prefix": "cam1/",
             "cam_from_rig_rotation": [1, 0, 0, 0],
             "cam_from_rig_translation": [0, 0, 0]},
            {"camera_id": 2, "image_prefix": "cam2/",
             "cam_from_rig_rotation": [1, 0, 0, 0],
             "cam_from_rig_translation": [0.5, 0, 0]},
        ],
    }]
    with open(path, "w") as fp:
        json.dump(config, fp)


def test_load_rig_config_matches_jax(tmp_path):
    jr, tr = _both(_config_scene)
    cfg = str(tmp_path / "rig_config.json")
    _write_config(cfg)
    (jrig,), (trig,) = jrt.load_rig_config(cfg, jr), trt.load_rig_config(
        cfg, tr)
    assert trig.snapshots == jrig.snapshots
    assert len(trig.snapshots) == 4
    assert all(len(s) == 2 for s in trig.snapshots)
    assert trig.ref_camera_id == jrig.ref_camera_id == 1
    for c in (1, 2):
        np.testing.assert_array_equal(trig.cams_from_rig[c],
                                      jrig.cams_from_rig[c])


def test_run_rig_bundle_adjustment_matches_jax(tmp_path, monkeypatch):
    jr, tr = _both(_config_scene)
    cfg = str(tmp_path / "rig_config.json")
    _write_config(cfg)
    jrt.run_rig_bundle_adjustment(jr, cfg)
    # the port's default (block-Jacobi CG) by outcome: the rig constraint
    out = _config_scene(trec)
    stats = {}
    trt.run_rig_bundle_adjustment(out, cfg, device="cpu", stats=stats)
    assert stats["lm_iterations"] == 30
    by_name = {im.name: im for im in out.images.values()}
    for s in range(4):
        im1 = by_name[f"cam1/frame{s:03d}.png"]
        im2 = by_name[f"cam2/frame{s:03d}.png"]
        rel = np.asarray(jrigid3.compose(
            jnp.asarray(im2.cam_from_world, jnp.float32),
            jrigid3.inverse(jnp.asarray(im1.cam_from_world, jnp.float32))))
        np.testing.assert_allclose(rel[4:], [0.5, 0, 0], atol=5e-3)
    # with JAX's unpreconditioned CG the port follows JAX's solve
    monkeypatch.setattr(trba, "RigBAOptions", functools.partial(
        trba.RigBAOptions, block_jacobi=False))
    trt.run_rig_bundle_adjustment(tr, cfg, device="cpu")
    for iid, im in tr.images.items():
        np.testing.assert_allclose(im.cam_from_world,
                                   jr.images[iid].cam_from_world, atol=5e-3)
