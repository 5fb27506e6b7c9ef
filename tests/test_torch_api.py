"""The port's pycolmap-style API (colmap_tpu_torch.api) on the CPU, held
against the JAX package's API (colmap_tpu.api) on the same numpy inputs
and, by outcome, against the truth, as tests/test_api_extras.py and
tests/test_cli_tools.py hold the JAX package's: absolute pose, the
two-view bindings, EXIF GPS, the dense workspace cache, bundle
adjustment; and the bindings those files do not cover: rig absolute pose,
robust alignment and merging, the Sim3 pose graph.

Every estimator binding returns JAX's keys, each value with JAX's type,
dtype and shape. The two packages draw their RANSAC samples from
different generators, so their results are held against each other
within the tolerances PERF.md lists for the underlying estimators:
absolute and generalized absolute pose within 0.5 deg and 0.02 of the
spacing of the truth and of each other, inlier masks agreeing on >= 95%;
E and H at unit norm within 1e-4 of each other and F within 1e-3 (both
refit the exact model from noise-free inliers in float32: measured
6e-6, 8e-6 and 1.2e-4); bundle adjustment poses and points within
1e-4; robust alignment within 1e-5 and merged points within 1e-5; the
pose graph within 1e-4. Against the truth: the JAX tests' own bounds,
and for the bindings they lack, alignment centres within 1e-3 of a
unit-scale scene and the pose graph's mean edge residual below 0.05
(the JAX hierarchical test's).
"""

import copy
import os
from fractions import Fraction

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from colmap_tpu import api as japi
from colmap_tpu.scene import reconstruction as jrecon
from colmap_tpu_torch import api
from colmap_tpu_torch.estimators.similarity_transform import (
    compare_reconstructions)
from colmap_tpu_torch.geometry import rigid3, rotation as rot, sim3
from colmap_tpu_torch.scene import synthetic
from colmap_tpu_torch.scene.reconstruction import Camera
from test_torch_hierarchical import _to_jax

torch.set_num_threads(2)


def _camera(cls=Camera):
    return cls(camera_id=1, model_id=1, width=640, height=480,
               params=np.array([500.0, 500.0, 320.0, 240.0]))


def _quat(R):
    return rot.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32)
                              ).numpy().astype(np.float64)


def _angle_deg(q1, q2):
    d = abs(float(np.dot(q1[:4] / np.linalg.norm(q1[:4]),
                         q2[:4] / np.linalg.norm(q2[:4]))))
    return np.degrees(2 * np.arccos(min(d, 1.0)))


def _center(pose):
    return rigid3.projection_center(torch.as_tensor(pose)).numpy()


def _same_layout(t, j):
    """The port's result dict has JAX's keys, and each value JAX's type,
    dtype and shape."""
    assert set(t) == set(j), (sorted(t), sorted(j))
    for k, v in j.items():
        if isinstance(v, np.ndarray):
            assert isinstance(t[k], np.ndarray), k
            assert (t[k].dtype, t[k].shape) == (v.dtype, v.shape), k
        else:
            assert type(t[k]) is type(v), (k, type(t[k]), type(v))


def _masks_agree(a, b):
    return float((a == b).mean())


def test_absolute_pose_estimation_binding(rng):
    Rm = Rotation.from_rotvec(rng.normal(0, 0.2, 3)).as_matrix()
    t = rng.normal(0, 1, 3)
    t[2] += 5
    X = rng.uniform(-2, 2, (80, 3))
    pc = X @ Rm.T + t
    xy = pc[:, :2] / pc[:, 2:] * 500.0 + np.array([320.0, 240.0])
    xy[:15] += rng.normal(0, 40, (15, 2))  # outliers
    res = api.absolute_pose_estimation(xy, X, _camera(), max_error_px=4.0,
                                       device="cpu")
    ref = japi.absolute_pose_estimation(xy, X, _camera(jrecon.Camera),
                                        max_error_px=4.0)
    _same_layout(res, ref)
    for r in (res, ref):
        assert r["success"]
        assert r["num_inliers"] >= 60
        assert not r["inlier_mask"][:15].all()
        assert _angle_deg(r["cam_from_world"], _quat(Rm)) < 0.5
        np.testing.assert_allclose(r["cam_from_world"][4:], t, atol=0.02)
    assert _angle_deg(res["cam_from_world"], ref["cam_from_world"]) < 0.5
    np.testing.assert_allclose(_center(res["cam_from_world"]),
                               _center(ref["cam_from_world"]), atol=0.02)
    assert _masks_agree(res["inlier_mask"], ref["inlier_mask"]) >= 0.95


def _two_view_scene(rng):
    Rm = Rotation.from_rotvec([0, 0.08, 0]).as_matrix()
    t = np.array([1.0, 0.1, 0.05])
    X = rng.uniform(-2, 2, (120, 3))
    X[:, 2] += 6
    pc2 = X @ Rm.T + t
    xy1 = (X[:, :2] / X[:, 2:]) * 500 + [320, 240]
    xy2 = (pc2[:, :2] / pc2[:, 2:]) * 500 + [320, 240]
    # planar points, for the homography
    Xp = X.copy()
    Xp[:, 2] = 6.0
    pc2p = Xp @ Rm.T + t
    p1 = (Xp[:, :2] / Xp[:, 2:]) * 500 + [320, 240]
    p2 = (pc2p[:, :2] / pc2p[:, 2:]) * 500 + [320, 240]
    return Rm, t, xy1, xy2, p1, p2


def _unit(M):
    """A matrix defined up to scale and sign, at unit norm and a fixed
    sign."""
    M = M / np.linalg.norm(M)
    return M * np.sign(M.flat[np.argmax(np.abs(M))])


def test_two_view_bindings(rng):
    Rm, t, xy1, xy2, p1, p2 = _two_view_scene(rng)
    res = api.essential_matrix_estimation(xy1, xy2, _camera(), _camera(),
                                          device="cpu")
    ref = japi.essential_matrix_estimation(xy1, xy2, _camera(jrecon.Camera),
                                           _camera(jrecon.Camera))
    _same_layout(res, ref)
    assert res["config"] == ref["config"]
    for r in (res, ref):
        assert r["success"] and r["num_inliers"] > 100
        assert _angle_deg(r["cam2_from_cam1"], _quat(Rm)) < 0.5
        t_est = r["cam2_from_cam1"][4:]
        assert np.dot(t_est / np.linalg.norm(t_est),
                      t / np.linalg.norm(t)) > 0.99
    assert _angle_deg(res["cam2_from_cam1"], ref["cam2_from_cam1"]) < 0.5
    np.testing.assert_allclose(_unit(res["E"]), _unit(ref["E"]), atol=1e-4)
    assert _masks_agree(res["inlier_mask"], ref["inlier_mask"]) >= 0.95

    resF = api.fundamental_matrix_estimation(xy1, xy2, device="cpu")
    refF = japi.fundamental_matrix_estimation(xy1, xy2)
    _same_layout(resF, refF)
    assert resF["config"] == refF["config"]
    h1 = np.c_[xy1, np.ones(len(xy1))]
    h2 = np.c_[xy2, np.ones(len(xy2))]
    for r in (resF, refF):
        assert r["num_inliers"] > 100
        err = np.abs(np.einsum("ni,ij,nj->n", h2, r["F"], h1))
        assert np.median(err) < 1e-2 * np.abs(r["F"]).max() * 500
    np.testing.assert_allclose(_unit(resF["F"]), _unit(refF["F"]), atol=1e-3)
    assert _masks_agree(resF["inlier_mask"], refF["inlier_mask"]) >= 0.95

    resH = api.homography_matrix_estimation(p1, p2, device="cpu")
    refH = japi.homography_matrix_estimation(p1, p2)
    _same_layout(resH, refH)
    assert resH["config"] == refH["config"]
    for r in (resH, refH):
        assert r["num_inliers"] > 100
        proj = np.c_[p1, np.ones(len(p1))] @ r["H"].T
        np.testing.assert_allclose(proj[:, :2] / proj[:, 2:], p2, atol=0.05)
    np.testing.assert_allclose(_unit(resH["H"]), _unit(refH["H"]), atol=1e-4)
    assert _masks_agree(resH["inlier_mask"], refH["inlier_mask"]) >= 0.95


def test_exif_gps_roundtrip(tmp_path):
    from PIL import Image

    from colmap_tpu.sensor import bitmap as jbm
    from colmap_tpu_torch.sensor import bitmap as bm

    img = Image.fromarray(np.zeros((32, 32), np.uint8))
    exif = img.getexif()
    exif[0x8825] = {
        1: "N", 2: (Fraction(47), Fraction(22), Fraction(30)),
        3: "E", 4: (Fraction(8), Fraction(32), Fraction(15)),
        5: 0, 6: Fraction(425),
    }
    p = str(tmp_path / "gps.jpg")
    img.save(p, exif=exif)
    bmp = bm.read_bitmap(p)
    assert bmp.gps is not None
    np.testing.assert_allclose(bmp.gps[0], 47 + 22 / 60 + 30 / 3600,
                               atol=1e-6)
    np.testing.assert_allclose(bmp.gps[1], 8 + 32 / 60 + 15 / 3600,
                               atol=1e-6)
    np.testing.assert_allclose(bmp.gps[2], 425.0, atol=1e-6)
    np.testing.assert_array_equal(bmp.gps, jbm.read_bitmap(p).gps)


def test_workspace_cache(tmp_path):
    from colmap_tpu.mvs.workspace import (Workspace as JWorkspace,
                                          WorkspaceOptions as JOptions)
    from colmap_tpu_torch.mvs import depth_map as dm
    from colmap_tpu_torch.mvs.workspace import Workspace, WorkspaceOptions
    from colmap_tpu_torch.sensor import bitmap as bm

    ws = str(tmp_path)
    os.makedirs(os.path.join(ws, "images"))
    for sub in ("depth_maps", "normal_maps"):
        os.makedirs(os.path.join(ws, "stereo", sub))
    rng = np.random.default_rng(0)
    names = {}
    for i in range(4):
        name = f"im{i}.png"
        names[i + 1] = name
        bm.write_bitmap(os.path.join(ws, "images", name),
                        rng.uniform(0, 1, (40, 50)).astype(np.float32))
        dm.DepthMap(rng.uniform(1, 5, (40, 50)).astype(np.float32)).write(
            os.path.join(ws, "stereo", "depth_maps", f"{name}.geometric.bin"))
        dm.NormalMap(rng.normal(0, 1, (40, 50, 3)).astype(np.float32)).write(
            os.path.join(ws, "stereo", "normal_maps", f"{name}.geometric.bin"))
    cap = 3 * 40 * 50 * 4 * 3
    w = Workspace(WorkspaceOptions(workspace_path=ws, max_cache_bytes=cap),
                  names)
    jw = JWorkspace(JOptions(workspace_path=ws, max_cache_bytes=cap), names)
    for i in range(1, 5):
        assert w.has_depth_map(i) and jw.has_depth_map(i)
        assert w.depth_map(i).shape == (40, 50)
        assert w.normal_map(i).shape == (40, 50, 3)
        assert w.bitmap(i).shape == (40, 50)
        for get in ("depth_map", "normal_map", "bitmap"):
            np.testing.assert_array_equal(np.asarray(getattr(w, get)(i)),
                                          np.asarray(getattr(jw, get)(i)))
    assert w.num_bytes_cached <= cap
    assert w.num_bytes_cached == jw.num_bytes_cached
    assert w.depth_map(4) is w.depth_map(4)


@pytest.fixture(scope="module")
def gt_model():
    from colmap_tpu_torch.scene.database import Database

    db = Database(":memory:")
    gt = synthetic.synthesize_dataset(synthetic.SyntheticDatasetOptions(
        num_cameras=1, num_images=8, num_points3D=150, seed=4), db)
    db.close()
    return gt


def test_api_bundle_adjustment(gt_model, rng):
    noise = rng.normal(0, 0.02, (len(gt_model.points3D), 3))
    rec = copy.deepcopy(gt_model)
    for k, pid in enumerate(sorted(rec.points3D)):
        rec.points3D[pid].xyz = rec.points3D[pid].xyz + noise[k]
    jrec = _to_jax(rec)
    out = api.bundle_adjustment(rec, device="cpu")
    jout = japi.bundle_adjustment(jrec)
    for r in (out, jout):
        cmp = compare_reconstructions(r, gt_model, device="cpu")
        assert cmp["max_rotation_error_deg"] < 0.2
        errs = [np.linalg.norm(r.points3D[p].xyz - gt_model.points3D[p].xyz)
                for p in r.points3D]
        assert np.median(errs) < 5e-3
    assert out.registered_image_ids() == jout.registered_image_ids()
    assert out.points3D.keys() == jout.points3D.keys()
    for iid in out.registered_image_ids():
        np.testing.assert_allclose(out.images[iid].cam_from_world,
                                   jout.images[iid].cam_from_world,
                                   atol=1e-4)
    for pid, pt in jout.points3D.items():
        np.testing.assert_allclose(out.points3D[pid].xyz, pt.xyz, atol=1e-4)


def test_rig_absolute_pose_estimation(rng):
    def cameras(cls):
        return [cls(camera_id=k + 1, model_id=1, width=640, height=480,
                    params=np.array([400.0 + 20 * k, 400.0 + 20 * k, 320.0,
                                     240.0])) for k in range(3)]

    cams = cameras(Camera)
    cams_from_rig = []
    for k, yaw in enumerate((0.0, 0.6, -0.6)):
        R = Rotation.from_rotvec([0, yaw, 0]).as_matrix()
        c = np.array([0.2 * (k - 1), 0.0, 0.0])  # centres in the rig
        cams_from_rig.append(np.r_[_quat(R), -R @ c])
    cams_from_rig = np.array(cams_from_rig, np.float32)
    R_rw = Rotation.from_rotvec(rng.normal(0, 0.2, 3)).as_matrix()
    rig_from_world = np.r_[_quat(R_rw), rng.normal(0, 0.5, 3)]
    n = 150
    cam_idx = rng.integers(0, 3, n)
    X, xy = [], []
    for k in cam_idx:
        # a point 4-8 in front of camera k, in the world frame
        pc = np.r_[rng.uniform(-2, 2, 2), rng.uniform(4, 8)]
        cam_from_world = rigid3.compose(
            torch.as_tensor(cams_from_rig[k], dtype=torch.float64),
            torch.as_tensor(rig_from_world))
        Xw = rigid3.apply(rigid3.inverse(cam_from_world),
                          torch.as_tensor(pc)).numpy()
        X.append(Xw)
        f = cams[k].params[0]
        xy.append(pc[:2] / pc[2] * f + [320.0, 240.0])
    X, xy = np.array(X), np.array(xy)
    xy[:30] += rng.normal(0, 50, (30, 2))  # 20% outliers
    res = api.rig_absolute_pose_estimation(xy, X, cam_idx, cams_from_rig,
                                           cams, max_error_px=4.0,
                                           device="cpu")
    ref = japi.rig_absolute_pose_estimation(xy, X, cam_idx, cams_from_rig,
                                            cameras(jrecon.Camera),
                                            max_error_px=4.0)
    _same_layout(res, ref)
    c_gt = _center(rig_from_world)
    for r in (res, ref):
        assert r["success"] and r["num_inliers"] >= 110
        assert _angle_deg(r["rig_from_world"], rig_from_world) < 0.5
        assert np.linalg.norm(_center(r["rig_from_world"]) - c_gt) < 0.02
    assert _angle_deg(res["rig_from_world"], ref["rig_from_world"]) < 0.5
    np.testing.assert_allclose(_center(res["rig_from_world"]),
                               _center(ref["rig_from_world"]), atol=0.02)
    assert _masks_agree(res["inlier_mask"], ref["inlier_mask"]) >= 0.95


def _halves(gt, src):
    """Two overlapping halves of `gt`, the second taken from `src`."""
    ids = gt.registered_image_ids()
    halves = []
    for keep, base in ((set(ids[:5]), gt), (set(ids[3:]), src)):
        h = copy.deepcopy(base)
        for iid in ids:
            if iid not in keep:
                h.images[iid].cam_from_world = None
        for pid in list(h.points3D):
            track = [o for o in h.points3D[pid].track if o[0] in keep]
            if len(track) < 2:
                h.delete_point3D(pid)
            else:
                h.points3D[pid].track = track
        halves.append(h)
    return halves


def test_align_and_merge_reconstructions(gt_model):
    s = torch.tensor([1.7, 0.9, 0.1, -0.2, 0.3, 1.0, -1.0, 2.0],
                     dtype=torch.float64)
    s[1:5] /= torch.linalg.norm(s[1:5])
    src = copy.deepcopy(gt_model)
    src.transform(s.numpy())
    found = api.align_reconstructions(src, gt_model, device="cpu")
    jfound = japi.align_reconstructions(_to_jax(src), _to_jax(gt_model))
    assert found is not None and jfound is not None
    np.testing.assert_allclose(found, jfound, atol=1e-5)
    moved = copy.deepcopy(src)
    moved.transform(np.asarray(found, np.float64))
    for iid in gt_model.registered_image_ids():
        np.testing.assert_allclose(moved.images[iid].projection_center(),
                                   gt_model.images[iid].projection_center(),
                                   atol=1e-3)
    # merge two overlapping halves, the second in the moved frame
    ids = gt_model.registered_image_ids()
    dst, part = _halves(gt_model, src)
    jdst, jpart = _to_jax(dst), _to_jax(part)
    assert api.merge_reconstructions(dst, part, device="cpu")
    assert japi.merge_reconstructions(jdst, jpart)
    assert dst.registered_image_ids() == jdst.registered_image_ids() == ids
    assert dst.points3D.keys() == jdst.points3D.keys()
    for pid, pt in jdst.points3D.items():
        assert dst.points3D[pid].track == pt.track
        np.testing.assert_allclose(dst.points3D[pid].xyz, pt.xyz, atol=1e-5)
    cmp = compare_reconstructions(dst, gt_model, device="cpu")
    assert cmp["max_rotation_error_deg"] < 0.05
    assert cmp["max_center_error"] < 1e-3


def test_optimize_sim3_pose_graph():
    rng = np.random.default_rng(0)
    n = 6

    def T(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    gt = [np.array([1, 1, 0, 0, 0, 0, 0, 0], np.float32)]
    for _ in range(1, n):
        q = rot.quat_from_axis_angle(T(rng.normal(0, 0.3, 3))).numpy()
        gt.append(np.concatenate([[np.exp(rng.normal(0, 0.1))], q,
                                  rng.normal(0, 1.0, 3)]).astype(np.float32))
    gt = np.stack(gt)

    def noisy_rel(i, j, sigma=0.01):
        m = sim3.compose(sim3.inverse(T(gt[j])), T(gt[i]))
        qn = rot.quat_from_axis_angle(T(rng.normal(0, sigma, 3)))
        return sim3.compose(m, sim3.make(
            torch.exp(T(rng.normal(0, sigma))), qn,
            T(rng.normal(0, sigma, 3)))).numpy()

    edges = np.array([(k, (k + 1) % n) for k in range(n)])
    meas = np.stack([noisy_rel(i, j) for i, j in edges])
    init = [gt[0]]
    for k in range(1, n):  # chained, as greedy merging places clusters
        init.append(sim3.compose(T(init[k - 1]),
                                 sim3.inverse(T(meas[k - 1]))).numpy())
    init = np.stack(init)
    refined = api.optimize_sim3_pose_graph(init, edges, meas, device="cpu")
    ref = japi.optimize_sim3_pose_graph(init, edges, meas)
    assert refined.shape == np.asarray(ref).shape
    np.testing.assert_allclose(refined, ref, atol=1e-4)

    def consistency(S):
        errs = []
        for (i, j), m in zip(edges, meas):
            pred = sim3.compose(sim3.inverse(T(S[j])), T(S[i]))
            e = sim3.compose(sim3.inverse(T(m)), pred).numpy()
            errs.append(np.linalg.norm(e[5:8])
                        + abs(np.log(max(e[0], 1e-9))))
        return np.array(errs)

    before, after = consistency(init), consistency(refined)
    assert after.max() < before.max()
    assert after.mean() < 0.05
