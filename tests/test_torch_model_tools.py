"""The port's model tools and SfM tools against the JAX package's, on the
CPU, on synthetic models (tests/test_prior_ba_rectification.py's
generator).

Tolerances:
- every converter (BIN, TXT, PLY, NVM, Bundler, VRML, HTML): byte-equal;
- crop, split, analyze: the same points, images and statistics;
- transform, orientation alignment: 1e-5 (the JAX package applies the
  Sim3 in float32, the port in float64);
- align_model_to_positions: the same 256 numpy draws; poses within 1e-4;
- compare: centre errors within 1e-4, rotation errors within 0.02 deg
  (float32 arccos near 1); merge: the same images and points, poses 1e-4;
- filter_points: the same points deleted; extract_colors: the same colours;
- triangulate_points: the same tracks, points within 1e-3, mean
  reprojection <= 1 px; register_images: every de-registered image back
  within 1 deg of the truth, poses within 1e-3 of JAX's.
"""

import copy
import os

import numpy as np
import pytest
import torch

from colmap_tpu.scene import synthetic as jsyn
from colmap_tpu.scene.database import Database as JDatabase
from colmap_tpu.tools import model_tools as jmt
from colmap_tpu.tools import sfm_tools as jst
from colmap_tpu_torch.geometry import rotation as trot
from colmap_tpu_torch.scene import synthetic as tsyn
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.tools import model_tools as tmt
from colmap_tpu_torch.tools import sfm_tools as tst
from test_torch_prior_ba import port_rec

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    gt = jsyn.synthesize_dataset(jsyn.SyntheticDatasetOptions(
        num_cameras=2, num_images=8, num_points3D=150, point2D_stddev=0.3,
        seed=6), JDatabase(":memory:"))
    rng = np.random.default_rng(0)
    for p in gt.points3D.values():
        p.color = rng.integers(0, 256, 3).astype(np.uint8)
        p.error = float(rng.uniform(0.1, 1.0))
    return gt, port_rec(gt)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize("kind", ["BIN", "TXT", "PLY", "NVM", "Bundler",
                                  "VRML", "HTML"])
def test_converters_byte_equal(models, tmp_path, kind):
    jr, tr = models
    for mod, rec, sub in ((jmt, jr, "jax"), (tmt, tr, "port")):
        os.makedirs(tmp_path / sub)
        path = tmp_path / sub / ("model" if kind in ("BIN", "TXT")
                                 else f"model.{kind.lower()}")
        mod.convert_model(rec, str(path), kind)
    fj, ft = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(ft) == sorted(fj) and fj
    for name in fj:
        assert ft[name] == fj[name], name


def test_crop_split_analyze_match_jax(models):
    jr, tr = models
    lo, hi = np.array([-5.0, -5, 3]), np.array([5.0, 5, 8])
    cj, ct = jmt.crop_model(jr, lo, hi), tmt.crop_model(tr, lo, hi)
    assert sorted(ct.points3D) == sorted(cj.points3D)
    assert ct.registered_image_ids() == cj.registered_image_ids()
    sj = jmt.split_model(jr, (2, 1, 2), overlap_ratio=0.1)
    st = tmt.split_model(tr, (2, 1, 2), overlap_ratio=0.1)
    assert [sorted(m.points3D) for m in st] == [sorted(m.points3D)
                                                for m in sj]
    aj, at = jmt.analyze_model(jr), tmt.analyze_model(tr)
    assert at.keys() == aj.keys()
    for k in aj:
        np.testing.assert_allclose(at[k], aj[k], rtol=1e-12, err_msg=k)


def _assert_models_close(tr, jr, atol):
    assert tr.registered_image_ids() == jr.registered_image_ids()
    for iid in jr.registered_image_ids():
        np.testing.assert_allclose(tr.images[iid].cam_from_world,
                                   jr.images[iid].cam_from_world, atol=atol)
    for pid, p in jr.points3D.items():
        np.testing.assert_allclose(tr.points3D[pid].xyz, p.xyz, atol=atol)


def test_transform_and_orientation_match_jax(models):
    jr, tr = models
    s = np.array([1.3, 0.9, 0.1, -0.2, 0.3, 0.5, -1.0, 2.0])
    s[1:5] /= np.linalg.norm(s[1:5])
    _assert_models_close(tmt.transform_model(tr, s),
                         jmt.transform_model(jr, s), 1e-5)
    _assert_models_close(tmt.align_model_orientation(tr),
                         jmt.align_model_orientation(jr), 1e-5)


def test_align_compare_merge_match_jax(models):
    jr, tr = models
    s = np.array([2.0, 0.9, 0.1, -0.2, 0.3, 1.0, -1.0, 2.0])
    s[1:5] /= np.linalg.norm(s[1:5])
    target = jmt.transform_model(jr, s)
    rng = np.random.default_rng(1)
    positions = {im.name: im.projection_center() + rng.normal(0, 0.01, 3)
                 for im in target.images.values() if im.registered}
    positions[jr.images[1].name] += 5.0  # one outlier
    aj = jmt.align_model_to_positions(jr, positions, max_error=0.1)
    at = tmt.align_model_to_positions(tr, positions, max_error=0.1,
                                      device="cpu")
    _assert_models_close(at, aj, 1e-4)

    cj = jmt.compare_models(aj, target)
    ct = tmt.compare_models(at, port_rec(target), device="cpu")
    # float32 arccos near 1 resolves angles to ~0.02 deg
    np.testing.assert_allclose(ct["max_rotation_error_deg"],
                               cj["max_rotation_error_deg"], atol=0.02)
    np.testing.assert_allclose(ct["max_center_error"],
                               cj["max_center_error"], atol=1e-4)
    assert ct["max_center_error"] < 0.1

    # merge two overlapping halves of the model
    ids = jr.registered_image_ids()
    halves = []
    for keep in (set(ids[:5]), set(ids[3:])):
        h = copy.deepcopy(jr)
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
    mj = jmt.merge_models(halves[0], halves[1])
    mt = tmt.merge_models(port_rec(halves[0]), port_rec(halves[1]),
                          device="cpu")
    assert mj is not None and mt is not None
    assert mt.registered_image_ids() == mj.registered_image_ids() == ids
    assert len(mt.points3D) == len(mj.points3D)
    for iid in ids:
        np.testing.assert_allclose(mt.images[iid].cam_from_world,
                                   mj.images[iid].cam_from_world, atol=1e-4)


def test_filter_points_and_colors_match_jax(models, tmp_path):
    jr, tr = models
    jr, tr = copy.deepcopy(jr), copy.deepcopy(tr)
    rng = np.random.default_rng(2)
    moved = rng.choice(sorted(jr.points3D), 20, replace=False)
    for pid in moved:  # some pushed off their rays, some behind cameras
        d = rng.normal(0, 0.3, 3) if pid % 2 else np.array([0, 0, -50.0])
        jr.points3D[pid].xyz = jr.points3D[pid].xyz + d
        tr.points3D[pid].xyz = tr.points3D[pid].xyz + d
    nj = jst.filter_points(jr, max_reproj_error=2.0)
    nt = tst.filter_points(tr, max_reproj_error=2.0, device="cpu")
    assert nt == nj > 0
    assert sorted(tr.points3D) == sorted(jr.points3D)

    from PIL import Image

    for im in jr.images.values():
        cam = jr.cameras[im.camera_id]
        Image.fromarray(rng.integers(0, 256, (cam.height, cam.width, 3),
                                     dtype=np.uint8)).save(
            tmp_path / im.name)
    assert (tst.extract_colors(tr, str(tmp_path))
            == jst.extract_colors(jr, str(tmp_path)) > 0)
    for pid, p in jr.points3D.items():
        np.testing.assert_array_equal(tr.points3D[pid].color, p.color)


@pytest.fixture(scope="module")
def databases():
    """The same synthetic database written by each package."""
    opts = dict(num_cameras=1, num_images=10, num_points3D=200,
                point2D_stddev=0.5, seed=4)
    jdb, tdb = JDatabase(":memory:"), Database(":memory:")
    gt = jsyn.synthesize_dataset(jsyn.SyntheticDatasetOptions(**opts), jdb)
    tsyn.synthesize_dataset(tsyn.SyntheticDatasetOptions(**opts), tdb)
    return gt, jdb, tdb


def test_triangulate_points_matches_jax(databases):
    gt, jdb, tdb = databases
    bare = copy.deepcopy(gt)
    for pid in list(bare.points3D):
        bare.delete_point3D(pid)
    oj = jst.triangulate_points(jdb, bare)
    ot = tst.triangulate_points(tdb, port_rec(bare), device="cpu")
    assert len(ot.points3D) >= 0.9 * len(gt.points3D)
    tracks_t = {tuple(sorted(p.track)): p.xyz for p in ot.points3D.values()}
    tracks_j = {tuple(sorted(p.track)): p.xyz for p in oj.points3D.values()}
    assert tracks_t.keys() == tracks_j.keys()
    for k, xyz in tracks_j.items():
        np.testing.assert_allclose(tracks_t[k], xyz, atol=1e-3)
    errs = []
    for p in ot.points3D.values():
        for iid, f in p.track:
            im = ot.images[iid]
            cam = ot.cameras[im.camera_id]
            q = torch.as_tensor(im.cam_from_world[:4])
            R = trot.quat_to_rotmat(q / q.norm()).numpy()
            pc = R @ p.xyz + im.cam_from_world[4:]
            fx, cx, cy, k = cam.params[:4]
            uv = pc[:2] / pc[2]
            uv = uv * (1 + k * (uv ** 2).sum())
            errs.append(np.linalg.norm(fx * uv + [cx, cy] - im.xys[f]))
    assert np.mean(errs) <= 1.0


def test_register_images_matches_jax(databases):
    gt, jdb, tdb = databases
    rec = copy.deepcopy(gt)
    for iid in (3, 7):
        rec.images[iid].cam_from_world = None
    oj = jst.register_images(jdb, rec)
    ot = tst.register_images(tdb, port_rec(rec), device="cpu")
    assert ot.num_registered_images() == oj.num_registered_images() == 10
    for iid in (3, 7):
        q = torch.as_tensor(ot.images[iid].cam_from_world[:4])
        ang = float(trot.quat_angle_deg(
            q, torch.as_tensor(gt.images[iid].cam_from_world[:4])))
        assert ang <= 1.0
        np.testing.assert_allclose(ot.images[iid].cam_from_world,
                                   oj.images[iid].cam_from_world, atol=1e-3)


def test_batched_eigh_in_chunks_matches_one_call(monkeypatch):
    """Triangulation's batched eigh gives the same points when the batch
    goes through cuSOLVER-sized chunks."""
    from colmap_tpu_torch.estimators import utils
    from colmap_tpu_torch.geometry.triangulation import triangulate_point

    g = torch.Generator().manual_seed(0)
    poses = torch.cat([torch.ones(50, 1), 0.05 * torch.randn(50, 3,
                                                             generator=g),
                       torch.randn(50, 3, generator=g)], 1)
    uv1, uv2 = torch.rand(2, 50, 2, generator=g)
    ident = torch.tensor([1.0, 0, 0, 0, 0, 0, 0])
    whole = triangulate_point(ident, poses, uv1, uv2)
    monkeypatch.setattr(utils, "EIGH_BATCH", 7)
    chunked = triangulate_point(ident, poses, uv1, uv2)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
