"""The port's warps, undistortion and rectification against the JAX package,
on the CPU.

Held on the same numpy-seeded inputs: bilinear sampling and both warps
(1e-5); `undistort_camera` for PINHOLE, SIMPLE_RADIAL, OPENCV and
OPENCV_FISHEYE (size exact, parameters 1e-4 relative); `undistort_image`
(1e-4 on [0, 1]); `undistort_reconstruction` (observations 1e-3 px); the
files of `run_undistorter` and of the PMVS and CMP-MVS exporters (the same
names; models, P matrices and vis.dat 1e-6; images one 8-bit level);
rectification (homographies 1e-5; the warped pair 1e-4, since the
packages' f32 inverses of a general H differ by ~4e-6).
"""

import os

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from colmap_tpu.image import rectification as jrect
from colmap_tpu.image import undistortion as jund
from colmap_tpu.image import warp as jwarp
from colmap_tpu.scene import reconstruction as jrecon
from colmap_tpu.scene import reconstruction_io as jio
from colmap_tpu.scene import synthetic_images as jsynth
from colmap_tpu_torch.image import rectification as trect
from colmap_tpu_torch.image import undistortion as tund
from colmap_tpu_torch.image import warp as twarp
from colmap_tpu_torch.scene import reconstruction as trecon
from colmap_tpu_torch.scene import reconstruction_io as tio
from colmap_tpu_torch.sensor import bitmap
from colmap_tpu_torch.sensor import models as tmodels

torch.set_num_threads(2)

# (model, params, width, height)
CAMERAS = {
    "PINHOLE": (1, [150.0, 140.0, 81.0, 59.0], 160, 120),
    "SIMPLE_RADIAL": (2, [140.0, 80.0, 60.0, -0.12], 160, 120),
    "OPENCV": (4, [150.0, 145.0, 79.0, 61.0, -0.1, 0.02, 0.001, -0.002],
               160, 120),
    "OPENCV_FISHEYE": (5, [120.0, 118.0, 80.0, 60.0, 0.05, -0.01, 0.002,
                           0.0], 160, 120),
}


def _cameras(name, camera_id=1):
    model, params, w, h = CAMERAS[name]
    kw = dict(camera_id=camera_id, model_id=model, width=w, height=h,
              params=np.array(params, np.float64))
    return jrecon.Camera(**kw), trecon.Camera(**kw)


def _smooth_image(rng, h, w):
    """Noise upsampled bilinearly 8x: an intensity gradient of ~0.02 per
    pixel, so that the ~1e-6 relative difference between the packages' f32
    matrix inverses (LAPACK paths) moves a sample's value by ~1e-6."""
    coarse = rng.uniform(0, 1, (h // 8 + 2, w // 8 + 2))
    return ndimage.zoom(coarse, 8, order=1)[:h, :w].astype(np.float32)


@pytest.mark.parametrize("channels", [None, 3])
def test_bilinear_sample_matches_jax(channels):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (30, 40) + ((channels,) if channels else ())
                      ).astype(np.float32)
    ys = rng.uniform(-3, 33, (17, 9)).astype(np.float32)
    xs = rng.uniform(-3, 43, (17, 9)).astype(np.float32)
    ref = np.asarray(jwarp.bilinear_sample(jnp.asarray(img), jnp.asarray(ys),
                                           jnp.asarray(xs), fill=0.25))
    got = twarp.bilinear_sample(torch.as_tensor(img), torch.as_tensor(ys),
                                torch.as_tensor(xs), fill=0.25).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("H", [
    [[2.0, 0, 3.0], [0, 0.5, 5.0], [0, 0, 1]],
    [[1.0, 0, 0], [0, 1.0, 0], [2.0 ** -9, -(2.0 ** -10), 1]]])
def test_warp_with_homography_matches_jax(H):
    """An affine and a projective H whose inverses are exact in f32, so
    both packages warp with the same H^-1 (a general f32 inverse differs
    between LAPACK paths by ~1e-6 relative, which moves a sample by
    ~5e-5 px at these coordinates)."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (40, 50)).astype(np.float32)
    H = np.asarray(H, np.float32)
    jinv = np.asarray(jnp.linalg.inv(jnp.asarray(H)))
    np.testing.assert_array_equal(
        torch.linalg.inv(torch.as_tensor(H)).numpy(), jinv)
    ref = np.asarray(jwarp.warp_with_homography(jnp.asarray(img),
                                                jnp.asarray(H), (36, 44)))
    got = twarp.warp_with_homography(torch.as_tensor(img), torch.as_tensor(H),
                                     (36, 44)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_warp_between_cameras_matches_jax():
    rng = np.random.default_rng(2)
    jcam, tcam = _cameras("SIMPLE_RADIAL")
    img = rng.uniform(0, 1, (tcam.height, tcam.width)).astype(np.float32)
    pin = [1, [130.0, 130.0, 80.0, 60.0]]
    ref = np.asarray(jwarp.warp_between_cameras(
        jnp.asarray(img), jcam.model_id, jnp.asarray(jcam.padded_params()),
        pin[0], jnp.asarray(tmodels.pad_params(pin[1])), (110, 150)))
    got = twarp.warp_between_cameras(
        torch.as_tensor(img), tcam.model_id,
        torch.as_tensor(tcam.padded_params()), pin[0],
        torch.as_tensor(tmodels.pad_params(pin[1])), (110, 150)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CAMERAS))
@pytest.mark.parametrize("blank,max_size", [(0.0, -1), (0.5, 100)])
def test_undistort_camera_matches_jax(name, blank, max_size):
    jcam, tcam = _cameras(name)
    ref = jund.undistort_camera(jund.UndistortCameraOptions(
        blank_pixels=blank, max_image_size=max_size), jcam)
    got = tund.undistort_camera(tund.UndistortCameraOptions(
        blank_pixels=blank, max_image_size=max_size), tcam, device="cpu")
    assert (got.model_id, got.width, got.height) == (
        ref.model_id, ref.width, ref.height)
    np.testing.assert_allclose(got.params, ref.params, rtol=1e-4)


@pytest.mark.parametrize("name", ["SIMPLE_RADIAL", "OPENCV_FISHEYE"])
def test_undistort_image_matches_jax(name):
    jcam, tcam = _cameras(name)
    img = _smooth_image(np.random.default_rng(3), tcam.height, tcam.width)
    ref, rcam = jund.undistort_image(jund.UndistortCameraOptions(), img, jcam)
    got, gcam = tund.undistort_image(tund.UndistortCameraOptions(), img, tcam,
                                     device="cpu")
    assert got.shape == ref.shape
    np.testing.assert_allclose(gcam.params, rcam.params, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def _models(with_points=True, name="SIMPLE_RADIAL", n_images=3, seed=4):
    """The same reconstruction in both packages' classes: posed images with
    random observations (and, optionally, points with tracks)."""
    rng = np.random.default_rng(seed)
    jcam, tcam = _cameras(name)
    recs = (jrecon.Reconstruction(), trecon.Reconstruction())
    for rec, cam, mod in zip(recs, (jcam, tcam), (jrecon, trecon)):
        rec.add_camera(cam)
    for i in range(n_images):
        q = rng.normal(size=4) * np.array([1.0, 0.05, 0.05, 0.05])
        q[0] = abs(q[0]) + 1.0
        pose = np.concatenate([q / np.linalg.norm(q),
                               rng.normal(size=3) * 0.3])
        xys = rng.uniform([0, 0], [tcam.width, tcam.height], (6, 2))
        for rec, mod in zip(recs, (jrecon, trecon)):
            img = mod.Image(image_id=i + 1, name=f"image{i:04d}.png",
                            camera_id=1, cam_from_world=pose.copy())
            img.xys = xys.copy()
            img.point3D_ids = np.full(len(xys), -1, np.int64)
            rec.add_image(img)
    if with_points:
        for k in range(3):
            xyz = rng.normal(size=3) + [0, 0, 4.0]
            track = [(i + 1, k) for i in range(n_images)]
            for rec in recs:
                rec.add_point3D(xyz, track)
    return recs


def test_undistort_reconstruction_matches_jax():
    jrec, trec = _models()
    ref = jund.undistort_reconstruction(jund.UndistortCameraOptions(), jrec)
    got = tund.undistort_reconstruction(tund.UndistortCameraOptions(), trec,
                                        device="cpu")
    assert got.cameras[1].model_id == ref.cameras[1].model_id
    np.testing.assert_allclose(got.cameras[1].params, ref.cameras[1].params,
                               rtol=1e-4)
    for iid in ref.images:
        np.testing.assert_allclose(got.images[iid].xys, ref.images[iid].xys,
                                   atol=1e-3)
    # the input is left as it was
    np.testing.assert_array_equal(trec.images[1].xys, jrec.images[1].xys)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_images_close(a, b):
    da = bitmap.read_bitmap(a).data
    db = bitmap.read_bitmap(b).data
    assert da.shape == db.shape
    # one 8-bit level: rounding at .5 may go either way
    np.testing.assert_allclose(da, db, atol=1.01 / 255)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("und_images"))
    rng = np.random.default_rng(5)
    for i in range(3):
        img = (_smooth_image(rng, 120, 160) * 255).astype(np.uint8)
        bitmap.write_bitmap(os.path.join(d, f"image{i:04d}.png"), img)
    return d


def test_run_undistorter_matches_jax(tmp_path, image_dir):
    jrec, trec = _models()
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jund.run_undistorter(jrec, image_dir, jout)
    urec = tund.run_undistorter(trec, image_dir, tout, device="cpu")
    assert _files(tout) == _files(jout)
    ref = jio.read_model(os.path.join(jout, "sparse"))
    got = tio.read_model(os.path.join(tout, "sparse"))
    assert got.cameras[1].model_id == ref.cameras[1].model_id
    assert (got.cameras[1].width, got.cameras[1].height) == (
        ref.cameras[1].width, ref.cameras[1].height)
    np.testing.assert_allclose(got.cameras[1].params, ref.cameras[1].params,
                               rtol=1e-6)
    assert sorted(got.images) == sorted(ref.images)
    for iid in ref.images:
        np.testing.assert_allclose(got.images[iid].cam_from_world,
                                   ref.images[iid].cam_from_world, atol=1e-6)
        # the observations were undistorted in f32 by each package
        np.testing.assert_allclose(got.images[iid].xys, ref.images[iid].xys,
                                   atol=1e-3)
    assert len(got.points3D) == len(ref.points3D) == len(urec.points3D)
    for name in _files(os.path.join(jout, "images")):
        _assert_images_close(os.path.join(jout, "images", name),
                             os.path.join(tout, "images", name))


def _numbers(path):
    out = []
    with open(path) as f:
        for tok in f.read().split():
            try:
                out.append(float(tok))
            except ValueError:
                pass
    return out


def test_pmvs_and_cmp_mvs_exports_match_jax(tmp_path, image_dir):
    jrec, trec = _models()
    for jfn, tfn in ((jund.run_pmvs_undistorter, tund.run_pmvs_undistorter),
                     (jund.run_cmp_mvs_undistorter,
                      tund.run_cmp_mvs_undistorter)):
        jout = str(tmp_path / f"jax_{jfn.__name__}")
        tout = str(tmp_path / f"port_{jfn.__name__}")
        jfn(jrec, image_dir, jout)
        tfn(trec, image_dir, tout, device="cpu")
        names = _files(jout)
        assert _files(tout) == names
        for name in names:
            a, b = os.path.join(jout, name), os.path.join(tout, name)
            if name.endswith(".jpg"):
                da, db = (bitmap.read_bitmap(p).data for p in (a, b))
                # JPEG re-encodes: equal inputs within one level stay close
                assert np.abs(da - db).mean() < 2.0 / 255
            elif name.endswith(("vis.dat", "option-all")):
                assert open(a).read() == open(b).read()
            else:
                assert open(a).readline() == open(b).readline() == "CONTOUR\n"
                np.testing.assert_allclose(_numbers(b), _numbers(a),
                                           rtol=1e-6, atol=1e-6)


def test_rectification_matches_jax():
    rng = np.random.default_rng(6)
    K1 = np.array([[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1]])
    K2 = np.array([[155.0, 0, 78], [0, 152.0, 61], [0, 0, 1]])
    p1 = np.array([1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    q = np.array([1.0, 0.02, -0.05, 0.01])
    p2 = np.concatenate([q / np.linalg.norm(q), [-0.5, 0.02, 0.05]])
    for a, b in zip(trect.rectify_stereo_pair(K1, K2, p1, p2),
                    jrect.rectify_stereo_pair(K1, K2, p1, p2)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    img1 = _smooth_image(rng, 120, 160)
    img2 = _smooth_image(rng, 120, 160)
    r1, r2, info = jrect.rectify_images(img1, img2, K1, K2, p1, p2)
    g1, g2, ginfo = trect.rectify_images(img1, img2, K1, K2, p1, p2,
                                         device="cpu")
    # the warps invert the f32 cast of a general H, and the packages' f32
    # inverses differ by up to ~4e-6 (LAPACK paths): ~5e-4 px at these
    # coordinates, so the images are held to 1e-4 (the warp itself is held
    # to 1e-5 above, with exact inverses)
    np.testing.assert_allclose(g1, r1, atol=1e-4)
    np.testing.assert_allclose(g2, r2, atol=1e-4)
    assert ginfo["baseline"] == pytest.approx(info["baseline"], rel=1e-5)


def test_jax_room_renderer_is_the_ports():
    """The parity tests of this slice render with either package's copy."""
    from colmap_tpu_torch.scene import synthetic_images as tsynth

    o = dict(num_images=2, width=64, height=48, focal=56.0, seed=2)
    a = jsynth.render_room_dataset(jsynth.RoomDatasetOptions(**o),
                                   return_depth=True)
    b = tsynth.render_room_dataset(tsynth.RoomDatasetOptions(**o),
                                   return_depth=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
