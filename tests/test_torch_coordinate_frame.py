"""The port's L1 solver, line detection and coordinate-frame estimation
against the JAX package's, on the CPU.

Tolerances: solve_lad 1e-5 of the solution's largest entry (float32 IRLS
on both sides); line segments
identical (the same OpenCV calls in the same order); gravity 1e-12 (the
same float64 numpy); the RANSAC axis fit and the Manhattan frame on
tests/test_coordinate_frame.py's grid room 1e-5 (the same 512 numpy
draws, scored in one batched product); the aligned model's poses 1e-5.
Without OpenCV the port raises ImportError where the JAX package returns
no segments.
"""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from colmap_tpu.estimators import coordinate_frame as jcf
from colmap_tpu.image.line import detect_line_segments as jdetect
from colmap_tpu.optim import least_absolute_deviations as jlad
from colmap_tpu.sensor import bitmap as jbitmap
from colmap_tpu_torch.estimators import coordinate_frame as tcf
from colmap_tpu_torch.image.line import detect_line_segments as tdetect
from colmap_tpu_torch.optim import least_absolute_deviations as tlad
from test_coordinate_frame import grid_room  # noqa: F401 (fixture)
from test_torch_prior_ba import port_rec

torch.set_num_threads(2)


def test_solve_lad_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(60, 4)).astype(np.float32)
    x_true = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    b = A @ x_true + rng.normal(0, 0.01, 60).astype(np.float32)
    b[:8] += rng.normal(0, 5.0, 8).astype(np.float32)  # gross outliers
    xj = np.asarray(jlad.solve_lad(jnp.asarray(A), jnp.asarray(b)))
    xt = tlad.solve_lad(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    # float32 IRLS: the last iterations weight the interpolated rows by
    # 1 / eps, so the two BLAS summation orders differ by ~1e-5 relative
    np.testing.assert_allclose(xt, xj, atol=1e-5 * np.abs(xj).max())
    np.testing.assert_allclose(xt, x_true, atol=0.02)


def test_line_segments_match_jax(grid_room):  # noqa: F811
    pytest.importorskip("cv2")
    rec, d = grid_room
    img = np.full((200, 200), 200, np.uint8)
    img[60:63, :] = 10
    img[:, 100:103] = 10
    ims = [img] + [jbitmap.read_bitmap(f"{d}/{im.name}").data
                   for im in list(rec.images.values())[:2]]
    for im in ims:
        js, ts = jdetect(im, 20.0), tdetect(im, 20.0)
        assert len(ts) == len(js) > 0
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.start, b.start)
            np.testing.assert_array_equal(a.end, b.end)


def test_line_segments_without_cv2_raise(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        tdetect(np.zeros((32, 32), np.uint8))


def test_gravity_matches_jax(grid_room):  # noqa: F811
    rec, _ = grid_room
    g_t = tcf.estimate_gravity_vector_from_image_orientation(port_rec(rec))
    g_j = jcf.estimate_gravity_vector_from_image_orientation(rec)
    np.testing.assert_allclose(g_t, g_j, atol=1e-12)
    assert abs(g_t[1]) > 0.95


def test_fit_axis_matches_jax():
    rng = np.random.default_rng(1)
    axis = np.array([0.0, 1.0, 0.0])
    n = rng.normal(size=(300, 3))
    n[:200] -= np.outer(n[:200] @ axis, axis)  # 200 normals _|_ the axis
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    for seed, constraint in ((0, None), (1, np.array([1.0, 0, 0]))):
        dj = jcf._fit_axis(n, seed=seed, constraint=constraint)
        dt = tcf._fit_axis(n, seed=seed, constraint=constraint,
                           device="cpu")
        np.testing.assert_allclose(dt, dj, atol=1e-5)
    assert tcf._fit_axis(n[:5], device="cpu") is None


def test_manhattan_frame_matches_jax(grid_room):  # noqa: F811
    pytest.importorskip("cv2")
    rec, d = grid_room
    Rj = jcf.estimate_manhattan_world_frame(rec, d)
    Rt = tcf.estimate_manhattan_world_frame(port_rec(rec), d, device="cpu")
    assert Rt is not None and Rj is not None
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    assert abs(Rt[1, 1]) > 0.98
    np.testing.assert_allclose(Rt @ Rt.T, np.eye(3), atol=1e-5)
    aj = jcf.align_to_manhattan_world(rec, d)
    at = tcf.align_to_manhattan_world(port_rec(rec), d, device="cpu")
    for iid, im in aj.images.items():
        np.testing.assert_allclose(at.images[iid].cam_from_world,
                                   im.cam_from_world, atol=1e-5)
