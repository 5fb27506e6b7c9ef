"""The port's SIFT (colmap_tpu_torch.features.sift) against the JAX package,
on a 320x240 synthetic_images render.

Tolerances, tightened from the first proposal to the measured agreement
with margin (PERF.md, "Parity tolerances"):
- scale-space levels within 2e-6 absolute (measured 5.4e-7): both are f32
  banded matrix products, summed in another order;
- >= 98% of the port's keypoints within 0.01 px of a JAX keypoint with the
  same orientation (measured 100%, p99 0.0014 px), relative scale
  difference <= 1e-3: a DoG extremum near the threshold or the edge test
  can flip on an f32 rounding difference;
- descriptors of matched keypoints: >= 98% of bytes equal (measured
  99.8%) and >= 99.9% within 1 uint8 level (measured 100%).
On the CPU the JAX side's approx_max_k is an exact top-k, like torch.topk.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from colmap_tpu.features import sift as jsift
from colmap_tpu.scene import synthetic_images as jsynth
from colmap_tpu_torch.features import sift as tsift
from colmap_tpu_torch.scene import synthetic_images as tsynth

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def image():
    opts = tsynth.RoomDatasetOptions(num_images=2, width=320, height=240,
                                     focal=280.0, seed=5)
    images, _, _, _ = tsynth.render_room_dataset(opts)
    # the port's renderer is a copy: same pixels as the JAX package's
    jimages, _, _, _ = jsynth.render_room_dataset(
        jsynth.RoomDatasetOptions(num_images=2, width=320, height=240,
                                  focal=280.0, seed=5))
    np.testing.assert_array_equal(images[1], jimages[1])
    return images[1]


def test_scale_space_levels(image):
    img = image.astype(np.float32) / 255.0
    jbase = jsift._upsample2(jnp.asarray(img))
    tbase = tsift._upsample2(torch.as_tensor(img))
    np.testing.assert_allclose(tbase.numpy(), np.asarray(jbase), rtol=0,
                               atol=2e-6)
    sig = (1.6 ** 2 - 1.0) ** 0.5
    jlev = np.asarray(jsift._build_octave(jsift._blur(jbase, sig), 3))
    tlev = tsift._build_octave(tsift._blur(tbase, sig), 3).numpy()
    assert tlev.shape == jlev.shape == (6, 480, 640)
    np.testing.assert_allclose(tlev, jlev, rtol=0, atol=2e-6)
    # the strip-blocked blur of long axes (> 1024 px) agrees too
    long = np.random.default_rng(0).random((1100, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tsift._blur(torch.as_tensor(long), 2.0).numpy(),
        np.asarray(jsift._blur(jnp.asarray(long), 2.0)), rtol=0, atol=1e-5)


def test_keypoints_and_descriptors(image):
    opts = jsift.SiftExtractionOptions(max_image_size=1000,
                                       max_num_features=2048)
    topts = tsift.SiftExtractionOptions(max_image_size=1000,
                                        max_num_features=2048)
    jf = jsift.extract(image, opts)
    tf = tsift.extract(image, topts, device="cpu")
    nj, nt = len(jf["xy"]), len(tf["xy"])
    assert nt > 300 and abs(nt - nj) <= 0.02 * nj, (nt, nj)

    # nearest JAX keypoint (same orientation slot) for every port keypoint
    d2 = ((tf["xy"][:, None, :] - jf["xy"][None, :, :]) ** 2).sum(-1)
    dori = np.abs(np.angle(np.exp(1j * (tf["orientation"][:, None]
                                         - jf["orientation"][None, :]))))
    d2 = np.where(dori < 1e-2, d2, np.inf)
    nn = np.argmin(d2, axis=1)
    dist = np.sqrt(d2[np.arange(nt), nn])
    rel_scale = np.abs(tf["scale"] - jf["scale"][nn]) / jf["scale"][nn]
    close = (dist <= 0.01) & (rel_scale <= 1e-3)
    assert close.mean() >= 0.98, close.mean()

    dt = tf["descriptors"][close].astype(int)
    dj = jf["descriptors"][nn[close]].astype(int)
    assert (dt == dj).mean() >= 0.98
    assert (np.abs(dt - dj) <= 1).mean() >= 0.999


def test_keypoint_affine_round_trip():
    rng = np.random.default_rng(1)
    xy = rng.random((50, 2)).astype(np.float32) * 100
    scale = rng.random(50).astype(np.float32) * 5 + 1
    ori = (rng.random(50).astype(np.float32) - 0.5) * 6
    kp6 = tsift.keypoints_to_affine(xy, scale, ori)
    np.testing.assert_array_equal(kp6, jsift.keypoints_to_affine(xy, scale,
                                                                 ori))
    xy2, s2, o2 = tsift.affine_to_keypoints(kp6)
    np.testing.assert_allclose(xy2, xy)
    np.testing.assert_allclose(s2, scale, rtol=1e-5)
    np.testing.assert_allclose(o2, ori, atol=1e-5)


def test_prepare_u8_downscale_matches():
    rng = np.random.default_rng(2)
    img = (rng.random((300, 420)) * 255).astype(np.uint8)
    opts = jsift.SiftExtractionOptions(max_image_size=200)
    topts = tsift.SiftExtractionOptions(max_image_size=200)
    jp, js, jh, jw = jsift._prepare_u8(img, opts)
    tp, ts, th, tw = tsift._prepare_u8(img, topts)
    assert (js, jh, jw) == (ts, th, tw) and jp.shape == tp.shape
    # antialiased resize, rounded to uint8: at most one level apart
    assert np.abs(jp.astype(int) - tp.astype(int)).max() <= 1
