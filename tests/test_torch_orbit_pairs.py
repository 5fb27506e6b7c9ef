"""Two-view verification on the VIDEO cell's scene, the port against the JAX
package, on the CPU.

The orbit render (a textured box in a walled room, seen from a circle
around it; scene/synthetic_images.py) at 320x240, 24 frames 9 deg apart,
extracted by the port; 64 pairs 1-8 frames apart are matched by the
port's matcher, and both packages' cascades verify the same raw
matches (their RANSAC draws differ). The scene is mostly planes, so many
pairs come out PLANAR_OR_PANORAMIC or UNCALIBRATED, where the relative
rotation recovered from E or H (as the mapper recovers it at
initialisation) is ambiguous, while the inlier matches themselves are
true correspondences. Held, for both packages alike:
- the verified-pair counts agree within 10% of the pairs;
- the share of verified pairs whose recovered rotation is more than 1 deg
  from ground truth agrees within 0.15 (1.7 standard deviations of a
  share near 0.5 over the ~33 verified pairs) and is above 1% in both:
  the decomposition tail is the algorithm's, not the port's;
- >= 95% of all inlier matches lie within 4 px (Sampson, the cascade's
  own threshold) of the ground-truth epipolar geometry, in both.
chip_smoke.py holds the card's VIDEO cell to the last gate.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from colmap_tpu.estimators import two_view_geometry as jtvg
from colmap_tpu_torch.controllers import feature_extraction as fe
from colmap_tpu_torch.controllers import feature_matching as fm
from colmap_tpu_torch.estimators import two_view_geometry as ttvg
from colmap_tpu_torch.features import sift as sift_mod
from colmap_tpu_torch.features.sift import affine_to_keypoints
from colmap_tpu_torch.geometry import rotation as trot
from colmap_tpu_torch.scene import synthetic_images as synth
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.sensor import models as cam_models

torch.set_num_threads(2)


def _skew(t):
    return np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])


@pytest.fixture(scope="module")
def orbit(tmp_path_factory):
    o = synth.OrbitDatasetOptions(num_images=24, width=320, height=240,
                                  focal=0.875 * 320, seed=3, texture_res=512,
                                  orbit_turns=0.6)
    images, K, Rs, ts = synth.render_orbit_dataset(o)
    root = tmp_path_factory.mktemp("orbit")
    names = synth.write_dataset(str(root / "images"), images)
    db = Database(":memory:")
    fe.run_feature_extraction(
        db, str(root / "images"),
        fe.ImageReaderOptions(camera_model="PINHOLE", single_camera=True,
                              camera_params=",".join(map(str, [
                                  K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))),
        sift_mod.SiftExtractionOptions(max_image_size=1000,
                                       max_num_features=2048), device="cpu")
    ids = {im["name"]: iid for iid, im in db.read_images().items()}
    order = [ids[nm] for nm in names]
    pairs = [(order[i], order[i + g]) for i in range(0, 16, 2)
             for g in range(1, 9)]
    fm.match_pairs(db, pairs, fm.FeatureMatchingOptions(), device="cpu")
    cam = list(db.read_cameras().values())[0]
    params = torch.as_tensor(cam_models.pad_params(list(cam["params"])))
    rays, xys = {}, {}
    for iid in order:
        xy, _, _ = affine_to_keypoints(db.read_keypoints(iid))
        xys[iid] = xy.astype(np.float32)
        rays[iid] = cam_models.cam_from_img(
            cam["model_id"], params, torch.as_tensor(xys[iid])).numpy()
    index = {iid: i for i, iid in enumerate(order)}
    # both cascades on the same raw matches
    pairs = [p for p in pairs if db.read_matches(*p) is not None]
    mats = [db.read_matches(*p).astype(np.int64) for p in pairs]
    B, mcap = len(pairs), int(2 ** np.ceil(np.log2(max(map(len, mats)))))
    arr = {k: np.zeros((B, mcap, 2), np.float32)
           for k in ("rays1", "rays2", "pix1", "pix2")}
    valid = np.zeros((B, mcap), bool)
    for i, ((a, b), m) in enumerate(zip(pairs, mats)):
        n = len(m)
        arr["rays1"][i, :n], arr["rays2"][i, :n] = rays[a][m[:, 0]], rays[b][m[:, 1]]
        arr["pix1"][i, :n], arr["pix2"][i, :n] = xys[a][m[:, 0]], xys[b][m[:, 1]]
        valid[i, :n] = True
    focal = np.full(B, K[0, 0], np.float32)
    sizes = np.tile(np.array([[320, 240]], np.float32), (B, 1))
    jopts = jtvg.TwoViewGeometryOptions()
    jres = jax.vmap(lambda k, r1, r2, p1, p2, v, f, s1, s2:
                    jtvg.estimate_two_view_geometry(
                        k, r1, r2, p1, p2, v, f, jopts, sizes1=s1,
                        sizes2=s2))(
        jax.random.split(jax.random.PRNGKey(0), B),
        *(jnp.asarray(arr[k]) for k in ("rays1", "rays2", "pix1", "pix2")),
        jnp.asarray(valid), jnp.asarray(focal), jnp.asarray(sizes),
        jnp.asarray(sizes))
    tres = ttvg.estimate_two_view_geometry(
        torch.Generator().manual_seed(0),
        *(torch.as_tensor(arr[k]) for k in ("rays1", "rays2", "pix1",
                                           "pix2")),
        torch.as_tensor(valid), torch.as_tensor(focal),
        ttvg.TwoViewGeometryOptions(), sizes1=torch.as_tensor(sizes),
        sizes2=torch.as_tensor(sizes))
    return dict(K=K, Rs=Rs, ts=ts, pairs=pairs, index=index, arr=arr,
                jax=[np.asarray(x) for x in jres],
                port=[x.numpy() for x in tres])


def _outcome(orbit, res):
    """(verified count, share of verified pairs above 1 deg, share of
    inliers on the true epipolar geometry) of one package's results."""
    config, E, _, H, mask, num = (res[k] for k in range(6))
    arr, K, Rs, ts = orbit["arr"], orbit["K"], orbit["Rs"], orbit["ts"]
    ok = num >= 15
    pose, _ = ttvg.recover_relative_pose(
        torch.tensor(config).long(), torch.tensor(E),
        torch.tensor(H), torch.as_tensor(arr["rays1"]),
        torch.as_tensor(arr["rays2"]), torch.tensor(mask))
    Ki = np.linalg.inv(K)
    above, true, total = 0, 0, 0
    for i, (a, b) in enumerate(orbit["pairs"]):
        if not ok[i]:
            continue
        ia, ib = orbit["index"][a], orbit["index"][b]
        R = Rs[ib] @ Rs[ia].T
        q = trot.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32))
        above += float(trot.quat_angle_deg(q, pose[i, :4])) > 1.0
        F = Ki.T @ _skew(ts[ib] - R @ ts[ia]) @ R @ Ki
        m = mask[i]
        x1 = np.c_[arr["pix1"][i][m], np.ones(m.sum())]
        x2 = np.c_[arr["pix2"][i][m], np.ones(m.sum())]
        Fx1, Ftx2 = x1 @ F.T, x2 @ F
        sampson = np.sum(Fx1 * x2, 1) ** 2 / (
            Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2
            + Ftx2[:, 1] ** 2)
        true += int((sampson <= 16.0).sum())
        total += int(m.sum())
    n = int(ok.sum())
    return n, above / n, true / total


def test_verification_outcome_equals_jax_on_orbit_pairs(orbit):
    jn, jabove, jtrue = _outcome(orbit, orbit["jax"])
    tn, tabove, ttrue = _outcome(orbit, orbit["port"])
    B = len(orbit["pairs"])
    assert B >= 60 and jn >= 0.4 * B
    assert abs(tn - jn) <= 0.1 * B, (tn, jn)
    assert abs(tabove - jabove) <= 0.15, (tabove, jabove)
    assert tabove > 0.01 and jabove > 0.01, (tabove, jabove)
    assert ttrue >= 0.95 and jtrue >= 0.95, (ttrue, jtrue)
