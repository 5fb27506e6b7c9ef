"""The slice as a whole: both command lines run pixels to model,
feature_extractor -> exhaustive_matcher -> mapper, on the 6x320x240 room
render of tests/test_torch_frontend.py, each into its own database and
model (the port with `--device cpu`, where its matcher kernel runs as its
plain twin).

Held:
- keypoints and descriptors at tests/test_torch_sift.py's tolerances:
  per image >= 98% of the port's keypoints within 0.01 px (and 1e-3
  relative scale) of a JAX keypoint of the same orientation, >= 98% of
  their descriptor bytes equal and >= 99.9% within one level;
- raw matches: >= 99.9% of the port's matches join the same two keypoints
  (by position, within 0.01 px) as a JAX match, over all pairs;
- both models register all 6 images, rotations within 1 deg and centres
  within 0.05 x the room size of the render's cameras after a Sim3
  alignment (the JAX package's gate; the mappers' draws differ).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from colmap_tpu import cli as jcli
from colmap_tpu.estimators.similarity_transform import (
    compare_reconstructions)
from colmap_tpu.geometry import rotation as jrot
from colmap_tpu.scene import reconstruction_io as jrio
from colmap_tpu.scene.reconstruction import Camera, Image, Reconstruction
from colmap_tpu_torch import cli as tcli
from colmap_tpu_torch.features.sift import affine_to_keypoints
from colmap_tpu_torch.scene import synthetic_images as synth
from colmap_tpu_torch.scene.database import Database

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    opts = synth.RoomDatasetOptions(num_images=6, width=320, height=240,
                                    focal=280.0, seed=5)
    images, K, Rs, ts = synth.render_room_dataset(opts)
    root = tmp_path_factory.mktemp("cli_chain")
    image_dir = str(root / "images")
    names = synth.write_dataset(image_dir, images)
    params = ",".join(map(str, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))
    out = dict(names=names, K=K, Rs=Rs, ts=ts, opts=opts)
    for tag, mod, extra in (("jax", jcli, []),
                            ("port", tcli, ["--device", "cpu"])):
        db = str(root / f"{tag}.db")
        common = ["--database_path", db] + extra
        assert mod.main(["database_creator"] + common) == 0
        assert mod.main(["feature_extractor", "--image_path", image_dir,
                         "--ImageReader.camera_model", "PINHOLE",
                         "--ImageReader.single_camera", "1",
                         "--ImageReader.camera_params", params,
                         "--SiftExtraction.max_num_features", "2048"]
                        + common) == 0
        assert mod.main(["exhaustive_matcher"] + common) == 0
        assert mod.main(["mapper", "--output_path", str(root / tag)]
                        + common) == 0
        out[tag] = dict(db=db, model=str(root / tag / "0"))
    return out


def _features(db_path):
    db = Database(db_path)
    out = {}
    for iid, im in db.read_images().items():
        xy, scale, ori = affine_to_keypoints(db.read_keypoints(iid))
        out[im["name"]] = dict(id=iid, xy=xy, scale=scale, ori=ori,
                               desc=db.read_descriptors(iid))
    db.close()
    return out


def test_keypoints_and_descriptors_match_jax(runs):
    jf, tf = _features(runs["jax"]["db"]), _features(runs["port"]["db"])
    assert set(tf) == set(jf) == set(runs["names"])
    for name in runs["names"]:
        a, b = tf[name], jf[name]
        nt, nj = len(a["xy"]), len(b["xy"])
        assert nt > 200 and abs(nt - nj) <= 0.02 * nj, (name, nt, nj)
        d2 = ((a["xy"][:, None] - b["xy"][None]) ** 2).sum(-1)
        dori = np.abs(np.angle(np.exp(1j * (a["ori"][:, None]
                                             - b["ori"][None]))))
        d2 = np.where(dori < 1e-2, d2, np.inf)
        nn = np.argmin(d2, axis=1)
        dist = np.sqrt(d2[np.arange(nt), nn])
        rel = np.abs(a["scale"] - b["scale"][nn]) / b["scale"][nn]
        close = (dist <= 0.01) & (rel <= 1e-3)
        assert close.mean() >= 0.98, (name, close.mean())
        dt = a["desc"][close].astype(int)
        dj = b["desc"][nn[close]].astype(int)
        assert (dt == dj).mean() >= 0.98
        assert (np.abs(dt - dj) <= 1).mean() >= 0.999


def test_raw_matches_match_jax(runs):
    jf, tf = _features(runs["jax"]["db"]), _features(runs["port"]["db"])
    jdb, tdb = Database(runs["jax"]["db"]), Database(runs["port"]["db"])
    names = runs["names"]
    total = same = 0
    for i, n1 in enumerate(names):
        for n2 in names[i + 1:]:
            mt = tdb.read_matches(tf[n1]["id"], tf[n2]["id"])
            mj = jdb.read_matches(jf[n1]["id"], jf[n2]["id"])
            if mt is None or len(mt) == 0:
                assert mj is None or len(mj) == 0
                continue
            pt = np.concatenate([tf[n1]["xy"][mt[:, 0]],
                                 tf[n2]["xy"][mt[:, 1]]], 1)
            pj = np.concatenate([jf[n1]["xy"][mj[:, 0]],
                                 jf[n2]["xy"][mj[:, 1]]], 1)
            d = np.abs(pt[:, None] - pj[None]).max(-1).min(1)
            total += len(mt)
            same += int((d <= 0.01).sum())
    jdb.close()
    tdb.close()
    assert total > 1000
    assert same >= 0.999 * total, (same, total)


def _gt(runs, db_path):
    db = Database(db_path)
    ids = {im["name"]: iid for iid, im in db.read_images().items()}
    db.close()
    K, o = runs["K"], runs["opts"]
    gt = Reconstruction()
    gt.add_camera(Camera(camera_id=1, model_id=1, width=o.width,
                         height=o.height,
                         params=np.array([K[0, 0], K[1, 1], K[0, 2],
                                          K[1, 2]])))
    for i, name in enumerate(runs["names"]):
        q = np.asarray(jrot.rotmat_to_quat(jnp.asarray(runs["Rs"][i],
                                                       np.float32)))
        img = Image(image_id=ids[name], name=name, camera_id=1)
        img.cam_from_world = np.concatenate([q, runs["ts"][i]]).astype(
            np.float64)
        gt.add_image(img)
    return gt


@pytest.mark.parametrize("tag", ["jax", "port"])
def test_models_pass_the_gates(runs, tag):
    rec = jrio.read_model(runs[tag]["model"])
    assert rec.num_registered_images() == 6
    cmp = compare_reconstructions(rec, _gt(runs, runs[tag]["db"]))
    assert cmp["max_rotation_error_deg"] < 1.0, cmp
    assert cmp["max_center_error"] < 0.05 * runs["opts"].room_size, cmp
    assert len(rec.points3D) > 100
