"""The port's correspondence front end end to end, against the JAX package.

The 6x320x240 room render of tests/test_e2e_images.py goes through both
packages' run_automatic_reconstruction(sparse=False): SIFT, exhaustive
pairing, matching (the port's matcher kernel runs as its plain twin on the
CPU) and two-view verification into a COLMAP database. Held:
- per-image feature counts within 2%;
- the same set of verified pairs;
- each package reads the other's database;
- the JAX IncrementalPipeline run on the *port's* database registers 6/6
  images within the JAX package's own pixels-to-poses gate (rotation
  < 1 deg, centre < 0.05 x room size after Sim3 alignment).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from colmap_tpu.controllers import automatic_reconstruction as jar
from colmap_tpu.controllers.incremental_pipeline import (
    IncrementalPipeline,
    IncrementalPipelineOptions,
)
from colmap_tpu.estimators.similarity_transform import compare_reconstructions
from colmap_tpu.geometry import rotation as jrot
from colmap_tpu.scene.database import Database as JDatabase
from colmap_tpu.scene.reconstruction import Camera, Image, Reconstruction
from colmap_tpu_torch.controllers import automatic_reconstruction as tar
from colmap_tpu_torch.scene import synthetic_images as synth
from colmap_tpu_torch.scene.database import Database as TDatabase

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _options(mod, room, workspace):
    K = room["K"]
    return mod.AutomaticReconstructionOptions(
        workspace_path=workspace, image_path=room["dir"],
        quality=mod.Quality.LOW, camera_model="PINHOLE", single_camera=True,
        sparse=False,
        camera_params=",".join(map(str, [K[0, 0], K[1, 1], K[0, 2],
                                         K[1, 2]])))


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    opts = synth.RoomDatasetOptions(num_images=6, width=320, height=240,
                                    focal=280.0, seed=5)
    images, K, Rs, ts = synth.render_room_dataset(opts)
    root = tmp_path_factory.mktemp("frontend")
    image_dir = str(root / "images")
    names = synth.write_dataset(image_dir, images)
    room = dict(K=K, Rs=Rs, ts=ts, dir=image_dir, names=names, opts=opts)
    _, jdb = jar.run_automatic_reconstruction(
        _options(jar, room, str(root / "jax")))
    _, tdb = tar.run_automatic_reconstruction(
        _options(tar, room, str(root / "port")), device="cpu")
    jdb.close()
    tdb.close()
    room["jax_db"] = str(root / "jax" / "database.db")
    room["port_db"] = str(root / "port" / "database.db")
    return room


def _by_name(db):
    return {im["name"]: iid for iid, im in db.read_images().items()}


def _verified(db):
    ids = {iid: im["name"] for iid, im in db.read_images().items()}
    return {tuple(sorted((ids[a], ids[b])))
            for a, b in db.read_all_two_view_geometries()}


def test_feature_counts_and_verified_pairs(room):
    jdb, tdb = JDatabase(room["jax_db"]), TDatabase(room["port_db"])
    jn, tn = _by_name(jdb), _by_name(tdb)
    assert set(jn) == set(tn) == set(room["names"])
    for name in room["names"]:
        nj = jdb.num_keypoints(jn[name])
        nt = tdb.num_keypoints(tn[name])
        assert nt > 200 and abs(nt - nj) <= 0.02 * nj, (name, nt, nj)
    assert _verified(tdb) == _verified(jdb)
    assert len(_verified(tdb)) >= 10


def test_databases_cross_read(room):
    # the JAX package reads the port's database, and the port the JAX one
    for reader, path in ((JDatabase, room["port_db"]),
                         (TDatabase, room["jax_db"])):
        db = reader(path)
        assert db.num_images() == 6
        cams = db.read_cameras()
        assert len(cams) == 1 and list(cams.values())[0]["model_id"] == 1
        for iid in db.read_images():
            kp = db.read_keypoints(iid)
            desc = db.read_descriptors(iid)
            assert kp.shape[1] == 6 and desc.shape == (len(kp), 128)
            assert desc.dtype == np.uint8
        tvg = db.read_all_two_view_geometries()
        assert tvg and all(len(v["inlier_matches"]) >= 15
                           for v in tvg.values())
        db.close()


def _gt_reconstruction(room, name_to_id):
    gt = Reconstruction()
    K = room["K"]
    o = room["opts"]
    gt.add_camera(Camera(camera_id=1, model_id=1, width=o.width,
                         height=o.height,
                         params=np.array([K[0, 0], K[1, 1], K[0, 2],
                                          K[1, 2]])))
    for i, name in enumerate(room["names"]):
        q = np.asarray(jrot.rotmat_to_quat(jnp.asarray(room["Rs"][i],
                                                       np.float32)))
        img = Image(image_id=name_to_id[name], name=name, camera_id=1)
        img.cam_from_world = np.concatenate([q, room["ts"][i]]).astype(
            np.float64)
        gt.add_image(img)
    return gt


def test_jax_mapper_on_port_database(room):
    db = JDatabase(room["port_db"])
    rec = IncrementalPipeline(db, IncrementalPipelineOptions()).run(seed=0)
    assert rec is not None and rec.num_registered_images() == 6
    cmp = compare_reconstructions(rec, _gt_reconstruction(room, _by_name(db)))
    assert cmp is not None
    assert cmp["max_rotation_error_deg"] < 1.0, cmp
    assert cmp["max_center_error"] < 0.05 * room["opts"].room_size, cmp


def test_unported_paths_raise(tmp_path):
    base = dict(workspace_path=str(tmp_path), image_path=str(tmp_path))
    for kw in (dict(sparse=True), dict(sparse=False, dense=True),
               dict(sparse=False, data_type=tar.DataType.VIDEO)):
        with pytest.raises(NotImplementedError):
            tar.run_automatic_reconstruction(
                tar.AutomaticReconstructionOptions(**base, **kw),
                device="cpu")


def test_port_imports_neither_jax_nor_colmap_tpu(tmp_path):
    """The port runs its front end without importing jax or colmap_tpu."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads(1)
        from colmap_tpu_torch.scene import synthetic_images as synth
        from colmap_tpu_torch.controllers import automatic_reconstruction as ar
        o = synth.RoomDatasetOptions(num_images=3, width=160, height=128,
                                     focal=150.0, seed=5)
        images, K, _, _ = synth.render_room_dataset(o)
        synth.write_dataset({str(tmp_path / "images")!r}, images)
        _, db = ar.run_automatic_reconstruction(
            ar.AutomaticReconstructionOptions(
                workspace_path={str(tmp_path / "ws")!r},
                image_path={str(tmp_path / "images")!r},
                quality=ar.Quality.LOW, camera_model="PINHOLE",
                single_camera=True, sparse=False,
                camera_params=",".join(map(str, [K[0, 0], K[1, 1], K[0, 2],
                                                 K[1, 2]]))),
            device="cpu")
        assert db.num_images() == 3
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "colmap_tpu."))
               or m == "colmap_tpu"]
        assert not bad, bad
        print("isolated ok")
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "isolated ok" in res.stdout
