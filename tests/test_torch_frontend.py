"""The port end to end, against the JAX package.

The 6x320x240 room render of tests/test_e2e_images.py goes through the JAX
package's run_automatic_reconstruction(sparse=False) and the port's
run_automatic_reconstruction(sparse=True): SIFT, exhaustive pairing,
matching (the port's matcher kernel runs as its plain twin on the CPU) and
two-view verification into a COLMAP database, then, in the port, the
incremental mapper into workspace/sparse/0. Held:
- per-image feature counts within 2%;
- the same set of verified pairs;
- each package reads the other's database;
- the JAX IncrementalPipeline run on the *port's* database registers 6/6
  images within the JAX package's own pixels-to-poses gate (rotation
  < 1 deg, centre < 0.05 x room size after Sim3 alignment);
- the port's own model, pixels to poses, passes the same gate.
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
from colmap_tpu_torch.controllers import dense_reconstruction as tdense
from colmap_tpu_torch.controllers import feature_matching as tfm
from colmap_tpu_torch.estimators.similarity_transform import (
    compare_reconstructions as tcompare)
from colmap_tpu_torch.scene import synthetic_images as synth
from colmap_tpu_torch.scene.database import Database as TDatabase
from colmap_tpu_torch.scene.reconstruction_io import read_model as tread_model

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _options(mod, room, workspace, sparse=False):
    K = room["K"]
    return mod.AutomaticReconstructionOptions(
        workspace_path=workspace, image_path=room["dir"],
        quality=mod.Quality.LOW, camera_model="PINHOLE", single_camera=True,
        sparse=sparse,
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
    stages = {}
    room["port_rec"], tdb = tar.run_automatic_reconstruction(
        _options(tar, room, str(root / "port"), sparse=True),
        stage_timings=stages, device="cpu")
    jdb.close()
    tdb.close()
    room["jax_db"] = str(root / "jax" / "database.db")
    room["port_db"] = str(root / "port" / "database.db")
    room["port_sparse"] = root / "port" / "sparse" / "0"
    room["port_stages"] = stages
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


def test_port_pixels_to_model(room):
    rec = room["port_rec"]
    assert rec is not None and rec.num_registered_images() == 6
    db = TDatabase(room["port_db"])
    cmp = tcompare(rec, _gt_reconstruction(room, _by_name(db)), device="cpu")
    db.close()
    assert cmp["max_rotation_error_deg"] < 1.0, cmp
    assert cmp["max_center_error"] < 0.05 * room["opts"].room_size, cmp
    back = tread_model(room["port_sparse"])
    assert back.num_registered_images() == 6
    assert len(back.points3D) == len(rec.points3D) > 100
    stages = room["port_stages"]
    assert stages["mapping"] > 0 and "global_ba" in stages["mapping_stages"]
    assert stages["mapping_ba"]["gba_calls"] >= 1


def test_unported_paths_raise(tmp_path, monkeypatch):
    """The multi-device branches of matching and PatchMatch, which raised
    until the parallel slice, run (tests/test_torch_parallel.py holds them
    against one device and JAX): matching on two CPU shards goes through
    an empty block list. What raises is a mesh asked for on the card where
    there is none: no multi-device path falls back to the CPU."""
    db = TDatabase(":memory:")
    stats = tfm.match_and_verify_blocks(
        db, [], tfm.FeatureMatchingOptions(num_devices=2), device="cpu")
    assert stats.num_blocks == 0 and stats.num_pairs == 0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfm.match_and_verify_blocks(
            db, [], tfm.FeatureMatchingOptions(num_devices=2), device="cuda")
    db.close()
    with pytest.raises(RuntimeError, match="CUDA"):
        tdense.run_patch_match_stereo(
            str(tmp_path), tdense.PatchMatchStereoOptions(num_devices=2),
            device="cuda")


def test_port_imports_neither_jax_nor_colmap_tpu(tmp_path):
    """The port runs the VIDEO path pixels to model (sequential pairing,
    vocab-tree loop detection), imports the retrieval, pairing, GPS,
    hierarchical-mapping, dense, rig, pose-prior and tool modules, the
    command line, the Python API, the option manager, the database tools
    and the parallel modules, matches on two CPU shards, solves a small rig
    BA and clusters a synthetic database without importing jax or
    colmap_tpu."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads(1)
        from colmap_tpu_torch.scene import synthetic_images as synth
        from colmap_tpu_torch.controllers import automatic_reconstruction as ar
        from colmap_tpu_torch.features import pairing
        from colmap_tpu_torch.geometry import gps
        from colmap_tpu_torch.retrieval import (kmeans, visual_index,
                                                vote_and_verify)
        from colmap_tpu_torch.controllers import hierarchical_pipeline
        from colmap_tpu_torch.estimators import alignment, pose_graph
        from colmap_tpu_torch.scene import scene_clustering, synthetic
        from colmap_tpu_torch.scene.database import Database
        from colmap_tpu_torch import bench_patch_match
        from colmap_tpu_torch.controllers import dense_reconstruction
        from colmap_tpu_torch.image import rectification, undistortion, warp
        from colmap_tpu_torch.mvs import (consistency_graph, depth_map,
                                          fusion, meshing, model,
                                          patch_match, workspace)
        from colmap_tpu_torch.util import cache
        from colmap_tpu_torch.optim import least_absolute_deviations
        from colmap_tpu_torch.scene import camera_rig
        from colmap_tpu_torch.estimators import (
            coordinate_frame, covariance, generalized_pose, pose_prior_ba,
            rig_bundle_adjustment)
        from colmap_tpu_torch.image import line
        from colmap_tpu_torch.tools import (database_tools, html_viewer,
                                           model_tools, rig_tools, sfm_tools)
        from colmap_tpu_torch import api, cli
        from colmap_tpu_torch.controllers import option_manager
        from colmap_tpu_torch.util import timer
        from colmap_tpu_torch.scene import visibility_pyramid
        from colmap_tpu_torch.parallel import (distributed_ba, mesh,
                                               sharded_matching)
        import numpy as np
        d = np.random.default_rng(0).integers(0, 256, (2, 64, 128),
                                              dtype=np.uint8)
        v = np.ones((2, 64), bool)
        m = sharded_matching.match_pair_blocks_sharded(
            mesh.make_mesh(2, device="cpu"), d, d, v, v)
        assert (m == np.arange(64)).all()
        assert len(cli.COMMANDS) == 43
        option_manager.OptionManager()
        rig_problem = rig_bundle_adjustment.make_rig_problem(
            [[1.0, 0, 0, 0, 0, 0, 0]] * 2, [[1.0, 0, 0, 0, 0, 0, 0]] * 2,
            [[100.0] + [0.0] * 11] * 2, [[0.0, 0, 5], [1, 0, 5]],
            [0, 1, 0, 1], [0, 1, 1, 0], [0, 0, 1, 1],
            [[0.0, 0], [0, 0], [20, 0], [20, 0]], device="cpu")
        _, cost = rig_bundle_adjustment.solve_rig(
            rig_problem, rig_bundle_adjustment.RigBAOptions(
                max_iterations=2, cg_iterations=3))
        assert float(cost) < 1e-6
        K = torch.tensor([[14.0, 0, 8], [0, 14.0, 6], [0, 0, 1]])
        depth, _, _ = patch_match.patch_match(
            patch_match.GeneratorDraws(torch.Generator().manual_seed(0),
                                       (12, 16)),
            patch_match.PatchMatchProblem(
                ref_image=torch.rand(12, 16), src_images=torch.rand(2, 12, 16),
                K_ref=K, K_src=torch.stack([K, K]),
                R_rel=torch.eye(3).expand(2, 3, 3),
                t_rel=torch.tensor([[0.1, 0, 0], [-0.1, 0, 0]]),
                depth_min=torch.tensor(1.0), depth_max=torch.tensor(4.0)),
            patch_match.PatchMatchOptions(window_radius=1, num_iterations=1))
        assert depth.shape == (12, 16)
        sdb = Database(":memory:")
        synthetic.synthesize_dataset(synthetic.SyntheticDatasetOptions(
            num_images=6, num_points3D=60, match_config=2,
            match_overlap=2), sdb)
        tree = scene_clustering.cluster_scene(
            sorted(sdb.read_images()),
            scene_clustering.edge_weights_from_database(sdb),
            scene_clustering.SceneClusteringOptions(
                leaf_max_num_images=3, image_overlap=1))
        assert len(tree.leaves()) == 2
        o = synth.RoomDatasetOptions(num_images=3, width=320, height=240,
                                     focal=280.0, seed=5)
        images, K, _, _ = synth.render_room_dataset(o)
        synth.write_dataset({str(tmp_path / "images")!r}, images)
        rec, db = ar.run_automatic_reconstruction(
            ar.AutomaticReconstructionOptions(
                workspace_path={str(tmp_path / "ws")!r},
                image_path={str(tmp_path / "images")!r},
                data_type=ar.DataType.VIDEO,
                quality=ar.Quality.LOW, camera_model="PINHOLE",
                single_camera=True, sparse=True,
                camera_params=",".join(map(str, [K[0, 0], K[1, 1], K[0, 2],
                                                 K[1, 2]]))),
            device="cpu")
        assert db.num_images() == 3
        assert rec is not None and rec.num_registered_images() == 3
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
