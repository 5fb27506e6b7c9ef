"""The VIDEO path end to end in both packages, on the CPU.

A 10-frame walk along the room's camera arc and back (arc positions 0, 2,
4, 6, 8, 10, 9, 7, 5, 3 of 12, 320x240), so the last frame revisits the
start, goes through the JAX package's and the port's
run_automatic_reconstruction(data_type=VIDEO, sparse=True) at Quality.LOW
with a window of 2: SIFT, sequential pairing in name order (frame gaps 1,
2 and the quadratic 4) with vocab-tree loop detection (each package trains
its tree from its database; the 10th frame is the one query), matching
(the port's matcher kernel runs as its plain twin on the CPU), two-view
verification and the incremental mapper. Held:
- the proposed pair sets are equal, and both packages matched the same
  pairs and verified the same pairs;
- the loop pair (first frame, last frame), 9 frames apart, which only loop
  detection proposes, is verified in both;
- both models register all 10 frames within the JAX package's gate
  (rotation < 1 deg, centre < 0.05 x room size after Sim3 alignment).
"""

import numpy as np
import pytest
import torch

from colmap_tpu.controllers import automatic_reconstruction as jar
from colmap_tpu.estimators.similarity_transform import compare_reconstructions
from colmap_tpu.features import pairing as jpairing
from colmap_tpu_torch.controllers import automatic_reconstruction as tar
from colmap_tpu_torch.estimators.similarity_transform import (
    compare_reconstructions as tcompare)
from colmap_tpu_torch.features import pairing as tpairing
from colmap_tpu_torch.geometry import rotation as trot
from colmap_tpu_torch.scene import synthetic_images as synth
from colmap_tpu_torch.scene.reconstruction import Camera, Image, Reconstruction

torch.set_num_threads(2)


ARC = [0, 2, 4, 6, 8, 10, 9, 7, 5, 3]
OVERLAP = 2


def _options(mod, video, workspace):
    K = video["K"]
    return mod.AutomaticReconstructionOptions(
        workspace_path=workspace, image_path=video["dir"],
        data_type=mod.DataType.VIDEO, quality=mod.Quality.LOW,
        camera_model="PINHOLE", single_camera=True, sparse=True,
        video_overlap=OVERLAP,
        camera_params=",".join(map(str, [K[0, 0], K[1, 1], K[0, 2],
                                         K[1, 2]])))


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    opts = synth.RoomDatasetOptions(num_images=12, width=320, height=240,
                                    focal=280.0, seed=5)
    images, K, Rs, ts = synth.render_room_dataset(opts)
    root = tmp_path_factory.mktemp("video")
    image_dir = str(root / "images")
    names = synth.write_dataset(image_dir, [images[i] for i in ARC])
    video = dict(K=K, Rs=[Rs[i] for i in ARC], ts=[ts[i] for i in ARC],
                 dir=image_dir, names=names, opts=opts)
    video["jax"] = jar.run_automatic_reconstruction(
        _options(jar, video, str(root / "jax")))
    stages = {}
    video["port"] = tar.run_automatic_reconstruction(
        _options(tar, video, str(root / "port")), stage_timings=stages,
        device="cpu")
    video["port_stages"] = stages
    return video


def _by_name(db):
    return {im["name"]: iid for iid, im in db.read_images().items()}


def _pairs_by_name(db, pairs):
    name = {iid: nm for nm, iid in _by_name(db).items()}
    return {tuple(sorted((name[a], name[b]))) for a, b in pairs}


def test_pair_sets_equal(video):
    (_, jdb), (_, tdb) = video["jax"], video["port"]
    sets = []
    for db, pairing in ((jdb, jpairing), (tdb, tpairing)):
        ids = [_by_name(db)[nm] for nm in video["names"]]
        window = pairing.sequential_pairs(
            ids, pairing.SequentialPairingOptions(overlap=OVERLAP))
        # every pair with a matches row, in the window or not
        matched = [(a, b) for i, a in enumerate(ids) for b in ids[i + 1:]
                   if db.read_matches(a, b) is not None]
        sets.append((_pairs_by_name(db, window), _pairs_by_name(db, matched),
                     _pairs_by_name(db, db.read_all_two_view_geometries())))
    assert sets[0] == sets[1]
    window, matched, verified = sets[1]
    loop = (video["names"][0], video["names"][-1])
    assert loop not in window and loop in verified
    assert window < matched and verified <= matched
    # the port proposed the window and the 10th frame's retrievals
    stats = video["port_stages"]["matching_stats"]
    assert stats["num_pairs"] == len(window | matched)
    assert stats["num_blocks"] == 1


def _gt(video, name_to_id):
    gt = Reconstruction()
    K, o = video["K"], video["opts"]
    gt.add_camera(Camera(camera_id=1, model_id=1, width=o.width,
                         height=o.height,
                         params=np.array([K[0, 0], K[1, 1], K[0, 2],
                                          K[1, 2]])))
    for i, name in enumerate(video["names"]):
        q = trot.rotmat_to_quat(torch.as_tensor(video["Rs"][i],
                                                dtype=torch.float32)).numpy()
        gt.add_image(Image(image_id=name_to_id[name], name=name, camera_id=1,
                           cam_from_world=np.concatenate(
                               [q, video["ts"][i]]).astype(np.float64)))
    return gt


@pytest.mark.parametrize("package", ["jax", "port"])
def test_models_register_every_frame_within_the_gate(video, package):
    rec, db = video[package]
    assert rec is not None and rec.num_registered_images() == len(ARC)
    gt = _gt(video, _by_name(db))
    if package == "jax":
        cmp = compare_reconstructions(rec, gt)
    else:
        cmp = tcompare(rec, gt, device="cpu")
    assert cmp["max_rotation_error_deg"] < 1.0, cmp
    assert cmp["max_center_error"] < 0.05 * video["opts"].room_size, cmp
