"""The MVS model's array code (`mvs/model.py` `build_model`) against the
per-point, per-pair loop it replaced, kept here as `_build_model_loop`.

Seeded random reconstructions: unregistered images, an image that sees no
point, points behind cameras, tracks of 1 to 25 observations; a model
whose angles are all 10 degrees or more, so that scores tie as whole
numbers and the order of first appearance decides; and one at the dense
benchmark cell's scale (12 images, ~3,500 points, mean track ~9.7).
Depth ranges and scores agree to 1e-12 relative, and bit for bit, since the
array code takes its dot products and sums as the loop does; every image's
ranked source list is identical.
"""

import os
from typing import Dict, List, Tuple

import numpy as np
import pytest
import torch

from colmap_tpu_torch.geometry import rotation
from colmap_tpu_torch.mvs import model as mvs_model
from colmap_tpu_torch.scene.reconstruction import (
    Camera, Image, Point3D, Reconstruction)


def _build_model_loop(rec: Reconstruction,
                      max_triangulation_angle_deg: float = 90.0
                      ) -> mvs_model.MVSModel:
    """`build_model` as a loop over the points and the pairs of each
    track (the JAX package's `build_model` computes the same)."""
    images: Dict[int, mvs_model.MVSImage] = {}
    for iid, img in rec.images.items():
        if not img.registered:
            continue
        cam = rec.cameras[img.camera_id]
        fx, fy, cx, cy = cam.params[:4]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        pose = torch.as_tensor(np.asarray(img.cam_from_world, np.float64))
        R = rotation.quat_to_rotmat(
            pose[:4] / torch.linalg.vector_norm(pose[:4])).numpy()
        images[iid] = mvs_model.MVSImage(
            image_id=iid, name=img.name, K=K, R=R, t=pose[4:7].numpy().copy(),
            width=cam.width, height=cam.height)
    centers = {iid: im.center() for iid, im in images.items()}

    depths: Dict[int, List[float]] = {iid: [] for iid in images}
    shared: Dict[Tuple[int, int], List[float]] = {}
    for pt in rec.points3D.values():
        track_imgs = [iid for iid, _ in pt.track if iid in images]
        for iid in track_imgs:
            im = images[iid]
            z = float(im.R[2] @ pt.xyz + im.t[2])
            if z > 0:
                depths[iid].append(z)
        for a_i in range(len(track_imgs)):
            for b_i in range(a_i + 1, len(track_imgs)):
                a, b = track_imgs[a_i], track_imgs[b_i]
                va = pt.xyz - centers[a]
                vb = pt.xyz - centers[b]
                cosang = np.dot(va, vb) / max(
                    np.linalg.norm(va) * np.linalg.norm(vb), 1e-12)
                ang = float(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
                shared.setdefault((min(a, b), max(a, b)), []).append(ang)

    depth_ranges = {}
    for iid, ds in depths.items():
        if not ds:
            continue
        arr = np.asarray(ds)
        lo = float(np.percentile(arr, 1)) * 0.75
        hi = float(np.percentile(arr, 99)) * 1.25
        depth_ranges[iid] = (max(lo, 1e-4), hi)
    if depth_ranges:
        glo = min(r[0] for r in depth_ranges.values())
        ghi = max(r[1] for r in depth_ranges.values())
    else:
        glo, ghi = 0.1, 100.0
    for iid in depths:
        if iid not in depth_ranges:
            depth_ranges[iid] = (glo, ghi)

    overlap: Dict[int, List[Tuple[int, float]]] = {iid: [] for iid in images}
    for (a, b), angs in shared.items():
        angs = np.asarray(angs)
        usable = angs[(angs > 1.0) & (angs < max_triangulation_angle_deg)]
        if len(usable) == 0:
            continue
        score = float(np.sum(np.minimum(usable / 10.0, 1.0)))
        overlap[a].append((b, score))
        overlap[b].append((a, score))
    for iid in overlap:
        overlap[iid].sort(key=lambda kv: -kv[1])

    return mvs_model.MVSModel(images=images, depth_ranges=depth_ranges,
                              overlap_scores=overlap)


def _look_at(center: np.ndarray, target: np.ndarray) -> np.ndarray:
    """cam_from_world [qw qx qy qz tx ty tz] of a camera at `center`
    looking at `target`."""
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x = x / np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    w = np.sqrt(max(1.0 + np.trace(R), 1e-12)) / 2
    q = np.array([w, R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    q[1:] /= 4 * w
    return np.concatenate([q, -R @ center])


def _random_reconstruction(seed: int, num_images: int, num_points: int,
                           max_track: int, unregistered: int = 0,
                           blind: bool = False, spread: float = 1.0,
                           ring: float = 4.0) -> Reconstruction:
    """Cameras on a noisy ring around the origin, looking at it; points
    near the origin (some behind a camera), each seen by a random subset
    of the images, in random order. `unregistered` images have no pose;
    with `blind` the last registered image is in no track."""
    rng = np.random.default_rng(seed)
    rec = Reconstruction()
    rec.add_camera(Camera(camera_id=1, model_id=1, width=64, height=48,
                          params=np.array([50.0, 52.0, 32.0, 24.0])))
    ids = rng.choice(np.arange(1, 1000), num_images, replace=False).tolist()
    for k, iid in enumerate(ids):
        phi = 2 * np.pi * k / num_images + rng.normal(0, 0.05)
        center = np.array([ring * np.cos(phi), rng.normal(0, 0.3),
                           ring * np.sin(phi)])
        pose = None if k < unregistered else _look_at(
            center, rng.normal(0, 0.3, 3))
        rec.add_image(Image(image_id=iid, name=f"im{iid}.png", camera_id=1,
                            cam_from_world=pose,
                            point3D_ids=np.full(max_track + 1, -1)))
    seen = ids[:-1] if blind else ids
    for _ in range(num_points):
        xyz = rng.normal(0, spread, 3)
        length = int(rng.integers(1, min(max_track, len(seen)) + 1))
        track = rng.choice(seen, length, replace=False).tolist()
        rec.points3D[len(rec.points3D) + 1] = Point3D(
            xyz=xyz, track=[(iid, 0) for iid in track])
    return rec


def _cell_scale_reconstruction(seed: int) -> Reconstruction:
    """12 images on an arc, ~3,500 points each seen by ~9.7 of them, as in
    the dense benchmark cell's workspace."""
    rng = np.random.default_rng(seed)
    rec = Reconstruction()
    rec.add_camera(Camera(camera_id=1, model_id=1, width=640, height=480,
                          params=np.array([535.4, 539.2, 320.1, 247.6])))
    for k in range(12):
        phi = 0.0628 * k
        center = 2.6 * np.array([np.cos(phi), 0.0, np.sin(phi)])
        rec.add_image(Image(image_id=k + 1, name=f"frame{k:06d}.png",
                            camera_id=1,
                            cam_from_world=_look_at(center, np.zeros(3))))
    for _ in range(3500):
        xyz = rng.uniform(-4, 4, 3) * np.array([1.0, 0.5, 1.0])
        length = int(min(12, max(2, round(rng.normal(9.9, 2.0)))))
        first = int(rng.integers(0, 13 - length))
        rec.points3D[len(rec.points3D) + 1] = Point3D(
            xyz=xyz, track=[(first + j + 1, 0) for j in range(length)])
    return rec


CASES = {
    "some_unregistered_one_blind": lambda: _random_reconstruction(
        1, 17, 600, 12, unregistered=3, blind=True),
    "few_images": lambda: _random_reconstruction(2, 5, 200, 5, unregistered=1),
    "long_tracks": lambda: _random_reconstruction(3, 30, 400, 25,
                                                  unregistered=4),
    "points_behind_cameras": lambda: _random_reconstruction(
        4, 12, 500, 9, spread=4.0),
    # every angle >= 10 degrees: scores are whole numbers and tie
    "whole_number_ties": lambda: _random_reconstruction(
        5, 8, 150, 4, spread=0.05, ring=1.0),
    "cell_scale": lambda: _cell_scale_reconstruction(6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_model_matches_the_loop(case):
    rec = CASES[case]()
    ref = _build_model_loop(rec)
    got = mvs_model.build_model(rec)
    assert list(got.images) == list(ref.images)
    assert list(got.depth_ranges) == list(ref.depth_ranges)
    assert list(got.overlap_scores) == list(ref.overlap_scores)
    for iid, im in ref.images.items():
        g = got.images[iid]
        for f in ("K", "R", "t"):
            np.testing.assert_array_equal(getattr(g, f), getattr(im, f))
        np.testing.assert_allclose(got.depth_ranges[iid],
                                   ref.depth_ranges[iid], rtol=1e-12)
        # the bounds the solver receives
        assert np.float32(got.depth_ranges[iid]).tolist() == np.float32(
            ref.depth_ranges[iid]).tolist()
        assert [s for s, _ in got.overlap_scores[iid]] == [
            s for s, _ in ref.overlap_scores[iid]]
        np.testing.assert_allclose([v for _, v in got.overlap_scores[iid]],
                                   [v for _, v in ref.overlap_scores[iid]],
                                   rtol=1e-12)
        assert got.src_images(iid) == ref.src_images(iid)
    # the same dot routine and summation order as the loop: the same bits
    assert got.depth_ranges == ref.depth_ranges
    assert got.overlap_scores == ref.overlap_scores
    scores = [v for ranked in ref.overlap_scores.values() for _, v in ranked]
    assert scores
    if case == "whole_number_ties":
        assert all(v == int(v) for v in scores)
        assert len(set(scores)) < len(scores) / 2  # ties decide the order
    if case == "some_unregistered_one_blind":
        unseen = [iid for iid, ranked in ref.overlap_scores.items()
                  if not ranked]
        assert len(unseen) == 1 and len(ref.images) == 14
    if case == "points_behind_cameras":
        rec_images = got.images.values()
        assert any(im.R[2] @ p.xyz + im.t[2] <= 0
                   for p in rec.points3D.values() for im in rec_images)
    if case == "cell_scale":
        lengths = [len(p.track) for p in rec.points3D.values()]
        assert 9.2 <= np.mean(lengths) <= 10.2


def test_build_model_without_points_or_images():
    rec = _random_reconstruction(7, 4, 0, 3)
    got, ref = mvs_model.build_model(rec), _build_model_loop(rec)
    assert got.depth_ranges == ref.depth_ranges
    assert got.overlap_scores == ref.overlap_scores
    for im in rec.images.values():
        im.cam_from_world = None
    got = mvs_model.build_model(rec)
    assert got.images == got.depth_ranges == got.overlap_scores == {}


def test_every_job_builds_the_model_from_disk(tmp_path, monkeypatch):
    """Two `run_patch_match_stereo` calls on one workspace, with `sparse/`
    rewritten between them so that image 1's best source sees none of its
    points: the second call solves with the new sources."""
    from colmap_tpu_torch.controllers import dense_reconstruction as dense
    from colmap_tpu_torch.mvs import patch_match as pm
    from colmap_tpu_torch.scene import reconstruction_io
    from colmap_tpu_torch.scene import synthetic_images as synth
    from colmap_tpu_torch.sensor import bitmap
    from tests.test_torch_dense import _gt_reconstruction

    o = synth.RoomDatasetOptions(num_images=4, width=64, height=48,
                                 focal=56.0, seed=5)
    room = synth.render_room_dataset(o, return_depth=True) + (o,)
    ws = str(tmp_path)
    synth.write_dataset(os.path.join(ws, "images"), room[0])
    for sub in ("sparse", "stereo/depth_maps", "stereo/normal_maps"):
        os.makedirs(os.path.join(ws, sub), exist_ok=True)
    rec = _gt_reconstruction(room, n_points=300)
    names = {iid: im.name for iid, im in rec.images.items()}
    pixels = {iid: torch.as_tensor(bitmap.read_bitmap(
        os.path.join(ws, "images", name)).data) for iid, name in names.items()}

    solved = {}

    def record(draws, problem, opts, *args, **kwargs):
        def which(x):
            (iid,) = [i for i, p in pixels.items() if torch.equal(p, x)]
            return iid
        solved[which(problem.ref_image)] = [which(s)
                                            for s in problem.src_images]
        H, W = problem.ref_image.shape
        return torch.zeros(H, W), torch.zeros(H, W, 3), None

    monkeypatch.setattr(pm, "patch_match", record)
    options = dense.PatchMatchStereoOptions(geom_consistency=False,
                                            max_num_src_images=2)
    sources = []
    for _ in range(2):
        reconstruction_io.write_model(rec, os.path.join(ws, "sparse"),
                                      ext=".bin")
        solved.clear()
        dense.run_patch_match_stereo(ws, options, device="cpu")
        sources.append(dict(solved))
        expect = mvs_model.build_model(rec)
        assert sources[-1] == {iid: expect.src_images(iid, 2)
                               for iid in names}
        best = sources[-1][1][0]
        for pt in rec.points3D.values():
            pt.track = [(iid, j) for iid, j in pt.track if iid != best]
    assert sources[1][1] != sources[0][1]
    assert sources[0][1][0] not in sources[1][1]
