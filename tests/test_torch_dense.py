"""The port's dense controllers on the CPU.

They run on tests/test_mvs.py's 4-image 160x120 room workspace (ground-truth
poses, a sparse sampling of surface points) with 3 sources as there, but 2
iterations and one refinement iteration where JAX's test has 3 and 3, to
keep the file within a minute on 2 threads, and are held to its gates: PatchMatch
(photometric, then geometric) gives every image a map, fusion > 2,000 points
with > 70% within 0.05 x room size of the room's faces, the Poisson mesh >
500 vertices and faces with a median vertex distance < 0.08 x room size;
downscaled to 80 px, > 500 points with > 60% within 0.07 x room size. The
Delaunay mesher runs on the fused cloud.
"""

import os

import numpy as np
import pytest
import torch

from colmap_tpu_torch.controllers import dense_reconstruction as dense
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.mvs import fusion as fusion_mod
from colmap_tpu_torch.mvs import meshing as meshing_mod
from colmap_tpu_torch.mvs import patch_match as pm
from colmap_tpu_torch.scene import reconstruction_io
from colmap_tpu_torch.scene import synthetic_images as synth
from colmap_tpu_torch.scene.reconstruction import Camera, Image, Reconstruction

torch.set_num_threads(2)


def _poses(Rs, ts, names):
    out = []
    for R, t, name in zip(Rs, ts, names):
        q = rot.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32))
        out.append((name, np.concatenate([q.numpy(), t]).astype(np.float64)))
    return out


def _gt_reconstruction(room, n_points=400):
    """tests/test_mvs.py's ground truth: the poses and a sparse sampling of
    image 0's surface points (for the depth ranges and sources)."""
    images, K, Rs, ts, depths, o = room
    rec = Reconstruction()
    rec.add_camera(Camera(camera_id=1, model_id=1, width=o.width,
                          height=o.height,
                          params=np.array([K[0, 0], K[1, 1], K[0, 2],
                                           K[1, 2]])))
    names = [f"image{i:04d}.png" for i in range(len(images))]
    for i, (name, pose) in enumerate(_poses(Rs, ts, names)):
        img = Image(image_id=i + 1, name=name, camera_id=1,
                    cam_from_world=pose)
        img.xys = np.zeros((n_points, 2))
        img.point3D_ids = np.full(n_points, -1, np.int64)
        rec.add_image(img)
    rng = np.random.default_rng(0)
    gt0 = depths[0]
    ys, xs = np.nonzero(gt0 > 0)
    sel = rng.choice(len(ys), n_points, replace=False)
    Kinv = np.linalg.inv(K)
    for j, s in enumerate(sel):
        y, x = ys[s], xs[s]
        Xw = Rs[0].T @ (Kinv @ np.array([x + 0.5, y + 0.5, 1.0]) * gt0[y, x]
                        - ts[0])
        track = []
        for i in range(len(images)):
            Xi = Rs[i] @ Xw + ts[i]
            if Xi[2] <= 0:
                continue
            p = K @ Xi
            px, py = p[0] / p[2], p[1] / p[2]
            if 0 <= px < gt0.shape[1] and 0 <= py < gt0.shape[0]:
                rec.images[i + 1].xys[j] = (px, py)
                track.append((i + 1, j))
        if len(track) >= 2:
            rec.add_point3D(Xw, track)
    return rec


def _face_distance(xyz, s):
    return np.minimum(np.minimum(np.abs(xyz[:, 2] - s), np.abs(xyz[:, 0] - s)),
                      np.abs(xyz[:, 1] - s / 2))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    o = synth.RoomDatasetOptions(num_images=4, width=160, height=120,
                                 focal=140.0, seed=2)
    room = synth.render_room_dataset(o, return_depth=True) + (o,)
    ws = str(tmp_path_factory.mktemp("dense_ws"))
    synth.write_dataset(os.path.join(ws, "images"), room[0])
    for sub in ("sparse", "stereo/depth_maps", "stereo/normal_maps"):
        os.makedirs(os.path.join(ws, sub), exist_ok=True)
    reconstruction_io.write_model(_gt_reconstruction(room),
                                  os.path.join(ws, "sparse"), ext=".bin")
    return ws, o


def test_dense_controllers_meet_jax_gates(workspace):
    ws, o = workspace
    timings = {}
    depths = dense.run_patch_match_stereo(
        ws, dense.PatchMatchStereoOptions(
            patch_match=pm.PatchMatchOptions(num_iterations=2,
                                             num_refinement_iterations=1),
            max_num_src_images=3, geom_consistency=True),
        device="cpu", timings=timings)
    assert len(depths) == 4 and timings["maps"] == 4
    for name in (f"image{i:04d}.png" for i in range(4)):
        for kind in ("depth_maps", "normal_maps"):
            assert os.path.exists(os.path.join(
                ws, "stereo", kind, f"{name}.geometric.bin"))
    cloud = dense.run_stereo_fusion(
        ws, fusion_mod.StereoFusionOptions(
            min_num_pixels=3, max_depth_error=0.03, max_normal_error_deg=25.0),
        device="cpu")
    assert len(cloud["xyz"]) > 2000
    s = o.room_size
    near = (_face_distance(cloud["xyz"], s) < 0.05 * s).mean()
    assert near > 0.7, near
    assert os.listdir(os.path.join(ws, "stereo", "consistency_graphs"))
    verts, faces = dense.run_poisson_mesher(
        os.path.join(ws, "fused.ply"), os.path.join(ws, "meshed-poisson.ply"),
        meshing_mod.PoissonMeshingOptions(depth=7), device="cpu")
    assert len(verts) > 500 and len(faces) > 500
    assert np.median(_face_distance(verts, s)) < 0.08 * s


def test_dense_controllers_downscaled(workspace):
    """max_image_size: stereo at half size with the calibration scaled
    (runs after the full-size test and overwrites the photometric maps)."""
    ws, o = workspace
    target = max(o.width, o.height) // 2
    depths = dense.run_patch_match_stereo(
        ws, dense.PatchMatchStereoOptions(
            patch_match=pm.PatchMatchOptions(num_iterations=2,
                                             num_refinement_iterations=1),
            max_num_src_images=3, geom_consistency=False,
            max_image_size=target), device="cpu")
    assert len(depths) == 4
    assert all(max(d.shape) == target for d in depths.values())
    cloud = dense.run_stereo_fusion(
        ws, fusion_mod.StereoFusionOptions(
            min_num_pixels=3, max_depth_error=0.05, max_normal_error_deg=30.0),
        input_type="photometric", max_image_size=target, device="cpu")
    assert len(cloud["xyz"]) > 500
    s = o.room_size
    near = (_face_distance(cloud["xyz"], s) < 0.07 * s).mean()
    assert near > 0.6, near


def test_delaunay_mesher_on_the_fused_cloud(workspace):
    ws, _ = workspace
    verts, faces = dense.run_delaunay_mesher(
        ws, os.path.join(ws, "meshed-delaunay.ply"))
    assert len(verts) > 0 and len(faces) > 0
    assert faces.max() < len(verts)


def test_patch_match_spans_name_each_problems_card(workspace):
    """Round robin over 4 CPU shards: each card's upload, solve and fetch
    spans carry its rank and hold the frames `order[rank::4]` in both
    passes, each pass its count of cards. One card's first map is the
    same bits as card 0's on 4 shards: both draw from seed + 0 first."""
    from colmap_tpu_torch.util import timer

    ws, _ = workspace

    def run(num_devices, geom):
        return dense.run_patch_match_stereo(ws, dense.PatchMatchStereoOptions(
            patch_match=pm.PatchMatchOptions(num_iterations=1,
                                             num_refinement_iterations=0),
            max_num_src_images=3, geom_consistency=geom,
            num_devices=num_devices), device="cpu")

    order = sorted(run(4, True))
    spans = timer.last_job("dense.patch_match_stereo")
    passes = [s for s in spans if s.name == "dense.pass"]
    assert [(p.attrs["pass"], p.attrs["cards"]) for p in passes] == [
        ("photometric", 4), ("geometric", 4)]
    for p in passes:
        solves = [s for s in spans if s.name == "dense.solve"
                  and s.parent == p.id]
        for rank in range(4):
            got = [s.attrs["image_id"] for s in solves
                   if s.attrs["card"] == rank]
            assert got == order[rank::4], (p.attrs["pass"], rank, got)
    for name in ("dense.upload", "dense.fetch"):
        assert {s.attrs["card"] for s in spans if s.name == name} == {
            0, 1, 2, 3}

    one = run(1, False)
    spans = timer.last_job("dense.patch_match_stereo")
    assert {s.attrs["card"] for s in spans if s.name in (
        "dense.upload", "dense.solve", "dense.fetch")} == {0}
    assert [s.attrs["cards"] for s in spans if s.name == "dense.pass"] == [1]
    np.testing.assert_array_equal(one[order[0]], run(4, False)[order[0]])
