"""The port's MVS model, fusion and meshing against the JAX package, on the
CPU.

Held on the same inputs: depth / normal maps, consistency graphs, fused
and mesh PLY files written by one package and read by the other
(byte-equal); `build_model` on tests/test_mvs.py's ground-truth room model
(ids and sources exact, depth ranges and overlap scores 1e-6); fusion of
the same depth and normal maps (>= 99.5% of the points matched within
1e-4, consistency graphs equal on >= 99.5% of their pixels); the splat
(1e-5) and the FFT Poisson solve (chi within 1e-4 of its max);
`surface_nets` on the same field (exact); `delaunay_mesh` (the same faces);
the LRU caches and the MVS workspace (the same evictions and arrays);
and `poisson_mesh` of a sphere (JAX's vertex gate, face count within 1%).
Last, `run_automatic_reconstruction(dense=True, device="cpu")` from pixels to
fused.ply and meshed-poisson.ply on a 4-image 200x150 room, with PatchMatch
cut (5x5 window, two iterations) to keep the file within a minute and
tests/test_mvs.py's fusion thresholds: its cloud is held to the room's faces
in the ground truth's frame.
"""

import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax.numpy as jnp

from colmap_tpu.geometry import rotation as jrot
from colmap_tpu.mvs import consistency_graph as jcg
from colmap_tpu.mvs import depth_map as jdm
from colmap_tpu.mvs import fusion as jfusion
from colmap_tpu.mvs import meshing as jmesh
from colmap_tpu.mvs import model as jmodel
from colmap_tpu.scene import reconstruction as jrecon
from colmap_tpu.scene import synthetic_images as synth
from colmap_tpu_torch.controllers import automatic_reconstruction as ar
from colmap_tpu_torch.controllers import dense_reconstruction as dense
from colmap_tpu_torch.estimators.similarity_transform import (
    compare_reconstructions,
)
from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.geometry import sim3
from colmap_tpu_torch.mvs import consistency_graph as tcg
from colmap_tpu_torch.mvs import depth_map as tdm
from colmap_tpu_torch.mvs import fusion as tfusion
from colmap_tpu_torch.mvs import meshing as tmesh
from colmap_tpu_torch.mvs import model as tmodel
from colmap_tpu_torch.mvs import patch_match as pm
from colmap_tpu_torch.scene import reconstruction as trecon
from colmap_tpu_torch.scene import synthetic_images as tsynth
from colmap_tpu_torch.scene.reconstruction import Camera, Image, Reconstruction
from colmap_tpu_torch.sensor import bitmap

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def room():
    o = synth.RoomDatasetOptions(num_images=4, width=160, height=120,
                                 focal=140.0, seed=2)
    images, K, Rs, ts, depths = synth.render_room_dataset(o,
                                                          return_depth=True)
    return dict(images=images, K=K, Rs=Rs, ts=ts, depths=depths, opts=o)


def gt_reconstructions(room, n_points=400):
    """tests/test_mvs.py's ground-truth model (poses and a sparse sampling
    of image 0's surface points), built in both packages' classes."""
    o, K = room["opts"], room["K"]
    n = len(room["images"])
    recs = (jrecon.Reconstruction(), trecon.Reconstruction())
    mods = (jrecon, trecon)
    for rec, mod in zip(recs, mods):
        rec.add_camera(mod.Camera(
            camera_id=1, model_id=1, width=o.width, height=o.height,
            params=np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])))
    for i in range(n):
        q = np.asarray(jrot.rotmat_to_quat(jnp.asarray(room["Rs"][i],
                                                       np.float32)))
        pose = np.concatenate([q, room["ts"][i]]).astype(np.float64)
        for rec, mod in zip(recs, mods):
            img = mod.Image(image_id=i + 1, name=f"image{i:04d}.png",
                            camera_id=1, cam_from_world=pose.copy())
            img.xys = np.zeros((n_points, 2))
            img.point3D_ids = np.full(n_points, -1, np.int64)
            rec.add_image(img)
    rng = np.random.default_rng(0)
    gt0 = room["depths"][0]
    ys, xs = np.nonzero(gt0 > 0)
    sel = rng.choice(len(ys), n_points, replace=False)
    Kinv = np.linalg.inv(K)
    for j, s in enumerate(sel):
        y, x = ys[s], xs[s]
        Xc = Kinv @ np.array([x + 0.5, y + 0.5, 1.0]) * gt0[y, x]
        Xw = room["Rs"][0].T @ (Xc - room["ts"][0])
        track = []
        for i in range(n):
            Xi = room["Rs"][i] @ Xw + room["ts"][i]
            if Xi[2] <= 0:
                continue
            p = K @ Xi
            px, py = p[0] / p[2], p[1] / p[2]
            if 0 <= px < gt0.shape[1] and 0 <= py < gt0.shape[0]:
                for rec in recs:
                    rec.images[i + 1].xys[j] = (px, py)
                track.append((i + 1, j))
        if len(track) >= 2:
            for rec in recs:
                rec.add_point3D(Xw, track)
    return recs


def gt_maps(room, noise=0.002, seed=1):
    """Per image id: the rendered depth (times 1 + noise * N(0, 1)) and the
    camera-frame normal of the room face under each pixel, facing the
    camera."""
    rng = np.random.default_rng(seed)
    s = room["opts"].room_size
    Kinv = np.linalg.inv(room["K"])
    depths, normals = {}, {}
    for i, d in enumerate(room["depths"]):
        h, w = d.shape
        ys, xs = np.mgrid[0:h, 0:w]
        rays = np.stack([xs + 0.5, ys + 0.5, np.ones((h, w))], -1) @ Kinv.T
        R, t = room["Rs"][i], room["ts"][i]
        Xw = (rays * d[..., None] - t) @ R
        face = np.argmin(np.stack([np.abs(Xw[..., 2] - s),
                                   np.abs(Xw[..., 0] - s),
                                   np.abs(Xw[..., 1] - s / 2)]), 0)
        n_w = np.array([[0, 0, -1.0], [-1.0, 0, 0], [0, -1.0, 0]])[face]
        n_c = np.where((d > 0)[..., None], n_w @ R.T, 0.0)
        depths[i + 1] = (d * (1 + noise * rng.normal(size=d.shape))
                         ).astype(np.float32) * (d > 0)
        normals[i + 1] = n_c.astype(np.float32)
    return depths, normals


# -- files ---------------------------------------------------------------------


def test_map_and_graph_files_are_byte_equal(tmp_path):
    rng = np.random.default_rng(2)
    depth = rng.uniform(0, 5, (7, 9)).astype(np.float32)
    normal = rng.normal(size=(7, 9, 3)).astype(np.float32)
    masks = rng.uniform(size=(3, 12, 16)) < 0.2
    ids = [4, 7, 9]
    for name, jobj, tobj, tcls in (
            ("d.bin", jdm.DepthMap(depth), tdm.DepthMap(depth), tdm.DepthMap),
            ("n.bin", jdm.NormalMap(normal), tdm.NormalMap(normal),
             tdm.NormalMap),
            ("cg.bin", jcg.ConsistencyGraph.from_masks(masks, ids),
             tcg.ConsistencyGraph.from_masks(masks, ids),
             tcg.ConsistencyGraph)):
        pj, pt = str(tmp_path / f"jax_{name}"), str(tmp_path / f"port_{name}")
        jobj.write(pj)
        tobj.write(pt)
        data = open(pj, "rb").read()
        assert open(pt, "rb").read() == data
        # the port reads JAX's file and writes the same bytes back
        tcls.read(pj).write(pt)
        assert open(pt, "rb").read() == data
    g = tcg.ConsistencyGraph.read(str(tmp_path / "jax_cg.bin"))
    for r in range(12):
        for c in range(16):
            assert list(g.image_idxs(r, c)) == [
                k for k, m in zip(ids, masks[:, r, c]) if m]


def test_ply_files_are_byte_equal(tmp_path):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    nrm = rng.normal(size=(50, 3)).astype(np.float32)
    col = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    faces = rng.integers(0, 50, (40, 3))
    for args in ((xyz,), (xyz, nrm), (xyz, nrm, col)):
        pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
        jfusion.write_ply(pj, *args)
        tfusion.write_ply(pt, *args)
        assert open(pj, "rb").read() == open(pt, "rb").read()
        back = tfusion.read_ply(pj)
        ref = jfusion.read_ply(pt)
        assert sorted(back) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(back[k], ref[k])
    jmesh.write_mesh_ply(pj, xyz, faces)
    tmesh.write_mesh_ply(pt, xyz, faces)
    assert open(pj, "rb").read() == open(pt, "rb").read()


def test_caches_and_workspace_match_jax(tmp_path):
    """util/cache.py and mvs/workspace.py, host copies: the same access
    sequence evicts the same keys and serves the same arrays."""
    from colmap_tpu.mvs import workspace as jws
    from colmap_tpu.util import cache as jcache
    from colmap_tpu_torch.mvs import workspace as tws
    from colmap_tpu_torch.util import cache as tcache

    keys = [1, 2, 3, 1, 4, 2, 5, 1, 3, 6, 2]
    for mod in (jcache, tcache):
        calls = []
        c = mod.LRUCache(3, getter=lambda k: calls.append(k) or k * 10)
        m = mod.MemoryConstrainedLRUCache(
            100, getter=lambda k: np.zeros(10 * k, np.uint8))
        t = mod.ThreadSafeLRUCache(2, getter=lambda k: -k)
        trace = [(c.get(k), sorted(k2 for k2 in range(7) if c.exists(k2)),
                  m.get(k).nbytes, m.num_bytes, t.get(k)) for k in keys]
        if mod is jcache:
            ref, ref_calls = trace, calls
    assert trace == ref and calls == ref_calls

    ws = str(tmp_path)
    os.makedirs(os.path.join(ws, "images"))
    for sub in ("depth_maps", "normal_maps"):
        os.makedirs(os.path.join(ws, "stereo", sub))
    rng = np.random.default_rng(0)
    names = {}
    for i in range(4):
        names[i + 1] = name = f"im{i}.png"
        (jdm.DepthMap if i % 2 else tdm.DepthMap)(
            rng.uniform(1, 5, (40, 50)).astype(np.float32)).write(
            os.path.join(ws, "stereo", "depth_maps", f"{name}.geometric.bin"))
        (jdm.NormalMap if i % 2 else tdm.NormalMap)(
            rng.normal(0, 1, (40, 50, 3)).astype(np.float32)).write(
            os.path.join(ws, "stereo", "normal_maps", f"{name}.geometric.bin"))
        bitmap.write_bitmap(os.path.join(ws, "images", name),
                            rng.uniform(0, 1, (40, 50)).astype(np.float32))
    cap = 3 * 40 * 50 * 4 * 3
    wj = jws.Workspace(jws.WorkspaceOptions(workspace_path=ws,
                                            max_cache_bytes=cap), names)
    wt = tws.Workspace(tws.WorkspaceOptions(workspace_path=ws,
                                            max_cache_bytes=cap), names)
    for i in (1, 2, 3, 4, 2, 1):
        assert wt.has_depth_map(i) == wj.has_depth_map(i)
        for fn in ("depth_map", "normal_map", "bitmap"):
            np.testing.assert_array_equal(getattr(wt, fn)(i),
                                          getattr(wj, fn)(i))
        assert wt.num_bytes_cached == wj.num_bytes_cached <= cap
    assert wt.depth_map(1) is wt.depth_map(1)


# -- the MVS model and fusion ----------------------------------------------------


def test_build_model_matches_jax(room):
    jrec, trec = gt_reconstructions(room)
    ref = jmodel.build_model(jrec)
    got = tmodel.build_model(trec)
    assert sorted(got.images) == sorted(ref.images)
    for iid, im in ref.images.items():
        g = got.images[iid]
        assert (g.name, g.width, g.height) == (im.name, im.width, im.height)
        np.testing.assert_allclose(g.K, im.K, atol=1e-12)
        np.testing.assert_allclose(g.R, im.R, atol=1e-12)
        np.testing.assert_allclose(g.t, im.t, atol=1e-12)
        np.testing.assert_allclose(got.depth_ranges[iid],
                                   ref.depth_ranges[iid], rtol=1e-6)
        assert got.src_images(iid, 2) == ref.src_images(iid, 2)
        assert got.src_images(iid) == ref.src_images(iid)
        assert [s for s, _ in got.overlap_scores[iid]] == [
            s for s, _ in ref.overlap_scores[iid]]
        np.testing.assert_allclose([v for _, v in got.overlap_scores[iid]],
                                   [v for _, v in ref.overlap_scores[iid]],
                                   rtol=1e-6)
    # an image without shared points falls back to the nearest cameras
    got.overlap_scores[2] = []
    ref.overlap_scores[2] = []
    assert got.src_images(2) == ref.src_images(2)


def test_fusion_matches_jax(room):
    jrec, trec = gt_reconstructions(room)
    jm, tm = jmodel.build_model(jrec), tmodel.build_model(trec)
    depths, normals = gt_maps(room)
    images = {i + 1: im.astype(np.float32) / 255.0
              for i, im in enumerate(room["images"])}
    opts = dict(min_num_pixels=3, max_depth_error=0.01,
                max_normal_error_deg=10.0)
    jg, tg = {}, {}
    ref = jfusion.fuse(jm, depths, normals, images,
                       jfusion.StereoFusionOptions(**opts), consistency_out=jg)
    got = tfusion.fuse(tm, depths, normals, images,
                       tfusion.StereoFusionOptions(**opts), consistency_out=tg,
                       device="cpu")
    assert len(ref["xyz"]) > 2000
    assert abs(len(got["xyz"]) - len(ref["xyz"])) <= 0.005 * len(ref["xyz"])
    for a, b in ((ref, got), (got, ref)):
        dist, idx = cKDTree(b["xyz"]).query(a["xyz"])
        match = dist <= 1e-4
        assert match.mean() >= 0.995, match.mean()
        np.testing.assert_allclose(a["normal"][match], b["normal"][idx[match]],
                                   atol=1e-4)
        np.testing.assert_array_equal(a["color"][match], b["color"][idx[match]])
    assert sorted(tg) == sorted(jg)
    equal = total = 0
    for iid, g in jg.items():
        h, w = g.height, g.width
        assert (tg[iid].width, tg[iid].height) == (w, h)
        for r in range(h):
            for c in range(w):
                a = list(g.image_idxs(r, c))
                b = list(tg[iid].image_idxs(r, c))
                if a or b:
                    total += 1
                    equal += a == b
    assert total > 2000 and equal / total >= 0.995, (equal, total)


# -- meshing -------------------------------------------------------------------


def _sphere_cloud(n=4000, seed=4):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    xyz = (v * 1.5 + [0.2, -0.1, 3.0]).astype(np.float32)
    return xyz, v.astype(np.float32)


def test_splat_and_poisson_solve_match_jax():
    xyz, nrm = _sphere_cloud()
    u = (xyz - xyz.min(0) + 0.1) / (np.ptp(xyz, 0).max() + 0.2)
    n = 32
    for vals in (nrm, np.ones(len(u), np.float32)):
        ref = np.asarray(jmesh._splat_points(u, vals, n))
        got = tmesh._splat_points(u, vals, n, device="cpu").numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)
    div = np.random.default_rng(5).normal(size=(n, n, n)).astype(np.float32)
    ref = np.asarray(jmesh._poisson_solve_fft(jnp.asarray(div),
                                              jnp.asarray(np.float32(1e-2))))
    got = tmesh._poisson_solve_fft(torch.as_tensor(div), 1e-2).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_surface_nets_is_the_same():
    n = 24
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    field = np.sqrt(((g - n / 2) ** 2).sum(0)) - n / 4
    field += 0.3 * np.sin(g[0] / 3.0)
    vj, fj = jmesh.surface_nets(field)
    vt, ft = tmesh.surface_nets(field)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    assert len(ft) > 100


def test_delaunay_mesh_is_the_same():
    rng = np.random.default_rng(6)
    xyz = np.concatenate([rng.uniform(-1, 1, (150, 3)) * [1, 1, 0.05]
                          + [0, 0, 3.0],
                          rng.uniform(-1, 1, (50, 3))]).astype(np.float64)
    cams = np.array([[0, 0, 0.0], [0.5, 0, 0.2], [-0.5, 0.1, 0.1]])
    vj, fj = jmesh.delaunay_mesh(xyz, cams)
    vt, ft = tmesh.delaunay_mesh(xyz, cams)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    assert len(ft) > 0


def test_poisson_mesh_matches_jax():
    xyz, nrm = _sphere_cloud()
    vj, fj = jmesh.poisson_mesh(xyz, nrm, jmesh.PoissonMeshingOptions(depth=6))
    vt, ft = tmesh.poisson_mesh(xyz, nrm, tmesh.PoissonMeshingOptions(depth=6),
                                device="cpu")
    assert abs(len(ft) - len(fj)) <= 0.01 * len(fj)
    for v in (vj, vt):
        rad = np.linalg.norm(v - [0.2, -0.1, 3.0], axis=1)
        assert np.median(np.abs(rad - 1.5)) < 0.05
    dist, _ = cKDTree(vj).query(vt)
    assert np.median(dist) < 1e-3


# -- the dense branch of the one-click pipeline ----------------------------------


def test_automatic_reconstruction_dense_on_cpu(tmp_path, monkeypatch):
    """run_automatic_reconstruction(dense=True, device="cpu") from pixels to
    fused.ply and meshed-poisson.ply on a 4-image 200x150 room."""
    o = tsynth.RoomDatasetOptions(num_images=4, width=200, height=150,
                                 focal=175.0, seed=5)
    images, K, Rs, ts = tsynth.render_room_dataset(o)
    names = tsynth.write_dataset(str(tmp_path / "images"), images)
    # the JAX package's stereo defaults cost ~1 min per map on this CPU:
    # the same controllers with a 5x5 window and two iterations, and
    # tests/test_mvs.py's fusion thresholds for such noisier maps
    run, fuse = dense.run_patch_match_stereo, dense.run_stereo_fusion
    cut = dense.PatchMatchStereoOptions(patch_match=pm.PatchMatchOptions(
        window_radius=2, num_iterations=2, num_refinement_iterations=1))
    loose = tfusion.StereoFusionOptions(
        min_num_pixels=3, max_depth_error=0.03, max_normal_error_deg=25.0)
    monkeypatch.setattr(dense, "run_patch_match_stereo",
                        lambda path, **kw: run(path, cut, **kw))
    monkeypatch.setattr(dense, "run_stereo_fusion",
                        lambda path, **kw: fuse(path, loose, **kw))
    stages = {}
    rec, db = ar.run_automatic_reconstruction(
        ar.AutomaticReconstructionOptions(
            workspace_path=str(tmp_path / "ws"),
            image_path=str(tmp_path / "images"), quality=ar.Quality.LOW,
            camera_model="PINHOLE", single_camera=True, sparse=True,
            dense=True,
            camera_params=",".join(map(str, [K[0, 0], K[1, 1], K[0, 2],
                                             K[1, 2]]))),
        stage_timings=stages, device="cpu")
    assert rec is not None and rec.num_registered_images() == 4
    for k in ("undistortion", "patch_match_photometric",
              "patch_match_geometric", "fusion", "meshing"):
        assert stages[k] > 0
    assert stages["patch_match_maps"] == 4
    dense_dir = str(tmp_path / "ws" / "dense")
    for name in names:
        for kind in ("depth_maps", "normal_maps"):
            assert os.path.exists(os.path.join(
                dense_dir, "stereo", kind, f"{name}.geometric.bin"))

    ids = {im["name"]: iid for iid, im in db.read_images().items()}
    gt = Reconstruction()
    gt.add_camera(Camera(camera_id=1, model_id=1, width=o.width,
                         height=o.height,
                         params=np.array([K[0, 0], K[1, 1], K[0, 2],
                                          K[1, 2]])))
    for name, R, t in zip(names, Rs, ts):
        q = rot.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32))
        gt.add_image(Image(image_id=ids[name], name=name, camera_id=1,
                           cam_from_world=np.concatenate([q.numpy(), t])))
    # the sparse stage is held elsewhere (tests/test_torch_frontend.py);
    # this small room registers at ~0.8 deg, enough to place the cloud
    to_gt = torch.as_tensor(compare_reconstructions(rec, gt,
                                                    device="cpu")["sim3"])

    def in_gt(xyz):
        return sim3.apply(to_gt, torch.as_tensor(xyz, dtype=torch.float64)
                          ).numpy()

    s = o.room_size
    cloud = tfusion.read_ply(os.path.join(dense_dir, "fused.ply"))
    assert len(cloud["xyz"]) > 500
    xyz = in_gt(cloud["xyz"])
    near = (np.minimum(np.minimum(np.abs(xyz[:, 2] - s), np.abs(xyz[:, 0] - s)),
                       np.abs(xyz[:, 1] - s / 2)) < 0.05 * s).mean()
    assert near > 0.7, near
    with open(os.path.join(dense_dir, "meshed-poisson.ply"), "rb") as f:
        header = f.read(256).split(b"end_header")[0].decode()
    n_verts = int(header.split("element vertex ")[1].split()[0])
    n_faces = int(header.split("element face ")[1].split()[0])
    assert n_verts > 100 and n_faces > 100
    db.close()
