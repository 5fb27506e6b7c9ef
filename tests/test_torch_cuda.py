"""Card-only checks of the port: the matcher kernel against its plain twin
at edge cases and at the VIDEO block's shape, the front end on CUDA
against the same front end on the CPU, bundle adjustment and batched PnP
registration on CUDA against the CPU, and the vocab tree's k-means and
quantiser and sequential matching with loop detection on CUDA against the
CPU, the Sim3 pose graph and robust alignment on CUDA against the CPU, the
hierarchical mapper on CUDA with three worker threads, PatchMatch,
fusion, the splat and the cuFFT Poisson solve on CUDA against the CPU, the
reverse-mode Jacobians of BA, PnP, the pose graph and undistortion, rig
BA, prior BA and the BA covariances on CUDA against the CPU, the command
line from pixels to a model on CUDA, the affine + DSP SIFT variants
and the least-squares affine fit on CUDA against the CPU, and the
multi-device slice: sharded matching on four virtual shards of one card
against one shard, the pose-sharded BA on the card against the CPU, and
both on two real cards where the machine has them. Every test
needs a CUDA device and the CUDA toolkit and skips without
them. This file imports neither jax nor colmap_tpu, so it also runs on a
machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest -o addopts=""
"""

import os
import shutil

import numpy as np
import pytest
import torch

from colmap_tpu_torch import bench_ba, bench_matcher, bench_rig
from colmap_tpu_torch.controllers import automatic_reconstruction as ar
from colmap_tpu_torch.controllers import dense_reconstruction as dense
from colmap_tpu_torch.controllers import feature_extraction as fe
from colmap_tpu_torch.controllers import feature_matching as fm
from colmap_tpu_torch.controllers import hierarchical_pipeline as hp
from colmap_tpu_torch.controllers.incremental_pipeline import (
    IncrementalPipeline, IncrementalPipelineOptions)
from colmap_tpu_torch.estimators import absolute_pose as ap
from colmap_tpu_torch.estimators import alignment as align
from colmap_tpu_torch.estimators import bundle_adjustment as ba
from colmap_tpu_torch.estimators import covariance as cov
from colmap_tpu_torch.estimators import pose_prior_ba as pba
from colmap_tpu_torch.estimators import pose_graph as pg
from colmap_tpu_torch.estimators import similarity_transform as st
from colmap_tpu_torch.geometry import rigid3, rotation as rot
from colmap_tpu_torch.geometry import sim3 as s3
from colmap_tpu_torch.features import hopper_matcher as hm
from colmap_tpu_torch.features import matching as tm
from colmap_tpu_torch.features import pairing
from colmap_tpu_torch.features import sift as sift_mod
from colmap_tpu_torch.image import undistortion as und
from colmap_tpu_torch.mvs import depth_map as dm
from colmap_tpu_torch.mvs import fusion as fusion_mod
from colmap_tpu_torch.mvs import meshing
from colmap_tpu_torch.mvs import model as mvs_model
from colmap_tpu_torch.mvs import patch_match as pm
from colmap_tpu_torch.parallel import distributed_ba as dba
from colmap_tpu_torch.parallel import mesh as pmesh
from colmap_tpu_torch.parallel import sharded_matching as psm
from colmap_tpu_torch.retrieval import kmeans as km
from colmap_tpu_torch.retrieval import visual_index as vi_mod
from colmap_tpu_torch.scene import reconstruction_io as rio
from colmap_tpu_torch.scene import synthetic as tsyn
from colmap_tpu_torch.scene import synthetic_images as synth
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.reconstruction import Camera, Image, Reconstruction
from colmap_tpu_torch.sensor import models as cm
from colmap_tpu_torch.sfm.incremental_mapper import _pnp_ransac_batch
from colmap_tpu_torch.tools import rig_tools

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the matcher kernel has no CPU mode")
    return "cuda"


# (kept, copy) pairs of target columns that tie for query row `kept`'s best:
# in other lanes, other 8-column mma tiles, other column warps and other
# 64-column tiles
_COLUMN_TIES = ((3, 5), (10, 19), (20, 52), (40, 104), (70, 250), (100, 164))
# (kept, copy) pairs of query rows that tie for column `kept`'s reverse best:
# in the other half of an mma tile, other mma tiles, other row warps and
# other 64-row query tiles (no index here is in a pair above)
_ROW_TIES = ((6, 14), (33, 49), (9, 41), (12, 76), (30, 230))


def _blocks(rng, B, n, m, device, dup=False):
    d1 = rng.integers(0, 200, (B, n, 128)).astype(np.uint8)
    d2 = rng.integers(0, 200, (B, m, 128)).astype(np.uint8)
    k = min(n, m)
    d2[:, :k] = np.clip(d1[:, :k].astype(int)
                        + rng.integers(-3, 4, (B, k, 128)), 0, 255)
    v1 = rng.random((B, n)) > 0.1
    v2 = rng.random((B, m)) > 0.1
    if dup is True:  # exact ties: repeated target rows and repeated query rows
        d2[:, 1::2] = d2[:, 0::2][:, : d2[:, 1::2].shape[1]]
        d1[:, 1::2] = d1[:, 0::2][:, : d1[:, 1::2].shape[1]]
    elif dup == "extremes":  # all-255 / all-0 rows: the largest and smallest
        for d in (d1, d2):  # exact dot products and row sums
            d[:, 0::7] = 255
            d[:, 3::7] = 0
        v2[:, 0] = True
    elif dup == "ties":
        for keep, copy in _COLUMN_TIES:
            d2[:, copy] = d2[:, keep]
            v2[:, [keep, copy]] = True
        for keep, copy in _ROW_TIES:
            d1[:, copy] = d1[:, keep]
            v1[:, [keep, copy]] = True
    v2[0] = False  # a pair whose targets are all padding
    return (tm.prepare_descriptors(d1, v1, device=device),
            tm.prepare_descriptors(d2, v2, device=device))


def _assert_kernel_equals_twin(b1, b2):
    before = hm.launches
    k = hm.top2_fwd_rev(b1, b2)
    assert hm.launches > before
    r = hm._top2_fwd_rev_reference(b1, b2)
    for name, a, b in zip(("best", "second", "idx", "rbest", "ridx"), k, r):
        assert torch.equal(a, b), name
    return k


@pytest.mark.parametrize("n,m,dup", [(64, 64, False), (256, 512, False),
                                     (512, 192, True), (1024, 1024, True),
                                     (256, 320, "extremes"),
                                     (256, 256, "ties")])
def test_kernel_equals_twin(cuda, n, m, dup):
    rng = np.random.default_rng(n + m)
    b1, b2 = _blocks(rng, 3, n, m, cuda, dup)
    best, second, idx, rbest, ridx = _assert_kernel_equals_twin(b1, b2)
    # the all-padding pair: sentinel values, first index
    assert (best[0] == -3e38).all() and (idx[0] == 0).all()
    out = hm.match_pairs_batch_fused(b1, b2)
    assert (out[0] == -1).all()
    if dup == "ties":  # the cases tie, and the lowest index wins
        for keep, copy in _COLUMN_TIES:
            assert (idx[1:, keep] == keep).all()
            assert (best[1:, keep] == second[1:, keep]).all()
        for keep, copy in _ROW_TIES:
            assert (ridx[:, keep] == keep).all()
    if dup == "extremes":  # all-255 rows tie: the first one wins
        assert (idx[1:, 0] == 0).all()
        assert (best[1:, 0] == second[1:, 0]).all()


def test_kernel_products_on_tensor_cores(cuda):
    from colmap_tpu_torch import cuda_build

    text = cuda_build.ptx("matcher_top2.cu")
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in text
    assert "dp4a" not in text


def test_kernel_splits_pairs_by_scratch(cuda, monkeypatch):
    rng = np.random.default_rng(5)
    b1, b2 = _blocks(rng, 7, 256, 256, cuda)
    per_pair = (256 // hm.TILE) * 256 * 8
    monkeypatch.setattr(hm, "SCRATCH_BYTES", 2 * per_pair)
    before = hm.launches
    _assert_kernel_equals_twin(b1, b2)
    assert hm.launches - before == 4  # ceil(7 / 2) chunks


def test_kernel_rejects_cpu_only_layouts(cuda):
    rng = np.random.default_rng(6)
    b1, b2 = _blocks(rng, 2, 128, 128, cuda)
    strided = tm.DescriptorBlock(b1.centered[:, ::2], b1.row_sum[:, ::2],
                                 b1.inv_norm[:, ::2], b1.valid[:, ::2])
    with pytest.raises(ValueError):
        hm.top2_fwd_rev(strided, tm.DescriptorBlock(
            *(x[:, :64] for x in b2)))
    with pytest.raises(ValueError):
        hm.top2_fwd_rev(b1, tm.DescriptorBlock(*(x.cpu() for x in b2)))


def test_front_end_cuda_matches_cpu(cuda, tmp_path):
    o = synth.RoomDatasetOptions(num_images=4, width=320, height=240,
                                 focal=280.0, seed=5)
    images, K, _, _ = synth.render_room_dataset(o)
    synth.write_dataset(str(tmp_path / "images"), images)
    params = ",".join(map(str, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))
    dbs = {}
    for dev in ("cpu", cuda):
        before = hm.launches
        _, db = ar.run_automatic_reconstruction(
            ar.AutomaticReconstructionOptions(
                workspace_path=str(tmp_path / dev),
                image_path=str(tmp_path / "images"), quality=ar.Quality.LOW,
                camera_model="PINHOLE", single_camera=True, sparse=False,
                camera_params=params), device=dev)
        assert (hm.launches > before) == (dev == cuda)
        db.close()
        dbs[dev] = Database(str(tmp_path / dev / "database.db"))
    c, g = dbs["cpu"], dbs[cuda]
    for iid in c.read_images():
        kc, kg = c.read_keypoints(iid), g.read_keypoints(iid)
        # f32 sums run in another order on the card: counts within 2%
        assert abs(len(kc) - len(kg)) <= 0.02 * len(kc)
    assert set(c.read_all_two_view_geometries()) == set(
        g.read_all_two_view_geometries())


def test_ba_cuda_matches_cpu(cuda):
    # index_add_ sums in no fixed order on the card: a tolerance, not bits
    problem, _ = bench_ba.build_problem(num_poses=40, num_points=3000,
                                        obs_per_point=5, seed=3, device="cpu")
    for refine in (False, True):
        opts = ba.BAOptions(max_iterations=8, cg_iterations=20,
                            loss="cauchy", refine_intrinsics=refine)
        cpu = ba.solve(problem, opts)
        gpu = ba.solve(ba.BAProblem(*(x.to(cuda) for x in problem)), opts)
        assert gpu.cost.device.type == "cuda"
        assert float(gpu.cost) < 0.01 * float(ba.compute_cost(problem, opts))
        np.testing.assert_allclose(float(gpu.cost), float(cpu.cost),
                                   rtol=1e-3)
        np.testing.assert_allclose(gpu.problem.poses.cpu().numpy(),
                                   cpu.problem.poses.numpy(), atol=1e-4)


def test_pnp_batch_cuda_matches_cpu(cuda):
    g = torch.Generator().manual_seed(1)
    K, N = 8, 200
    aa = 0.3 * torch.randn(K, 3, generator=g)
    t = 0.5 * torch.randn(K, 3, generator=g) + torch.tensor([0.0, 0, 4])
    pose = torch.cat([rot.quat_from_axis_angle(aa), t], 1)
    X = 2 * torch.rand(K, N, 3, generator=g) - 1
    pc = rigid3.apply(pose[:, None], X)
    uv = pc[..., :2] / pc[..., 2:]
    valid = torch.ones(K, N, dtype=torch.bool)
    valid[2, 150:] = False
    err = torch.full((K,), 4.0 / 800.0)
    out = {}
    for dev in ("cpu", cuda):
        gen = torch.Generator(device=dev).manual_seed(0)
        out[dev] = _pnp_ransac_batch(
            gen, X.to(dev), uv.to(dev), valid.to(dev), err.to(dev),
            num_samples=256)
    np.testing.assert_array_equal(out[cuda][1], out["cpu"][1])
    np.testing.assert_array_equal(out[cuda][1], valid.numpy())
    np.testing.assert_allclose(out[cuda][0], pose.numpy(), atol=1e-3)


def test_kernel_equals_twin_at_the_video_block(cuda):
    # one VIDEO pair block at Quality.LOW: 32 pairs at capacity 2048
    b1, b2 = bench_matcher.random_blocks(32, 2048, seed=32)
    _assert_kernel_equals_twin(b1, b2)


def test_kmeans_and_quantize_cuda_match_cpu(cuda):
    # 16 separated clusters and one initial centre in each: no cluster is
    # split, so no assignment sits near a tie that rounding could flip
    rng = np.random.default_rng(4)
    protos = rng.uniform(0, 255, (16, 128))
    label = np.arange(4000) % 16
    pts = np.clip(protos[label] + rng.normal(0, 6, (4000, 128)), 0, 255)
    pts = torch.as_tensor((pts / 512.0).astype(np.float32))
    init = pts[:16]
    out = {dev: km.kmeans_from_centers(pts.to(dev), init.to(dev), 15)
           for dev in ("cpu", cuda)}
    assert torch.equal(out[cuda][1].cpu(), out["cpu"][1])
    assert torch.equal(out["cpu"][1].long(), torch.as_tensor(label))
    np.testing.assert_allclose(out[cuda][0].cpu().numpy(),
                               out["cpu"][0].numpy(), atol=1e-5)
    # one tree, quantised on both devices: the direct-difference sums run
    # in another order on the card, so a word near a tie may flip
    vi = vi_mod.VisualIndex(vi_mod.VisualIndexOptions(branching=8, depth=2),
                            device="cpu")
    desc = (pts.numpy() * 512).astype(np.uint8)
    vi.build(desc, seed=0)
    words = {dev: km.quantize(vi.levels, vi._prep(desc), device=dev)
             for dev in ("cpu", cuda)}
    assert (words[cuda] == words["cpu"]).mean() >= 0.999
    # the build on the card consumes the numpy stream as on the CPU
    vg = vi_mod.VisualIndex(vi_mod.VisualIndexOptions(branching=8, depth=2),
                            device=cuda)
    vg.build(desc, seed=0)
    np.testing.assert_array_equal(vg.proj, vi.proj)
    assert [t.shape for t in vg.levels] == [t.shape for t in vi.levels]


def test_match_sequential_with_loop_detection_cuda_matches_cpu(cuda,
                                                             tmp_path):
    # a walk along the room's camera arc and back: the 10th frame, the one
    # loop-detection query, revisits the start
    o = synth.RoomDatasetOptions(num_images=12, width=320, height=240,
                                 focal=280.0, seed=5)
    images, K, _, _ = synth.render_room_dataset(o)
    arc = [0, 2, 4, 6, 8, 10, 9, 7, 5, 3]
    synth.write_dataset(str(tmp_path / "images"), [images[i] for i in arc])
    db = Database(str(tmp_path / "cpu.db"))
    fe.run_feature_extraction(
        db, str(tmp_path / "images"),
        fe.ImageReaderOptions(camera_model="PINHOLE", single_camera=True,
                              camera_params=",".join(map(str, [
                                  K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))),
        sift_mod.SiftExtractionOptions(max_image_size=1000,
                                       max_num_features=2048), device="cpu")
    db.close()
    import shutil
    shutil.copy(str(tmp_path / "cpu.db"), str(tmp_path / "gpu.db"))
    popts = pairing.SequentialPairingOptions(overlap=2, loop_detection=True)
    found = {}
    for dev, name in (("cpu", "cpu.db"), (cuda, "gpu.db")):
        db = Database(str(tmp_path / name))
        ids = [i for i, _ in sorted(db.read_images().items(),
                                    key=lambda kv: kv[1]["name"])]
        loop = pairing.sequential_loop_detection_pairs(db, ids, popts,
                                                       device=dev)
        before = hm.launches
        stats = fm.match_sequential(db, fm.FeatureMatchingOptions(), popts,
                                    device=dev)
        assert (hm.launches > before) == (dev == cuda)
        found[dev] = (loop, stats.num_pairs,
                      set(db.read_all_two_view_geometries()))
        assert (min(ids[0], ids[-1]), max(ids[0], ids[-1])) in found[dev][2]
        db.close()
    assert found[cuda][:2] == found["cpu"][:2]
    assert found[cuda][2] == found["cpu"][2]


def _sim3_ring(n=6, seed=0):
    """A noisy Sim3 ring and its chained initialization (the pose-graph
    case of tests/test_hierarchical.py, drawn with the port's functions)."""
    rng = np.random.default_rng(seed)
    gt = [torch.tensor([1.0, 1, 0, 0, 0, 0, 0, 0])]
    for _ in range(1, n):
        q = rot.quat_from_axis_angle(torch.as_tensor(
            rng.normal(0, 0.3, 3), dtype=torch.float32))
        gt.append(torch.cat([torch.tensor([np.exp(rng.normal(0, 0.1))],
                                          dtype=torch.float32), q,
                             torch.as_tensor(rng.normal(0, 1.0, 3),
                                             dtype=torch.float32)]))
    edges = np.array([(k, (k + 1) % n) for k in range(n)])
    meas = []
    for i, j in edges:
        m = s3.compose(s3.inverse(gt[j]), gt[i])
        d = s3.make(torch.tensor(np.exp(rng.normal(0, 0.01)),
                                 dtype=torch.float32),
                    rot.quat_from_axis_angle(torch.as_tensor(
                        rng.normal(0, 0.01, 3), dtype=torch.float32)),
                    torch.as_tensor(rng.normal(0, 0.01, 3),
                                    dtype=torch.float32))
        meas.append(s3.compose(m, d))
    init = [gt[0]]
    for k in range(1, n):
        init.append(s3.compose(init[k - 1], s3.inverse(meas[k - 1])))
    return (torch.stack(init).numpy(), edges, torch.stack(meas).numpy())


def test_pose_graph_cuda_matches_cpu(cuda):
    init, edges, meas = _sim3_ring()
    out = {dev: pg.optimize_sim3_pose_graph(init, edges, meas, device=dev)
           for dev in ("cpu", cuda)}
    np.testing.assert_allclose(out[cuda], out["cpu"], atol=1e-4)
    assert not np.allclose(out["cpu"], init, atol=1e-4)


@pytest.fixture(scope="module")
def hier_fixture():
    """tests/test_hierarchical.py's 12-image synthetic fixture."""
    db = Database(":memory:")
    gt = tsyn.synthesize_dataset(tsyn.SyntheticDatasetOptions(
        num_cameras=1, num_images=12, num_points3D=220, point2D_stddev=0.4,
        seed=11), db)
    return db, gt


def test_align_robust_cuda_matches_cpu(cuda, hier_fixture):
    import copy

    _, gt = hier_fixture
    ids = sorted(gt.registered_image_ids())
    rec1, rec2 = copy.deepcopy(gt), copy.deepcopy(gt)
    for iid in ids[8:]:
        rec1.images[iid].cam_from_world = None
    for iid in ids[:4]:
        rec2.images[iid].cam_from_world = None
    t = np.array([2.0, 0.3, -0.4, 0.5, 0.7071, 1.0, -2.0, 3.0])
    t[1:5] /= np.linalg.norm(t[1:5])
    rec2.transform(t)
    rec2.images[ids[5]].cam_from_world[4:7] += 3.0  # an outlier centre
    out = {dev: align.align_reconstructions_robust(rec2, rec1, device=dev)
           for dev in ("cpu", cuda)}
    np.testing.assert_allclose(out[cuda], out["cpu"], atol=1e-5)
    assert abs(out[cuda][0] - 0.5) < 1e-3


def test_hierarchical_pipeline_cuda(cuda, hier_fixture):
    db, gt = hier_fixture
    opts = hp.HierarchicalPipelineOptions(num_workers=3)
    opts.clustering.leaf_max_num_images = 5
    opts.clustering.image_overlap = 2
    pipe = hp.HierarchicalPipeline(db, opts, device=cuda)
    rec = pipe.run(seed=1)
    assert len(pipe.clusters) > 1
    assert rec is not None and rec.num_registered_images() >= 10
    cmp = st.compare_reconstructions(rec, gt, device=cuda)
    assert cmp["max_rotation_error_deg"] < 1.0, cmp
    assert cmp["max_center_error"] < 0.05, cmp


# -- dense MVS -------------------------------------------------------------------


def _pm_room(width=160, height=120, focal=140.0):
    o = synth.RoomDatasetOptions(num_images=4, width=width, height=height,
                                 focal=focal, seed=2)
    return synth.render_room_dataset(o, return_depth=True)


def _pm_problem(room, device, ref=1, srcs=(0, 2, 3)):
    images, K, Rs, ts, depths = room
    srcs = list(srcs)
    R_rel = np.stack([Rs[s] @ Rs[ref].T for s in srcs])
    t_rel = np.stack([ts[s] - R_rel[i] @ ts[ref] for i, s in enumerate(srcs)])
    gt = depths[ref]

    def put(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    return pm.PatchMatchProblem(
        ref_image=put(images[ref]) / 255.0,
        src_images=put(np.stack([images[s] for s in srcs])) / 255.0,
        K_ref=put(K), K_src=put(np.stack([K] * len(srcs))), R_rel=put(R_rel),
        t_rel=put(t_rel), depth_min=put(gt[gt > 0].min() * 0.7),
        depth_max=put(gt[gt > 0].max() * 1.3),
        src_depths=put(np.stack([depths[s] for s in srcs])))


@pytest.mark.parametrize("geom", [False, True])
def test_patch_match_cuda_matches_cpu(cuda, geom):
    """The same draws (recorded from a CPU generator) on both devices:
    >= 99% of the pixels within 1e-3 relative depth, the same filter mask
    on >= 99%."""
    room = _pm_room()
    opts = pm.PatchMatchOptions(num_iterations=3, geom_consistency=geom)
    g = torch.Generator().manual_seed(0)
    src = pm.GeneratorDraws(g, (120, 160))
    initial = src.initial()
    perts = [src.perturbation()
             for _ in range(pm.num_perturbation_draws(opts))]
    out = {}
    for dev in ("cpu", cuda):
        d, n, c = pm.patch_match(pm.RecordedDraws(initial, perts),
                                 _pm_problem(room, dev), opts)
        out[dev] = d.cpu().numpy()
    ref, got = out["cpu"], out[cuda]
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)
    assert (rel <= 1e-3).mean() >= 0.99, (rel <= 1e-3).mean()
    assert ((got > 0) == (ref > 0)).mean() >= 0.99
    assert (ref > 0).mean() > 0.4


def test_fusion_and_poisson_cuda_match_cpu(cuda):
    """Fusion of the rendered depths (with the faces' normals) on both
    devices: >= 99.5% of the points matched within 1e-4; the cuFFT Poisson
    solve within 1e-4 of chi's max; the splat within 1e-5."""
    from scipy.spatial import cKDTree

    images, K, Rs, ts, depths = _pm_room()
    rec = Reconstruction()
    rec.add_camera(Camera(camera_id=1, model_id=1, width=160, height=120,
                          params=np.array([K[0, 0], K[1, 1], K[0, 2],
                                           K[1, 2]])))
    s = 4.0
    Kinv = np.linalg.inv(K)
    ys, xs = np.mgrid[0:120, 0:160]
    rays = np.stack([xs + 0.5, ys + 0.5, np.ones((120, 160))], -1) @ Kinv.T
    dmaps, nmaps = {}, {}
    for i in range(4):
        q = rot.rotmat_to_quat(torch.as_tensor(Rs[i], dtype=torch.float32))
        rec.add_image(Image(image_id=i + 1, name=f"image{i:04d}.png",
                            camera_id=1, cam_from_world=np.concatenate(
                                [q.numpy(), ts[i]]).astype(np.float64)))
        Xw = (rays * depths[i][..., None] - ts[i]) @ Rs[i]
        face = np.argmin(np.stack([np.abs(Xw[..., 2] - s),
                                   np.abs(Xw[..., 0] - s),
                                   np.abs(Xw[..., 1] - s / 2)]), 0)
        n_w = np.array([[0, 0, -1.0], [-1.0, 0, 0], [0, -1.0, 0]])[face]
        dmaps[i + 1] = depths[i]
        nmaps[i + 1] = (n_w @ Rs[i].T * (depths[i] > 0)[..., None]).astype(
            np.float32)
    # every image sees the others through the nearest-camera fallback
    model = mvs_model.build_model(rec)
    out = {dev: fusion_mod.fuse(model, dmaps, nmaps, None, device=dev)
           for dev in ("cpu", cuda)}
    assert len(out["cpu"]["xyz"]) > 2000
    for a, b in ((out["cpu"], out[cuda]), (out[cuda], out["cpu"])):
        dist, _ = cKDTree(b["xyz"]).query(a["xyz"])
        assert (dist <= 1e-4).mean() >= 0.995

    rng = np.random.default_rng(0)
    u = rng.uniform(0, 1, (5000, 3)).astype(np.float32)
    vals = rng.normal(size=(5000, 3)).astype(np.float32)
    grids = [meshing._splat_points(u, vals, 64, device=dev).cpu().numpy()
             for dev in ("cpu", cuda)]
    np.testing.assert_allclose(grids[1], grids[0], atol=1e-5)
    div = rng.normal(size=(64, 64, 64)).astype(np.float32)
    chi = [meshing._poisson_solve_fft(torch.as_tensor(div, device=dev), 1e-2
                                      ).cpu().numpy() for dev in ("cpu", cuda)]
    np.testing.assert_allclose(chi[1], chi[0], atol=1e-4 * np.abs(chi[0]).max())


def _ba_jacobians(dev):
    problem, _ = bench_ba.build_problem(num_poses=8, num_points=400,
                                        obs_per_point=4, seed=5, device=dev)
    return ba._obs_residual_and_jac(problem,
                                    int(cm.CameraModelId.SIMPLE_RADIAL))


def _pnp_jacobians(dev):
    g = torch.Generator().manual_seed(2)
    X = 2 * torch.rand(4, 60, 3, generator=g) + torch.tensor([-1.0, -1, 4])
    uv = X[..., :2] / X[..., 2:]
    pose = torch.tensor([[1.0, 0.02, -0.01, 0.03, 0.1, -0.05, 0.2]] * 4)
    return ap._residual_and_jac(torch.zeros(4, 6, device=dev), pose.to(dev),
                                X.to(dev), uv.to(dev),
                                torch.ones(4, 60, device=dev))


def _pose_graph_step(dev):
    init, edges, meas = _sim3_ring()
    return pg.optimize_sim3_pose_graph(init, edges, meas, num_iters=1,
                                       device=dev)


def _undistortion(dev):
    g = torch.Generator().manual_seed(3)
    xy = torch.rand(500, 2, generator=g) * torch.tensor([640.0, 480.0])
    p = torch.as_tensor(cm.pad_params([300.0, 310.0, 320.0, 240.0, 0.1,
                                       -0.05, 0.01, 0.002]))
    return cm.cam_from_img(int(cm.CameraModelId.OPENCV_FISHEYE), p.to(dev),
                           xy.to(dev))


@pytest.mark.parametrize("fn", [_ba_jacobians, _pnp_jacobians,
                                _pose_graph_step, _undistortion],
                         ids=["ba", "pnp", "pose_graph", "undistortion"])
def test_reverse_mode_jacobians_cuda_match_cpu(cuda, fn):
    out = {dev: fn(dev) for dev in ("cpu", cuda)}
    pairs = zip(*(o if isinstance(o, tuple) else (o,)
                  for o in (out["cpu"], out[cuda])))
    for a, b in pairs:
        a, b = torch.as_tensor(a), torch.as_tensor(b).cpu()
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(a.abs().max())))


def test_rig_ba_cuda_matches_cpu(cuda, tmp_path):
    import json

    scene = bench_rig.build_scene(num_snapshots=8, num_points=1500, seed=3)
    recs = {}
    for dev in ("cpu", cuda):
        rec = scene.reconstruction()
        cams = bench_rig.perturb(rec, scene, seed=4)
        config = scene.rig_config()
        for c, cfg in enumerate(config[0]["cameras"]):
            cfg["cam_from_rig_rotation"] = cams[c, :4].tolist()
            cfg["cam_from_rig_translation"] = cams[c, 4:].tolist()
        path = tmp_path / f"rig_{dev}.json"
        path.write_text(json.dumps(config))
        stats = {}
        rig_tools.run_rig_bundle_adjustment(rec, str(path), device=dev,
                                            stats=stats)
        assert stats["syncs"] == 0 and stats["cg_steps"] > 0
        recs[dev] = rec
    for iid, im in recs["cpu"].images.items():
        np.testing.assert_allclose(recs[cuda].images[iid].cam_from_world,
                                   im.cam_from_world, atol=1e-3)
    gt = scene.image_poses()
    for iid, im in recs[cuda].images.items():
        assert float(rot.quat_angle_deg(
            torch.as_tensor(im.cam_from_world[:4]),
            torch.as_tensor(gt[iid - 1, :4]))) < 0.2


def test_prior_ba_cuda_matches_cpu(cuda):
    import copy

    gt = tsyn.synthesize_dataset(tsyn.SyntheticDatasetOptions(
        num_cameras=1, num_images=8, num_points3D=150, seed=6),
        Database(":memory:"))
    rng = np.random.default_rng(0)
    rec = copy.deepcopy(gt)
    for iid in rec.registered_image_ids():
        rec.images[iid].cam_from_world = (rec.images[iid].cam_from_world
                                          + np.r_[0, 0, 0, 0, 0.05, 0, 0])
    priors = {iid: gt.images[iid].projection_center()
              + rng.normal(0, 0.01, 3) for iid in gt.registered_image_ids()}
    out = {}
    for dev in ("cpu", cuda):
        r = copy.deepcopy(rec)
        pba.refine_with_priors(r, priors, sigma=0.01, options=pba.PriorBAOptions(
            camera_model_id=int(gt.cameras[1].model_id)), device=dev)
        out[dev] = r
    for iid in priors:
        np.testing.assert_allclose(out[cuda].images[iid].cam_from_world,
                                   out["cpu"].images[iid].cam_from_world,
                                   atol=1e-3)


def test_covariance_cuda_matches_cpu(cuda):
    problem, _ = bench_ba.build_problem(num_poses=6, num_points=200,
                                        obs_per_point=4, seed=9, device="cpu")
    mask = torch.ones_like(problem.pose_mask)
    mask[0] = 0.0
    mask[1, 3] = 0.0
    problem = problem._replace(pose_mask=mask)
    mid = int(cm.CameraModelId.SIMPLE_RADIAL)
    opts = cov.CovarianceOptions(compute_point_covariances=True)
    out = {dev: cov.estimate_ba_covariance(
        ba.BAProblem(*(x.to(dev) for x in problem)), opts, mid)
        for dev in ("cpu", cuda)}
    assert sorted(out[cuda].pose_covs) == [1, 2, 3, 4, 5]
    for p, C in out["cpu"].pose_covs.items():
        np.testing.assert_allclose(out[cuda].pose_covs[p], C,
                                   atol=1e-3 * np.abs(C).max())
    for m, C in out["cpu"].point_covs.items():
        np.testing.assert_allclose(out[cuda].point_covs[m], C,
                                   atol=1e-3 * np.abs(C).max())
    full = cov.estimate_pose_covariance_full_inverse(
        ba.BAProblem(*(x.to(cuda) for x in problem)), mid)
    for p, C in out[cuda].pose_covs.items():
        np.testing.assert_allclose(C, full[p, :, p, :], rtol=1e-2, atol=1e-8)


def test_cli_cuda_end_to_end(cuda, tmp_path, capsys):
    """feature_extractor -> exhaustive_matcher (the matcher kernel) ->
    mapper -> model_analyzer through the command line on the card."""
    from colmap_tpu_torch import cli

    o = synth.RoomDatasetOptions(num_images=4, width=320, height=240,
                                 focal=280.0, seed=5)
    images, K, _, _ = synth.render_room_dataset(o)
    synth.write_dataset(str(tmp_path / "images"), images)
    params = ",".join(map(str, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))
    common = ["--database_path", str(tmp_path / "db.db"), "--device", cuda]
    assert cli.main(["feature_extractor", "--image_path",
                     str(tmp_path / "images"), "--ImageReader.camera_model",
                     "PINHOLE", "--ImageReader.single_camera", "1",
                     "--ImageReader.camera_params", params] + common) == 0
    before = hm.launches
    assert cli.main(["exhaustive_matcher"] + common) == 0
    assert hm.launches > before
    assert cli.main(["mapper", "--output_path", str(tmp_path / "sparse")]
                    + common) == 0
    capsys.readouterr()
    assert cli.main(["model_analyzer", "--path",
                     str(tmp_path / "sparse" / "0")]) == 0
    assert '"num_registered_images": 4' in capsys.readouterr().out


def test_sift_variants_cuda_match_cpu(cuda):
    """Affine shapes and domain-size pooling on the card against the CPU:
    >= 98% of keypoints within 0.01 px at the same orientation, and the
    matched keypoints' descriptor bytes within one level on >= 99.5% (the
    affine bar of tests/test_torch_sift_variants.py)."""
    o = synth.RoomDatasetOptions(num_images=2, width=320, height=240,
                                 focal=280.0, seed=5)
    image = synth.render_room_dataset(o)[0][1]
    opts = sift_mod.SiftExtractionOptions(estimate_affine_shape=True,
                                          domain_size_pooling=True)
    c = sift_mod.extract(image, opts, device="cpu")
    g = sift_mod.extract(image, opts, device=cuda)
    assert abs(len(g["xy"]) - len(c["xy"])) <= 0.02 * len(c["xy"])
    d2 = ((g["xy"][:, None] - c["xy"][None]) ** 2).sum(-1)
    dori = np.abs(np.angle(np.exp(1j * (g["orientation"][:, None]
                                         - c["orientation"][None]))))
    d2 = np.where(dori < 1e-2, d2, np.inf)
    nn = d2.argmin(1)
    close = np.sqrt(d2[np.arange(len(nn)), nn]) <= 0.01
    assert close.mean() >= 0.98
    dg = g["descriptors"][close].astype(int)
    dc = c["descriptors"][nn[close]].astype(int)
    assert (np.abs(dg - dc) <= 1).mean() >= 0.995


def test_affine2d_cuda_matches_cpu(cuda):
    """The batched least-squares affine fit (QR on both devices)."""
    rng = np.random.default_rng(0)
    src = rng.normal(0, 10, (5, 40, 2)).astype(np.float32)
    M = np.array([[1.1, 0.2, 3.0], [-0.15, 0.9, -2.0]], np.float32)
    dst = (src @ M[:, :2].T + M[:, 2]
           + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    out = {d: st.estimate_affine2d(torch.as_tensor(src, device=d),
                                   torch.as_tensor(dst, device=d)).cpu()
           for d in ("cpu", cuda)}
    np.testing.assert_allclose(out[cuda].numpy(), out["cpu"].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out["cpu"].numpy()[0], M, atol=1e-2)


def _sharded_matching_equals_one_shard(mesh):
    rng = np.random.default_rng(11)
    B, n = 8, 256
    d1 = rng.integers(0, 200, (B, n, 128)).astype(np.uint8)
    d2 = np.clip(d1[:, ::-1].astype(int) + rng.integers(-3, 4, (B, n, 128)),
                 0, 255).astype(np.uint8)
    v = np.ones((B, n), bool)
    v[3, 100:] = False
    hm.launches_by_thread.clear()
    out = psm.match_pair_blocks_sharded(mesh, d1, d2, v, v)
    for k in range(mesh.size):
        assert hm.launches_by_thread.get(f"shard-{k}", 0) >= 1
    one = psm.match_pair_blocks_sharded(pmesh.make_mesh(1, "cuda"), d1, d2,
                                        v, v)
    cpu = psm.match_pair_blocks_sharded(pmesh.make_mesh(1, "cpu"), d1, d2,
                                        v, v)
    np.testing.assert_array_equal(out, one)
    np.testing.assert_array_equal(out, cpu)
    assert (out[0] == np.arange(n)[::-1]).mean() > 0.9


def _distributed_ba_matches_cpu(mesh):
    # index_add_ sums in no fixed order on the card: a tolerance, not bits
    problem, _ = bench_ba.build_problem(num_poses=41, num_points=3000,
                                        obs_per_point=5, seed=3, device="cpu")
    opts = ba.BAOptions(max_iterations=8, cg_iterations=20, loss="cauchy",
                        refine_intrinsics=True)
    cpu = ba.solve(problem, opts)
    gpu = dba.solve_distributed(
        ba.BAProblem(*(x.to("cuda") for x in problem)), opts, mesh)
    assert gpu.cost.device.type == "cuda" and gpu.problem.poses.shape[0] == 41
    assert float(gpu.cost) < 0.01 * float(ba.compute_cost(problem, opts))
    np.testing.assert_allclose(float(gpu.cost), float(cpu.cost), rtol=1e-3)
    np.testing.assert_allclose(gpu.problem.poses.cpu().numpy(),
                               cpu.problem.poses.numpy(), atol=1e-4)


def test_sharded_matching_on_four_virtual_shards(cuda):
    # make_mesh holds one shard per card present: virtual shards on one
    # card are built explicitly
    mesh = pmesh.Mesh([torch.device(cuda, 0)] * 4)
    assert mesh.size == 4 and mesh.num_distinct == 1
    _sharded_matching_equals_one_shard(mesh)


def test_distributed_ba_cuda_matches_cpu(cuda):
    _distributed_ba_matches_cpu(pmesh.Mesh([torch.device(cuda, 0)] * 4))


def test_parallel_slice_on_two_cards(cuda):
    """Shards on two distinct cards: the matcher launches on each shard's
    own card (its thread's current device made the tensors' card) and the
    collectives copy between cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mesh = pmesh.make_mesh(2, cuda)
    assert mesh.num_distinct == 2
    _sharded_matching_equals_one_shard(mesh)
    _distributed_ba_matches_cpu(mesh)


def _room_gt(K, Rs, ts, names, width, height):
    gt = Reconstruction()
    gt.add_camera(Camera(camera_id=1, model_id=1, width=width, height=height,
                         params=np.array([K[0, 0], K[1, 1], K[0, 2],
                                          K[1, 2]])))
    for i, (R, t) in enumerate(zip(Rs, ts)):
        q = rot.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float64))
        gt.add_image(Image(image_id=i + 1, name=names[i], camera_id=1,
                           cam_from_world=np.concatenate([q.numpy(), t])))
    return gt


def _matched_copy(src, dst, num_devices, cuda):
    """A copy of database `src` at `dst`, matched anew by match_exhaustive
    with `num_devices`; returns it open with the K1 launches per shard
    thread."""
    shutil.copy(src, dst)
    db = Database(dst)
    db.conn.execute("DELETE FROM matches")
    db.conn.execute("DELETE FROM two_view_geometries")
    db.commit()
    hm.launches_by_thread.clear()
    fm.match_exhaustive(db, fm.FeatureMatchingOptions(num_devices=num_devices),
                        device=cuda)
    return db, dict(hm.launches_by_thread)


def test_entry_points_shard_over_two_cards(cuda, tmp_path):
    """The controllers' `num_devices=2` branches with one shard on each of
    two cards, on a 12-image 640x480 room: match_exhaustive's match rows
    equal the one-device run's and its verified pairs >= 95% of the union
    (the shards draw their own RANSAC samples); the mapper registers every
    image with >= 1 sharded global BA, every rotation within 1 deg and
    every centre within 0.05 x room size of the render after a Sim3; the
    round-robin PatchMatch writes every map, >= 40% of each estimated, its
    points a median < 0.03 x room size from the room's faces (the smoke's
    dense gates)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mesh = pmesh.shard_mesh(2, cuda)
    assert mesh.size == 2 and mesh.num_distinct == 2
    o = synth.RoomDatasetOptions(num_images=12, width=640, height=480,
                                 focal=560.0, seed=11)
    images, K, Rs, ts = synth.render_room_dataset(o)
    image_path = str(tmp_path / "images")
    names = synth.write_dataset(image_path, images)
    gt = _room_gt(K, Rs, ts, names, o.width, o.height)
    _, db = ar.run_automatic_reconstruction(
        ar.AutomaticReconstructionOptions(
            workspace_path=str(tmp_path / "ws"), image_path=image_path,
            quality=ar.Quality.HIGH, camera_model="PINHOLE",
            single_camera=True, sparse=False,
            camera_params=",".join(map(str, [K[0, 0], K[1, 1], K[0, 2],
                                             K[1, 2]]))), device=cuda)
    db.close()
    src = str(tmp_path / "ws" / "database.db")

    one, _ = _matched_copy(src, str(tmp_path / "one.db"), 1, cuda)
    two, per_shard = _matched_copy(src, str(tmp_path / "two.db"), 2, cuda)
    assert all(per_shard.get(f"shard-{k}", 0) >= 1 for k in range(2)), \
        per_shard
    ids = sorted(one.read_images())
    for a, b in [(a, b) for i, a in enumerate(ids) for b in ids[i + 1:]]:
        m1, m2 = one.read_matches(a, b), two.read_matches(a, b)
        assert (m1 is None) == (m2 is None), (a, b)
        if m1 is not None:
            np.testing.assert_array_equal(m2, m1)
    t1 = set(one.read_all_two_view_geometries())
    t2 = set(two.read_all_two_view_geometries())
    assert len(t1 & t2) >= 0.95 * len(t1 | t2) and t1
    one.close()

    popts = IncrementalPipelineOptions()
    popts.mapper.num_devices = 2
    pipe = IncrementalPipeline(two, popts, device=cuda)
    rec = pipe.run()
    two.close()
    assert rec is not None and rec.num_registered_images() == o.num_images
    assert pipe.ba_stats["gba_sharded_calls"] >= 1, pipe.ba_stats
    s = o.room_size
    cmp = st.compare_reconstructions(rec, gt, device=cuda)
    assert cmp["max_rotation_error_deg"] <= 1.0, cmp["rotation_errors_deg"]
    assert cmp["max_center_error"] <= 0.05 * s, cmp["center_errors"]

    dense_dir = str(tmp_path / "dense")
    und.run_undistorter(rec, image_path, dense_dir, device=cuda)
    timings = {}
    dense.run_patch_match_stereo(dense_dir, dense.PatchMatchStereoOptions(
        num_devices=2, max_image_size=256), device=cuda, timings=timings)
    assert timings["maps"] == o.num_images
    urec = rio.read_model(os.path.join(dense_dir, "sparse"))
    to_gt = torch.as_tensor(cmp["sim3"])
    for iid in rec.registered_image_ids():
        im = urec.images[iid]
        path = os.path.join(dense_dir, "stereo", "depth_maps",
                            f"{im.name}.geometric.bin")
        assert os.path.exists(os.path.join(
            dense_dir, "stereo", "normal_maps", f"{im.name}.geometric.bin"))
        depth = dm.DepthMap.read(path).data
        ys, xs = np.nonzero(depth > 0)
        assert len(ys) >= 0.4 * depth.size, (im.name, len(ys) / depth.size)
        cam = urec.cameras[im.camera_id]
        sx, sy = depth.shape[1] / cam.width, depth.shape[0] / cam.height
        fx, fy, cx, cy = cam.params[:4] * np.array([sx, sy, sx, sy])
        d = depth[ys, xs].astype(np.float64)
        Xc = np.stack([(xs + 0.5 - cx) / fx * d, (ys + 0.5 - cy) / fy * d, d],
                      -1)
        q = torch.as_tensor(im.cam_from_world[:4])
        R = rot.quat_to_rotmat(q / torch.linalg.vector_norm(q)).numpy()
        p = s3.apply(to_gt, torch.as_tensor(
            (Xc - im.cam_from_world[4:7]) @ R)).numpy()
        dist = np.minimum(np.minimum(np.abs(p[:, 2] - s),
                                     np.abs(p[:, 0] - s)),
                          np.abs(p[:, 1] - s / 2))
        assert np.median(dist) < 0.03 * s, (im.name, np.median(dist))
