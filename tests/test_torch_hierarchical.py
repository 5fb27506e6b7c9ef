"""The port's hierarchical mapping slice against the JAX package, on the CPU.

Held on the same numpy-seeded inputs: the large-model global-BA cadence;
all 12 camera models (1e-5, 1e-4 for the fisheye models at wide angles;
`default_params` exact); the synthetic generator (ids, names, matches,
two-view geometries and descriptors exact, keypoints 1e-3 px, ground-truth
poses 1e-6); the clustering trees (exact); the Sim3 pose graph (1e-4);
robust alignment (1e-5); merging (same images, points and tracks, xyz
1e-5); and the hierarchical pipeline on tests/test_hierarchical.py's
12-image fixture at both of its settings (JAX's leaves, JAX's gates).
The synthetic seeds used here give equal databases in both packages (a
keypoint on an image border could flip visibility and shift the stream).
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from colmap_tpu.controllers.incremental_pipeline import (
    IncrementalPipelineOptions as JPipelineOptions,
)
from colmap_tpu.estimators import alignment as jalign
from colmap_tpu.estimators import pose_graph as jpg
from colmap_tpu.geometry import rotation as jrot
from colmap_tpu.geometry import sim3 as js3
from colmap_tpu.scene import reconstruction as jrecon
from colmap_tpu.scene import scene_clustering as jsc
from colmap_tpu.scene import synthetic as jsyn
from colmap_tpu.scene.database import Database as JDatabase
from colmap_tpu.sensor import models as jmodels
from colmap_tpu_torch.controllers.hierarchical_pipeline import (
    HierarchicalPipeline,
    HierarchicalPipelineOptions,
)
from colmap_tpu_torch.controllers.incremental_pipeline import (
    IncrementalPipeline,
    IncrementalPipelineOptions,
)
from colmap_tpu_torch.estimators import alignment as talign
from colmap_tpu_torch.estimators import pose_graph as tpg
from colmap_tpu_torch.estimators.similarity_transform import (
    compare_reconstructions,
)
from colmap_tpu_torch.geometry import sim3 as ts3
from colmap_tpu_torch.scene import scene_clustering as tsc
from colmap_tpu_torch.scene import synthetic as tsyn
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.sensor import models as tmodels

torch.set_num_threads(2)


# -- the large-model global-BA cadence ----------------------------------------


def test_cadence_options_match_jax():
    t, j = IncrementalPipelineOptions(), JPipelineOptions()
    for name in ("ba_global_images_ratio", "ba_global_points_ratio",
                 "ba_global_images_ratio_large",
                 "ba_global_coarse_cadence_size"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.ba_global_images_ratio_large == 1.2
    assert t.ba_global_coarse_cadence_size == 500


def _jax_rule(opts, n_img, n_pts, last_images, last_points):
    """colmap_tpu/controllers/incremental_pipeline.py:189-197, transcribed."""
    large = n_img >= opts.ba_global_coarse_cadence_size
    img_ratio = (opts.ba_global_images_ratio_large if large
                 else opts.ba_global_images_ratio)
    pts_ratio = (opts.ba_global_images_ratio_large if large
                 else opts.ba_global_points_ratio)
    return (n_img > img_ratio * last_images
            or n_pts > pts_ratio * last_points)


@pytest.mark.parametrize("points_per_image", [20, 60])
def test_global_ba_due_matches_jax_rule(points_per_image):
    """A registration trajectory from 2 to 1,000 images (rounds of ~10% of
    the model, as `_map_round` batches them): the port's cadence fires at
    the steps JAX's rule gives, and from 500 images on less often than the
    flat 1.1 cadence would."""
    pipe = IncrementalPipeline(Database(":memory:"), device="cpu")
    jopts = JPipelineOptions()
    rng = np.random.default_rng(points_per_image)
    n_img, fired, fired_jax, flat = 2, [], [], []
    last = [2, 1]
    last_jax = [2, 1]
    last_flat = [2, 1]
    while n_img < 1000:
        n_img = min(1000, n_img + max(1, min(50, n_img // 10)))
        n_pts = int(points_per_image * n_img * rng.uniform(0.9, 1.1))
        if pipe._global_ba_due(n_img, n_pts, *last):
            fired.append(n_img)
            last = [n_img, n_pts]
        if _jax_rule(jopts, n_img, n_pts, *last_jax):
            fired_jax.append(n_img)
            last_jax = [n_img, n_pts]
        if n_img > 1.1 * last_flat[0] or n_pts > 1.1 * last_flat[1]:
            flat.append(n_img)
            last_flat = [n_img, n_pts]
    assert fired == fired_jax
    assert (sum(1 for n in fired if n >= 500)
            < sum(1 for n in flat if n >= 500))
    assert [n for n in fired if n < 500] == [n for n in flat if n < 500]


# -- camera models -------------------------------------------------------------

_PARAMS = {
    "SIMPLE_PINHOLE": [300.0, 160.0, 120.0],
    "PINHOLE": [300.0, 310.0, 160.0, 120.0],
    "SIMPLE_RADIAL": [300.0, 160.0, 120.0, 0.05],
    "RADIAL": [300.0, 160.0, 120.0, 0.05, -0.02],
    "OPENCV": [300.0, 310.0, 160.0, 120.0, 0.05, -0.02, 0.001, -0.002],
    "OPENCV_FISHEYE": [300.0, 310.0, 160.0, 120.0, 0.05, -0.01, 0.002,
                       -0.001],
    "FULL_OPENCV": [300.0, 310.0, 160.0, 120.0, 0.05, -0.02, 0.001, -0.002,
                    0.003, 0.01, -0.004, 0.001],
    "FOV": [300.0, 310.0, 160.0, 120.0, 0.9],
    "SIMPLE_RADIAL_FISHEYE": [300.0, 160.0, 120.0, 0.05],
    "RADIAL_FISHEYE": [300.0, 160.0, 120.0, 0.05, -0.02],
    "THIN_PRISM_FISHEYE": [300.0, 310.0, 160.0, 120.0, 0.05, -0.01, 0.001,
                           -0.002, 0.002, -0.001, 0.001, -0.001],
    "RAD_TAN_THIN_PRISM_FISHEYE": [300.0, 310.0, 160.0, 120.0, 0.05, -0.01,
                                   0.002, -0.001, 0.001, -0.002, 0.001,
                                   -0.001],
}


@pytest.mark.parametrize("name", list(_PARAMS))
def test_camera_model_matches_jax(name):
    mid = int(tmodels.MODEL_IDS_BY_NAME[name])
    assert mid == int(jmodels.MODEL_IDS_BY_NAME[name])
    np.testing.assert_array_equal(
        tmodels.default_params(mid, 840.0, 1024, 768),
        np.asarray(jmodels.default_params(mid, 840.0, 1024, 768)))
    p = tmodels.pad_params(_PARAMS[name])
    fisheye = "FISHEYE" in name
    # fisheye models are held out to 1.2 rad off the axis (62 deg)
    rng = np.random.default_rng(mid)
    r = rng.uniform(0.0, 1.2 if fisheye else 0.5, 64)
    a = rng.uniform(0.0, 2 * np.pi, 64)
    uv = np.tan(r)[:, None] * np.stack([np.cos(a), np.sin(a)], 1) \
        if fisheye else r[:, None] * np.stack([np.cos(a), np.sin(a)], 1)
    uv = uv.astype(np.float32)
    tol = 1e-4 if fisheye else 1e-5
    pt, pj = torch.as_tensor(p), jnp.asarray(p)
    t_xy = tmodels.img_from_cam(mid, pt, torch.as_tensor(uv))
    j_xy = np.asarray(jmodels.img_from_cam(mid, pj, jnp.asarray(uv)))
    # pixels: relative to the focal length, the scale of the rays
    np.testing.assert_allclose(t_xy.numpy() / 300.0, j_xy / 300.0, atol=tol)
    t_uv = tmodels.cam_from_img(mid, pt, torch.as_tensor(j_xy))
    j_uv = np.asarray(jmodels.cam_from_img(mid, pj, jnp.asarray(j_xy)))
    np.testing.assert_allclose(t_uv.numpy(), j_uv, atol=tol,
                               rtol=tol if fisheye else 0)
    p_cam = np.concatenate([uv * 2.0, np.full((64, 1), 2.0, np.float32)], 1)
    np.testing.assert_allclose(
        tmodels.project(mid, pt, torch.as_tensor(p_cam)).numpy() / 300.0,
        np.asarray(jmodels.project(mid, pj, jnp.asarray(p_cam))) / 300.0,
        atol=tol)


# -- the synthetic generator ---------------------------------------------------

_SYNTH = {
    "exhaustive": dict(num_images=8, num_points3D=120, point2D_stddev=0.5,
                       seed=11),
    "exhaustive_outliers_priors": dict(
        num_images=8, num_points3D=120, point2D_stddev=0.3,
        inlier_match_ratio=0.7, use_prior_position=True, seed=5),
    "chained": dict(num_images=16, num_points3D=200, point2D_stddev=0.5,
                    match_config=2, match_overlap=3, seed=3),
    "chained_visibility_priors": dict(
        num_images=24, num_points3D=300, point2D_stddev=0.5, match_config=2,
        match_overlap=4, point_visibility_images=8, use_prior_position=True,
        num_cameras=1, seed=3),
    # the hierarchical gate (HIER_GATE_r05.json)
    "gate": dict(num_images=200, num_points3D=4000, point2D_stddev=0.5,
                 match_config=2, match_overlap=10, point_visibility_images=40,
                 seed=3),
}


def _both_databases(kw):
    jdb, tdb = JDatabase(":memory:"), Database(":memory:")
    jgt = jsyn.synthesize_dataset(jsyn.SyntheticDatasetOptions(**kw), jdb)
    tgt = tsyn.synthesize_dataset(tsyn.SyntheticDatasetOptions(**kw), tdb)
    return jdb, tdb, jgt, tgt


@pytest.mark.parametrize("case", list(_SYNTH))
def test_synthetic_database_matches_jax(case):
    jdb, tdb, jgt, tgt = _both_databases(_SYNTH[case])
    assert tdb.read_images() == jdb.read_images()
    jc, tc = jdb.read_cameras(), tdb.read_cameras()
    assert jc.keys() == tc.keys()
    for cid in jc:
        np.testing.assert_array_equal(tc[cid]["params"], jc[cid]["params"])
    for iid in jdb.read_images():
        np.testing.assert_allclose(tdb.read_keypoints(iid),
                                   jdb.read_keypoints(iid), atol=1e-3)
        assert (tdb.read_descriptors(iid).tobytes()
                == jdb.read_descriptors(iid).tobytes())
        np.testing.assert_allclose(tgt.images[iid].cam_from_world,
                                   jgt.images[iid].cam_from_world, atol=1e-6)
    jg, tg = jdb.read_all_two_view_geometries(), \
        tdb.read_all_two_view_geometries()
    assert tg.keys() == jg.keys()
    for pair in jg:
        np.testing.assert_array_equal(tdb.read_matches(*pair),
                                      jdb.read_matches(*pair))
        np.testing.assert_array_equal(tg[pair]["inlier_matches"],
                                      jg[pair]["inlier_matches"])
        assert tg[pair]["config"] == jg[pair]["config"]
    jp, tp = jdb.read_pose_priors(), tdb.read_pose_priors()
    assert jp.keys() == tp.keys()
    for iid in jp:
        np.testing.assert_allclose(tp[iid]["position"], jp[iid]["position"],
                                   atol=1e-5)
    assert len(tgt.points3D) == len(jgt.points3D)
    for pid, pt in jgt.points3D.items():
        assert tgt.points3D[pid].track == pt.track
        np.testing.assert_array_equal(tgt.points3D[pid].color, pt.color)


# -- clustering ----------------------------------------------------------------


def _communities(seed, p_edge, bridges):
    ids = list(range(1, 21))
    w = {}
    rng = np.random.default_rng(seed)
    for grp in (ids[:10], ids[10:]):
        for i in range(len(grp)):
            for j in range(i + 1, len(grp)):
                if p_edge >= 1.0 or rng.uniform() < p_edge:
                    w[(grp[i], grp[j])] = rng.uniform(50, 100)
    w.update(bridges)
    return ids, w


def _tree(c):
    return (tuple(c.image_ids), tuple(_tree(k) for k in c.children))


@pytest.fixture(scope="module")
def gate_database():
    """The 200-image hierarchical gate's database (HIER_GATE_r05.json)."""
    db = Database(":memory:")
    gt = tsyn.synthesize_dataset(tsyn.SyntheticDatasetOptions(
        num_images=200, num_points3D=4000, point2D_stddev=0.5,
        match_config=tsyn.MatchConfig.CHAINED, match_overlap=10,
        point_visibility_images=40, seed=3), db)
    return db, gt


@pytest.mark.parametrize("case", ["two_communities", "overlap", "gate"])
def test_clustering_tree_matches_jax(case, gate_database):
    if case == "two_communities":
        ids, w = _communities(0, 0.7, {(5, 15): 2.0})
        leaf, overlap = 12, 0
    elif case == "overlap":
        ids, w = _communities(1, 1.0, {(3, 13): 30.0, (7, 17): 40.0})
        leaf, overlap = 12, 2
    else:
        db, _ = gate_database
        w = tsc.edge_weights_from_database(db)
        assert w == jsc.edge_weights_from_database(db)
        ids, leaf, overlap = sorted(db.read_images()), 60, 50
    t = tsc.cluster_scene(ids, w, tsc.SceneClusteringOptions(
        leaf_max_num_images=leaf, image_overlap=overlap))
    j = jsc.cluster_scene(ids, w, jsc.SceneClusteringOptions(
        leaf_max_num_images=leaf, image_overlap=overlap))
    assert _tree(t) == _tree(j)
    if case == "two_communities":
        assert ({frozenset(lf.image_ids) for lf in t.leaves()}
                == {frozenset(ids[:10]), frozenset(ids[10:])})
    if case == "overlap":
        assert all(len(lf.image_ids) == 12 for lf in t.leaves())


# -- the Sim3 pose graph -------------------------------------------------------


def test_pose_graph_ring_matches_jax():
    """tests/test_hierarchical.py's 6-node Sim3 ring: the port refines to
    JAX's placements and passes that test's own assertions."""
    rng = np.random.default_rng(0)
    n = 6
    gt = [np.array([1, 1, 0, 0, 0, 0, 0, 0], np.float32)]
    for _ in range(1, n):
        q = np.asarray(jrot.quat_from_axis_angle(
            jnp.asarray(rng.normal(0, 0.3, 3).astype(np.float32))))
        gt.append(np.concatenate([[np.exp(rng.normal(0, 0.1))], q,
                                  rng.normal(0, 1.0, 3)]).astype(np.float32))
    gt = np.stack(gt)

    def noisy_rel(i, j, sigma=0.01):
        m = js3.compose(js3.inverse(jnp.asarray(gt[j])), jnp.asarray(gt[i]))
        qn = jrot.quat_from_axis_angle(
            jnp.asarray(rng.normal(0, sigma, 3).astype(np.float32)))
        return np.asarray(js3.compose(m, js3.make(
            jnp.exp(jnp.asarray(rng.normal(0, sigma), jnp.float32)), qn,
            jnp.asarray(rng.normal(0, sigma, 3), jnp.float32))))

    edges = np.array([(k, (k + 1) % n) for k in range(n)])
    meas = np.stack([noisy_rel(i, j) for i, j in edges])
    init = [gt[0]]
    for k in range(1, n):
        init.append(np.asarray(js3.compose(jnp.asarray(init[k - 1]),
                                           js3.inverse(jnp.asarray(
                                               meas[k - 1])))))
    init = np.stack(init)

    refined = tpg.optimize_sim3_pose_graph(init, edges, meas, device="cpu")
    ref_jax = np.asarray(jpg.optimize_sim3_pose_graph(init, edges, meas))
    np.testing.assert_allclose(refined, ref_jax, atol=1e-4)

    def consistency(S):
        S = torch.as_tensor(np.asarray(S, np.float32))
        m = torch.as_tensor(meas)
        pred = ts3.compose(ts3.inverse(S[edges[:, 1]]), S[edges[:, 0]])
        e = ts3.compose(ts3.inverse(m), pred).numpy()
        return (np.linalg.norm(e[:, 5:8], axis=1)
                + np.abs(np.log(np.maximum(e[:, 0], 1e-9))))

    before, after = consistency(init), consistency(refined)
    assert after.max() < before.max()
    assert after.mean() < 0.05


# -- alignment and merging -----------------------------------------------------


@pytest.fixture(scope="module")
def fixture_12():
    """tests/test_hierarchical.py's fixture: 12 images, 220 points, 0.4 px,
    one camera, seed 11, in both packages."""
    kw = dict(num_cameras=1, num_images=12, num_points3D=220,
              point2D_stddev=0.4, seed=11)
    return _both_databases(kw)


def _split(gt, seed):
    """tests/test_hierarchical.py's split of a ground-truth model into two
    halves that share 4 images; the second is moved by a Sim3 (the port's
    transform; `_to_jax` copies the result) and the centre of one shared
    image is displaced (an outlier for the robust alignment)."""
    ids = sorted(gt.registered_image_ids())
    half = len(ids) // 2 + 2
    rec1, rec2 = copy.deepcopy(gt), copy.deepcopy(gt)
    for iid in ids[half:]:
        rec1.images[iid].cam_from_world = None
        rec1.images[iid].point3D_ids[:] = -1
    for iid in ids[: half - 4]:
        rec2.images[iid].cam_from_world = None
        rec2.images[iid].point3D_ids[:] = -1
    for rec in (rec1, rec2):
        dead = [pid for pid, pt in rec.points3D.items()
                if sum(1 for (i, _) in pt.track
                       if rec.images[i].registered) < 2]
        for pid in dead:
            rec.delete_point3D(pid)
        for pt in rec.points3D.values():
            pt.track = [(i, k) for (i, k) in pt.track
                        if rec.images[i].registered]
    t = np.array([2.0, 0.3, -0.4, 0.5, 0.7071, 1.0, -2.0, 3.0])
    t[1:5] /= np.linalg.norm(t[1:5])
    rec2.transform(t)
    rng = np.random.default_rng(seed)
    for iid in ids[half - 4: half - 3]:
        pose = rec2.images[iid].cam_from_world
        q = pose[:4] / np.linalg.norm(pose[:4])
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                       2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                       2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x),
                       1 - 2 * (x * x + y * y)]])
        pose[4:7] -= R @ rng.normal(0, 1.0, 3)  # the centre moves
    return rec1, rec2


def _to_jax(rec):
    """The same model as a JAX-package Reconstruction."""
    out = jrecon.Reconstruction()
    for c in rec.cameras.values():
        out.add_camera(jrecon.Camera(camera_id=c.camera_id,
                                     model_id=c.model_id, width=c.width,
                                     height=c.height, params=c.params.copy()))
    for im in rec.images.values():
        out.add_image(jrecon.Image(
            image_id=im.image_id, name=im.name, camera_id=im.camera_id,
            cam_from_world=(None if im.cam_from_world is None
                            else im.cam_from_world.copy()),
            xys=im.xys.copy(), point3D_ids=im.point3D_ids.copy()))
    for pid, pt in rec.points3D.items():
        out.points3D[pid] = jrecon.Point3D(xyz=pt.xyz.copy(),
                                           color=pt.color.copy(),
                                           error=pt.error,
                                           track=list(pt.track))
    out._next_point3D_id = rec._next_point3D_id
    return out


def test_robust_alignment_matches_jax(fixture_12):
    _, _, _, gt = fixture_12
    rec1, rec2 = _split(gt, seed=0)
    t = talign.align_reconstructions_robust(rec2, rec1, device="cpu")
    j = jalign.align_reconstructions_robust(_to_jax(rec2), _to_jax(rec1))
    assert t is not None and j is not None
    np.testing.assert_allclose(t, j, atol=1e-5)
    # and it is the split's Sim3, inverted, despite the outlier
    assert abs(t[0] - 0.5) < 1e-3


def test_merge_reconstructions_matches_jax(fixture_12):
    _, _, _, gt = fixture_12
    rec1, rec2 = _split(gt, seed=1)
    j1 = _to_jax(rec1)
    assert talign.merge_reconstructions(rec1, rec2, device="cpu")
    assert jalign.merge_reconstructions(j1, _to_jax(rec2))
    assert (sorted(rec1.registered_image_ids())
            == sorted(j1.registered_image_ids()) == sorted(gt.images))
    assert rec1.points3D.keys() == j1.points3D.keys()
    for pid, pt in j1.points3D.items():
        assert rec1.points3D[pid].track == pt.track
        np.testing.assert_allclose(rec1.points3D[pid].xyz, pt.xyz, atol=1e-5)
    for iid in gt.images:
        np.testing.assert_array_equal(rec1.images[iid].point3D_ids,
                                      j1.images[iid].point3D_ids)
    cmp = compare_reconstructions(rec1, gt, device="cpu")
    assert cmp["max_rotation_error_deg"] < 0.1


# -- the pipeline --------------------------------------------------------------


@pytest.mark.parametrize("leaf,overlap,workers,seed",
                         [(7, 3, 4, 0), (5, 2, 3, 1)])
def test_hierarchical_pipeline_matches_jax_gates(fixture_12, leaf, overlap,
                                                 workers, seed):
    """tests/test_hierarchical.py's two pipeline runs: JAX's leaves, and
    JAX's gates (>= 10 of 12 registered, < 1 deg, < 0.05)."""
    jdb, tdb, _, gt = fixture_12
    opts = HierarchicalPipelineOptions(num_workers=workers)
    opts.clustering.leaf_max_num_images = leaf
    opts.clustering.image_overlap = overlap
    pipe = HierarchicalPipeline(tdb, opts, device="cpu")
    rec = pipe.run(seed=seed)
    jtree = jsc.cluster_scene(
        sorted(jdb.read_images()), jsc.edge_weights_from_database(jdb),
        jsc.SceneClusteringOptions(leaf_max_num_images=leaf,
                                   image_overlap=overlap))
    assert pipe.leaf_sizes == [len(lf.image_ids) for lf in jtree.leaves()]
    assert len(pipe.clusters) == len(pipe.leaf_sizes) > 1
    assert rec is not None and rec.num_registered_images() >= 10
    cmp = compare_reconstructions(rec, gt, device="cpu")
    assert cmp["max_rotation_error_deg"] < 1.0, cmp
    assert cmp["max_center_error"] < 0.05, cmp
    assert pipe.ba_stats["gba_calls"] >= len(pipe.clusters)
    assert {"clustering", "caches", "mapping", "align", "pose_graph",
            "fuse"} <= set(pipe.timings)


def test_hierarchical_pipeline_run_starts_afresh(fixture_12):
    """`run` reports its own clusters, timings, stages and BA counters, not
    sums with what an earlier run left; every cluster reports its
    mapping seconds."""
    _, tdb, _, _ = fixture_12
    opts = HierarchicalPipelineOptions(num_workers=1)
    opts.clustering.leaf_max_num_images = 5
    opts.clustering.image_overlap = 2
    pipe = HierarchicalPipeline(tdb, opts, device="cpu")
    stale = 1e9  # what an earlier run on this pipeline might have left
    pipe.clusters.append(dict(images=0, registered=0, seconds=stale))
    for d in (pipe.timings, pipe.stage_s, pipe.ba_stats):
        d["mapping"] = d["register"] = d["gba_calls"] = stale
    pipe.run(seed=1)
    assert len(pipe.clusters) == len(pipe.leaf_sizes) > 1
    for d in (pipe.timings, pipe.stage_s, pipe.ba_stats):
        assert all(v < stale for v in d.values()), d
    assert len(pipe.clusters) <= pipe.ba_stats["gba_calls"]
    for c in pipe.clusters:
        assert c["seconds"] > 0.0


def test_forward_ad_from_many_threads():
    """Undistortion's Newton Jacobians (reverse-mode vector-Jacobian
    products, as BA's and PnP's Jacobians in the cluster threads) run from
    16 threads at once with a short switch interval give the serial
    results, with no lock: torch.func keeps its transforms per thread."""
    import sys
    import threading

    mid = int(tmodels.CameraModelId.OPENCV_FISHEYE)
    p = torch.as_tensor(tmodels.pad_params(_PARAMS["OPENCV_FISHEYE"]))
    rng = np.random.default_rng(0)
    xys = [torch.as_tensor(rng.uniform(0, 320, (32, 2)).astype(np.float32))
           for _ in range(16)]
    ref = [tmodels.cam_from_img(mid, p, xy) for xy in xys]
    out, errors = [None] * len(xys), []

    def work(k):
        try:
            for _ in range(3):
                out[k] = tmodels.cam_from_img(mid, p, xys[k])
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(len(xys))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _ba_jacobians():
    from colmap_tpu_torch.estimators import bundle_adjustment as tba

    rng = np.random.default_rng(4)
    P, M = 4, 40
    poses = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (P, 1))
    poses[:, 4] = np.arange(P) * 0.3
    X = rng.uniform(-1, 1, (M, 3)).astype(np.float32)
    X[:, 2] += 5
    pi, xi = np.meshgrid(np.arange(P), np.arange(M), indexing="ij")
    pi, xi = pi.ravel(), xi.ravel()
    xy = rng.uniform(0, 640, (len(pi), 2)).astype(np.float32)
    cams = tmodels.pad_params([500.0, 320.0, 240.0, 0.01])[None]
    problem = tba.make_problem(poses, cams, X, pi, np.zeros_like(pi), xi, xy,
                               device="cpu")
    mid = int(tmodels.CameraModelId.SIMPLE_RADIAL)
    return lambda: tba._obs_residual_and_jac(problem, mid)


def _pnp_refinement():
    from colmap_tpu_torch.estimators import absolute_pose as tap

    rng = np.random.default_rng(5)
    X = torch.as_tensor(rng.uniform(-1, 1, (3, 50, 3)).astype(np.float32)
                        + np.array([0, 0, 5], np.float32))
    uv = X[..., :2] / X[..., 2:] + torch.as_tensor(
        rng.normal(0, 1e-3, (3, 50, 2)).astype(np.float32))
    start = torch.tensor([[1.0, 0.01, -0.02, 0.01, 0.05, -0.03, 0.1]] * 3)
    w = torch.ones(3, 50)
    return lambda: tap.gn_refine_pose(start, X, uv, w, num_iters=3)


def _pose_graph():
    rng = np.random.default_rng(6)
    n = 5
    init = np.zeros((n, 8), np.float32)
    init[:, 0] = 1.0
    init[:, 1] = 1.0
    init[:, 5:8] = rng.normal(0, 1, (n, 3))
    edges = np.array([(k, (k + 1) % n) for k in range(n)])
    meas = np.zeros((n, 8), np.float32)
    meas[:, 0] = np.exp(rng.normal(0, 0.05, n))
    meas[:, 1] = 1.0
    meas[:, 5:8] = rng.normal(0, 1, (n, 3))
    return lambda: tpg.optimize_sim3_pose_graph(init, edges, meas,
                                                num_iters=4, device="cpu")


@pytest.mark.parametrize("make", [_ba_jacobians, _pnp_refinement,
                                  _pose_graph],
                         ids=["bundle_adjustment", "pnp", "pose_graph"])
def test_jacobians_from_four_threads_match_serial(make):
    """BA's Jacobians, PnP's Gauss-Newton refinement and the pose graph's
    LM, each run from 4 threads at once with a short switch interval, give
    the serial result: reverse-mode autodiff needs no lock."""
    import sys
    import threading

    fn = make()
    ref = fn()
    out, errors = [None] * 4, []

    def work(k):
        try:
            for _ in range(3):
                out[k] = fn()
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    for got in out:
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            torch.testing.assert_close(torch.as_tensor(a), torch.as_tensor(b),
                                       rtol=0, atol=0)


def test_port_has_no_forward_mode_autodiff():
    """No source file of the port calls forward-mode autodiff: torch keeps
    its dual level process-wide, so it is not safe from the cluster
    threads."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "colmap_tpu_torch"
    hits = [f"{p.relative_to(root)}:{k + 1}"
            for p in sorted(root.rglob("*.py"))
            for k, line in enumerate(p.read_text().splitlines())
            if any(w in line for w in ("jacfwd", ".jvp(", "forward_ad"))]
    assert not hits, hits
    assert not (root / "util" / "forward_ad.py").exists()
