"""The port's incremental mapper and its model IO against the JAX package,
on the CPU.

Databases come from the JAX package's synthesize_dataset (8 images on a
circle, 2 SIMPLE_RADIAL cameras) and are read by the port's own Database.
Held, with the JAX package's gates (tests/test_incremental_pipeline.py):
clean 0.1 deg / 0.01, noisy (0.5 px) 0.5 deg / 0.05, 30% outlier matches
1.0 deg / 0.1 with >= 7 of 8 registered; on one shared database both
packages register the same number of images. The database cache's rays
(cam_from_img on a distorted camera) agree with JAX's within 1e-5, its
correspondence graph exactly. A model written by either package reads back
in the other with ids, poses and tracks exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from colmap_tpu.controllers.incremental_pipeline import (
    IncrementalPipeline as JPipeline,
)
from colmap_tpu.scene import reconstruction_io as jrio
from colmap_tpu.scene.database import Database as JDatabase
from colmap_tpu.scene.database_cache import DatabaseCache as JCache
from colmap_tpu.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset
from colmap_tpu_torch.controllers.incremental_pipeline import (
    IncrementalPipeline,
    IncrementalPipelineOptions,
)
from colmap_tpu_torch.estimators.similarity_transform import (
    compare_reconstructions,
)
from colmap_tpu_torch.scene import reconstruction_io as trio
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.database_cache import DatabaseCache

torch.set_num_threads(2)

CASES = {
    "clean": (dict(num_images=8, num_points3D=120, point2D_stddev=0.0),
              0.1, 0.01, 8),
    "noisy": (dict(num_images=8, num_points3D=150, point2D_stddev=0.5),
              0.5, 0.05, 8),
    "outliers": (dict(num_images=8, num_points3D=150, point2D_stddev=0.3,
                      inlier_match_ratio=0.7), 1.0, 0.1, 7),
}


def _database(tmp_path, name, **kw):
    """A JAX-synthesized database file and its ground-truth model."""
    path = str(tmp_path / f"{name}.db")
    db = JDatabase(path)
    gt = synthesize_dataset(SyntheticDatasetOptions(**kw), db)
    db.close()
    return path, gt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's pipeline on each case's database: (db path, gt, model)."""
    root = tmp_path_factory.mktemp("mapper")
    out = {}
    for name, (kw, *_) in CASES.items():
        path, gt = _database(root, name, **kw)
        db = Database(path)
        out[name] = (path, gt, IncrementalPipeline(db, device="cpu").run())
        db.close()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_passes_the_jax_gates(runs, case):
    _, gt, rec = runs[case]
    _, max_rot, max_center, min_images = CASES[case]
    assert rec is not None
    assert rec.num_registered_images() >= min_images
    cmp = compare_reconstructions(rec, gt, device="cpu")
    assert cmp["max_rotation_error_deg"] < max_rot, cmp["rotation_errors_deg"]
    assert cmp["max_center_error"] < max_center, cmp["center_errors"]


def test_same_registration_count_as_jax(runs):
    path, _, rec = runs["outliers"]
    jdb = JDatabase(path)
    jrec = JPipeline(jdb).run()
    jdb.close()
    assert jrec.num_registered_images() == rec.num_registered_images()


def test_database_cache_matches_jax(tmp_path):
    f = 1.2 * 1024
    path, _ = _database(tmp_path, "distorted", num_images=4,
                        num_points3D=60,
                        camera_params=[f, 512.0, 384.0, 0.05])
    jc = JCache.create(JDatabase(path))
    tc = DatabaseCache.create(Database(path), device="cpu")
    assert set(jc.images) == set(tc.images)
    for iid, im in tc.images.items():
        np.testing.assert_array_equal(im.xys, jc.images[iid].xys)
        np.testing.assert_allclose(im.rays, jc.images[iid].rays, atol=1e-5)
    assert set(jc.graph.image_pairs()) == set(tc.graph.image_pairs())
    for iid in tc.images:
        for a, b in zip(tc.graph.find_correspondences_all(iid),
                        jc.graph.find_correspondences_all(iid)):
            np.testing.assert_array_equal(a, b)


def _assert_models_equal(a, b):
    assert set(a.cameras) == set(b.cameras)
    for cid in a.cameras:
        assert a.cameras[cid].model_id == b.cameras[cid].model_id
        np.testing.assert_array_equal(a.cameras[cid].params,
                                      b.cameras[cid].params)
    assert set(a.registered_image_ids()) == set(b.registered_image_ids())
    for iid in a.registered_image_ids():
        ia, ib = a.images[iid], b.images[iid]
        assert ia.name == ib.name and ia.camera_id == ib.camera_id
        np.testing.assert_array_equal(ia.cam_from_world, ib.cam_from_world)
        np.testing.assert_array_equal(ia.point3D_ids, ib.point3D_ids)
        np.testing.assert_array_equal(ia.xys, ib.xys)
    assert set(a.points3D) == set(b.points3D)
    for pid, p in a.points3D.items():
        assert p.track == b.points3D[pid].track
        np.testing.assert_array_equal(p.xyz, b.points3D[pid].xyz)
        np.testing.assert_array_equal(p.color, b.points3D[pid].color)


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_models_cross_read(runs, tmp_path, ext):
    _, _, rec = runs["noisy"]
    # the port writes, JAX reads, JAX writes, the port reads
    trio.write_model(rec, tmp_path / "port", ext=ext)
    jrec = jrio.read_model(tmp_path / "port")
    jrio.write_model(jrec, tmp_path / "jax", ext=ext)
    back = trio.read_model(tmp_path / "jax")
    if ext == ".bin":
        _assert_models_equal(trio.read_model(tmp_path / "port"), back)
        assert len(back.points3D) == len(rec.points3D) > 100
    assert back.num_registered_images() == rec.num_registered_images()


def test_callbacks_stop_and_resume(runs):
    path, gt, _ = runs["clean"]
    db = Database(path)
    events = []
    pipe = IncrementalPipeline(
        db, initial_image_pair_callback=lambda a, b: events.append((a, b)),
        device="cpu")
    pipe.next_image_callback = lambda iid: (events.append(iid),
                                            pipe.request_stop())
    partial = pipe.run()
    assert len(events) == 2 and isinstance(events[0], tuple)
    assert 3 <= partial.num_registered_images() < 8
    # resume from the partial model: the rest registers
    resumed = IncrementalPipeline(db, device="cpu").run(input_model=partial)
    db.close()
    assert resumed.num_registered_images() == 8
    cmp = compare_reconstructions(resumed, gt, device="cpu")
    assert cmp["max_rotation_error_deg"] < 0.1
    assert cmp["max_center_error"] < 0.01


def test_snapshots_and_stage_report(runs, tmp_path):
    path, _, _ = runs["clean"]
    db = Database(path)
    opts = IncrementalPipelineOptions(snapshot_path=str(tmp_path),
                                      snapshot_images_freq=3)
    pipe = IncrementalPipeline(db, opts, device="cpu")
    rec = pipe.run()
    db.close()
    snaps = sorted(p.name for p in tmp_path.iterdir())
    assert snaps and all(int(s) >= 3 for s in snaps)
    assert trio.read_model(tmp_path / snaps[-1]).num_registered_images() \
        <= rec.num_registered_images()
    # the snapshots' seconds are a stage of their own
    assert pipe.stage_s["snapshot"] > 0.0
    # the BA counters stay apart from the stage seconds
    assert "global_ba" in pipe.stage_s and "gba_calls" not in pipe.stage_s
    assert pipe.ba_stats["gba_calls"] >= 1
    assert pipe.ba_stats["gba_syncs"] >= pipe.ba_stats["gba_lm_iters"]


def test_multi_device_raises(runs):
    """num_devices > 1, which raised until the parallel slice, shards every
    global BA of a model with at least that many images over a mesh: the
    pipeline on two CPU shards passes the clean case's gates with its
    global BAs sharded (tests/test_torch_parallel.py holds eight shards)."""
    path, gt, _ = runs["clean"]
    _, max_rot, max_center, min_images = CASES["clean"]
    db = Database(path)
    opts = IncrementalPipelineOptions()
    opts.mapper = dataclasses.replace(opts.mapper, num_devices=2)
    pipe = IncrementalPipeline(db, opts, device="cpu")
    rec = pipe.run()
    db.close()
    assert rec is not None and rec.num_registered_images() >= min_images
    cmp = compare_reconstructions(rec, gt, device="cpu")
    assert cmp["max_rotation_error_deg"] < max_rot, cmp["rotation_errors_deg"]
    assert cmp["max_center_error"] < max_center, cmp["center_errors"]
    assert pipe.ba_stats["gba_sharded_calls"] >= 1
    assert pipe.ba_stats["gba_sharded_calls"] == pipe.ba_stats["gba_calls"]


def test_native_helpers_match_jax():
    from colmap_tpu import native as jnative
    from colmap_tpu_torch import native as tnative

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 50, 500)
    for a, b in zip(tnative.build_csr(keys, 60), jnative.build_csr(keys, 60)):
        np.testing.assert_array_equal(a, b)
    ea, eb = rng.integers(0, 100, 60), rng.integers(0, 100, 60)
    np.testing.assert_array_equal(tnative.union_find(ea, eb, 100),
                                  jnative.union_find(ea, eb, 100))
