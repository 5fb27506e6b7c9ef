"""The port's pair generation, GPS conversions and sequential matching with
loop detection against the JAX package, on the CPU.

- Pair generators (sequential, spatial, transitive, imported) are host
  logic in both packages: exactly equal pair lists.
- `gps.ell_to_enu`: the port computes in float64; within 1 m of the JAX
  package's float32 result (ECEF coordinates of ~6.4e6 m keep ~0.5 m in
  float32) and within 1e-6 m of a numpy float64 evaluation.
- The loop fixture of tests/test_loop_detection.py (six room frames and the
  first again, so the last frame revisits the first pose), extracted by the
  port: the port's own vocab tree finds the loop pair; given the JAX
  package's tree, the loop pairs and the query ranking equal JAX's (scores
  within 1e-5 rel); `match_sequential` verifies the loop pair with >= 15
  inliers and a second call matches only the new pairs; guided matching
  keeps only matches within the epipolar gate.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from colmap_tpu.features import pairing as jpairing
from colmap_tpu.geometry import gps as jgps
from colmap_tpu.retrieval import visual_index as jvi
from colmap_tpu_torch.controllers import feature_extraction as fe
from colmap_tpu_torch.controllers import feature_matching as fm
from colmap_tpu_torch.features import pairing as tpairing
from colmap_tpu_torch.features import sift as sift_mod
from colmap_tpu_torch.geometry import gps as tgps
from colmap_tpu_torch.retrieval import visual_index as tvi
from colmap_tpu_torch.scene import synthetic_images as synth
from colmap_tpu_torch.scene.database import Database

torch.set_num_threads(2)


@pytest.mark.parametrize("n,overlap,quadratic", [
    (1, 10, True), (7, 1, False), (7, 10, True), (40, 3, True),
    (100, 10, True), (100, 10, False), (300, 50, True)])
def test_sequential_pairs_equal_jax(n, overlap, quadratic):
    ids = list(np.random.default_rng(n).permutation(np.arange(1, n + 1) * 3))
    ids = [int(i) for i in ids]
    kw = dict(overlap=overlap, quadratic_overlap=quadratic)
    got = tpairing.sequential_pairs(ids, tpairing.SequentialPairingOptions(**kw))
    assert got == jpairing.sequential_pairs(
        ids, jpairing.SequentialPairingOptions(**kw))


@pytest.mark.parametrize("kw", [{}, dict(max_num_neighbors=3),
                                dict(max_distance=20.0, ignore_z=False)])
def test_spatial_pairs_equal_jax(rng, kw):
    ids = [int(i) for i in rng.permutation(40) + 1]
    pos = rng.uniform(-100, 100, (40, 3))
    got = tpairing.spatial_pairs(ids, pos, tpairing.SpatialPairingOptions(**kw))
    assert got == jpairing.spatial_pairs(
        ids, pos, jpairing.SpatialPairingOptions(**kw))
    assert got


@pytest.mark.parametrize("batch_size", [1000, 7])
def test_transitive_pairs_equal_jax(rng, batch_size):
    edges = {tuple(sorted(int(x) for x in rng.choice(30, 2, replace=False) + 1))
             for _ in range(45)}
    edges = sorted(edges)
    got = tpairing.transitive_pairs(edges, batch_size)
    assert got == jpairing.transitive_pairs(edges, batch_size)
    assert got and not set(got) & set(edges)


def test_imported_pairs_equal_jax(tmp_path):
    path = tmp_path / "pairs.txt"
    path.write_text("a.png b.png\nb.png a.png\nc.png a.png\n"
                    "a.png a.png\nx.png a.png\nonly_one.png\n"
                    "d.png c.png extra\n\nd.png b.png\n")
    name_to_id = {"a.png": 4, "b.png": 2, "c.png": 9, "d.png": 1}
    got = tpairing.imported_pairs(str(path), name_to_id)
    assert got == jpairing.imported_pairs(str(path), name_to_id)
    assert got == [(1, 2), (2, 4), (4, 9)]


def _ell_to_enu_f64(lla):
    """numpy float64 evaluation of the WGS84 -> ENU conversion, relative to
    the first point."""
    a, f = 6378137.0, 1.0 / 298.257223563
    e2 = f * (2.0 - f)
    lat, lon, alt = np.radians(lla[:, 0]), np.radians(lla[:, 1]), lla[:, 2]
    N = a / np.sqrt(1.0 - e2 * np.sin(lat) ** 2)
    ecef = np.stack([(N + alt) * np.cos(lat) * np.cos(lon),
                     (N + alt) * np.cos(lat) * np.sin(lon),
                     (N * (1.0 - e2) + alt) * np.sin(lat)], -1)
    sl, cl = np.sin(lat[0]), np.cos(lat[0])
    so, co = np.sin(lon[0]), np.cos(lon[0])
    R = np.array([[-so, co, 0.0], [-sl * co, -sl * so, cl],
                  [cl * co, cl * so, sl]])
    return (ecef - ecef[0]) @ R.T


def _gps_track(rng, n=30):
    """Positions within ~2 km of a point in Zurich, as (lat, lon, alt)."""
    return np.stack([47.37 + rng.uniform(-0.01, 0.01, n),
                     8.54 + rng.uniform(-0.01, 0.01, n),
                     400.0 + rng.uniform(-20, 20, n)], -1)


def test_ell_to_enu(rng):
    lla = _gps_track(rng)
    got = tgps.ell_to_enu(torch.as_tensor(lla)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, _ell_to_enu_f64(lla), atol=1e-6, rtol=0)
    jax_f32 = np.asarray(jgps.ell_to_enu(jnp.asarray(lla)))
    np.testing.assert_allclose(got, jax_f32, atol=1.0, rtol=0)
    # the ECEF round trip
    back = tgps.ecef_to_ell(tgps.ell_to_ecef(torch.as_tensor(lla))).numpy()
    np.testing.assert_allclose(back[:, :2], lla[:, :2], atol=1e-9)
    np.testing.assert_allclose(back[:, 2], lla[:, 2], atol=1e-5)


def test_spatial_pairs_from_database(rng):
    lla = _gps_track(rng)
    db = Database(":memory:")
    cam = db.write_camera(0, 100, 100, np.array([100.0, 50, 50]))
    ids = [db.write_image(f"im{i:02d}.png", cam) for i in range(len(lla))]
    for iid, p in zip(ids, lla):
        db.write_pose_prior(iid, p, coordinate_system=1)
    opts = dict(max_num_neighbors=4, max_distance=800.0)
    got = tpairing.spatial_pairs_from_database(
        db, tpairing.SpatialPairingOptions(**opts), device="cpu")
    assert got == tpairing.spatial_pairs(
        ids, _ell_to_enu_f64(lla), tpairing.SpatialPairingOptions(**opts))
    assert got == jpairing.spatial_pairs_from_database(
        db, jpairing.SpatialPairingOptions(**opts))
    db.close()


@pytest.fixture(scope="module")
def loop_db(tmp_path_factory):
    """A 7-frame sequence whose last frame revisits the first pose,
    extracted by the port, in a database file."""
    opts = synth.RoomDatasetOptions(num_images=6, width=320, height=240,
                                    focal=280.0, seed=5)
    images, K, _, _ = synth.render_room_dataset(opts)
    root = tmp_path_factory.mktemp("loop")
    synth.write_dataset(str(root / "images"), list(images) + [images[0]])
    path = str(root / "loop.db")
    db = Database(path)
    fe.run_feature_extraction(
        db, str(root / "images"),
        fe.ImageReaderOptions(camera_model="PINHOLE", single_camera=True,
                              camera_params=",".join(map(str, [
                                  K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))),
        sift_mod.SiftExtractionOptions(max_image_size=640,
                                       max_num_features=1024,
                                       octave_capacity=1024), device="cpu")
    ids = [iid for iid, im in sorted(db.read_images().items(),
                                     key=lambda kv: kv[1]["name"])]
    # the JAX package's vocab tree of this database (default options)
    tree = str(root / "jax_vocab.npz")
    jvi.build_vocab_tree_from_database(db, jvi.VisualIndexOptions()).save(tree)
    db.close()
    return path, ids, tree


_LOOP = dict(overlap=1, quadratic_overlap=False, loop_detection=True,
             loop_detection_period=7, loop_detection_num_images=3)


def test_port_loop_detection_finds_the_loop_pair(loop_db):
    path, ids, _ = loop_db
    db = Database(path)
    pairs = tpairing.sequential_loop_detection_pairs(
        db, ids, tpairing.SequentialPairingOptions(**_LOOP), device="cpu")
    db.close()
    assert (min(ids[0], ids[-1]), max(ids[0], ids[-1])) in pairs


def test_loop_pairs_and_ranking_equal_jax_given_its_tree(loop_db):
    path, ids, tree = loop_db
    db = Database(path)
    got = tpairing.sequential_loop_detection_pairs(
        db, ids, tpairing.SequentialPairingOptions(**_LOOP,
                                                   vocab_tree_path=tree),
        device="cpu")
    want = jpairing.sequential_loop_detection_pairs(
        db, ids, jpairing.SequentialPairingOptions(**_LOOP,
                                                   vocab_tree_path=tree))
    assert got == want and (min(ids[0], ids[-1]), max(ids[0], ids[-1])) in got
    # the ranking behind them: every frame queried against all others
    j, t = jvi.VisualIndex.load(tree), tvi.VisualIndex.load(tree, device="cpu")
    for iid in ids:
        j.add_image(iid, db.read_descriptors(iid))
        t.add_image(iid, db.read_descriptors(iid))
    for iid in ids:
        d = db.read_descriptors(iid)
        jr, tr = j.query(d, 6, exclude=iid), t.query(d, 6, exclude=iid)
        assert [i for i, _ in tr] == [i for i, _ in jr]
        np.testing.assert_allclose([s for _, s in tr], [s for _, s in jr],
                                   rtol=1e-5)
    db.close()


def _copy(path, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copy(path, dst)
    return Database(dst)


def test_match_sequential_closes_the_loop(loop_db, tmp_path):
    path, ids, _ = loop_db
    db = _copy(path, tmp_path, "seq.db")
    first_last = (min(ids[0], ids[-1]), max(ids[0], ids[-1]))
    mopts = fm.FeatureMatchingOptions(feature_capacity=1024)
    no_loop = {k: v for k, v in _LOOP.items() if k == "overlap"
               or k == "quadratic_overlap"}
    stats0 = fm.match_sequential(
        db, mopts, tpairing.SequentialPairingOptions(**no_loop), device="cpu")
    assert stats0.num_pairs == len(ids) - 1 and stats0.num_verified_pairs >= 1
    assert db.read_two_view_geometry(*first_last) is None
    stats1 = fm.match_sequential(
        db, mopts, tpairing.SequentialPairingOptions(**_LOOP), device="cpu")
    g = db.read_two_view_geometry(*first_last)
    assert g is not None and len(g["inlier_matches"]) >= 15
    # the second call matched only the pairs the first did not verify
    loop = tpairing.sequential_loop_detection_pairs(
        db, ids, tpairing.SequentialPairingOptions(**_LOOP), device="cpu")
    window = tpairing.sequential_pairs(
        ids, tpairing.SequentialPairingOptions(**no_loop))
    verified0 = len(window) - (stats0.num_pairs - stats0.num_verified_pairs)
    assert stats1.num_pairs == len(set(window) | set(loop)) - verified0
    assert stats1.num_blocks == 1 and stats1.pool_builds == 1
    db.close()


def test_guided_matching_keeps_epipolar_matches(loop_db, tmp_path):
    path, ids, _ = loop_db
    pairs = [(ids[0], ids[1]), (ids[2], ids[3]), (ids[0], ids[-1])]
    counts = {}
    for guided in (False, True):
        db = _copy(path, tmp_path, f"guided{guided}.db")
        opts = fm.FeatureMatchingOptions(feature_capacity=1024,
                                         guided_matching=guided)
        stats = fm.match_pairs(db, pairs, opts, device="cpu")
        assert stats.num_verified_pairs == len(pairs)
        counts[guided] = {p: db.read_two_view_geometry(*p) for p in pairs}
        if guided:
            for (a, b), g in counts[guided].items():
                m = g["inlier_matches"].astype(np.int64)
                x1 = db.read_keypoints(a)[m[:, 0], :2].astype(np.float64)
                x2 = db.read_keypoints(b)[m[:, 1], :2].astype(np.float64)
                h1 = np.c_[x1, np.ones(len(x1))]
                h2 = np.c_[x2, np.ones(len(x2))]
                Fx1, Ftx2 = h1 @ g["F"].T, h2 @ g["F"]
                num = np.sum(Fx1 * h2, 1)
                den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 \
                    + Ftx2[:, 1] ** 2
                assert (num ** 2 / den <= 4.0 ** 2 * (1 + 1e-3)).all()
        db.close()
    n = {k: [len(v[p]["inlier_matches"]) for p in pairs]
         for k, v in counts.items()}
    assert all(g >= u for g, u in zip(n[True], n[False])) and n[True] != n[False]
