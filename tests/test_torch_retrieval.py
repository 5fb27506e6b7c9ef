"""The port's retrieval package (colmap_tpu_torch.retrieval) against the JAX
package's, on the CPU.

Random draws cannot match: JAX draws the k-means initial centres with
jax.random, the port with a torch generator. So the tests hold
- the Lloyd iteration from JAX's own initial centres: centres within 1e-4
  abs, assignments equal;
- the hierarchical build's numpy stream: with the same seed, the Hamming
  projection drawn after the tree is bit-equal (one rng draw per clustered
  node, in node order, on a fixture where every node has >= 2 points);
- given the same tree (written by one package's `save`, read by the
  other's `load`): word ids and signature bits >= 99.9% equal (f32
  reductions run in another order), query top-k ids equal and scores
  within 1e-5 rel, vocab-tree pairs equal;
- vote-and-verify (host numpy in both): equal results.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from colmap_tpu.retrieval import kmeans as jkm
from colmap_tpu.retrieval import visual_index as jvi
from colmap_tpu.retrieval import vote_and_verify as jvv
from colmap_tpu_torch.retrieval import kmeans as tkm
from colmap_tpu_torch.retrieval import visual_index as tvi
from colmap_tpu_torch.retrieval import vote_and_verify as tvv
from colmap_tpu_torch.scene.database import Database

torch.set_num_threads(2)


def _fake_image_descriptors(rng, num_images=8, n=100, dim=128):
    """Images with distinctive descriptor clusters + shared noise (the JAX
    package's retrieval fixture)."""
    protos = rng.uniform(0, 255, (num_images, 6, dim))
    out = {}
    for i in range(num_images):
        own = protos[i][rng.integers(0, 6, n - 20)] + rng.normal(0, 4, (n - 20, dim))
        noise = rng.uniform(0, 255, (20, dim))
        out[i + 1] = np.clip(np.concatenate([own, noise]), 0, 255).astype(np.uint8)
    return out


def _clusters(rng):
    centers = np.array([[0.0] * 8, [10.0] * 8, [-10.0, 10.0] * 4])
    return np.concatenate([c + rng.normal(0, 0.3, (50, 8))
                           for c in centers]).astype(np.float32), centers


def _kmeans_case(name, rng):
    if name == "clusters":
        return _clusters(rng)[0], 3
    if name == "descriptors":  # the vocab tree's input: uint8 / 512
        d = np.concatenate(list(_fake_image_descriptors(rng).values()))
        return d.astype(np.float32) / 512.0, 16
    # 20 distinct points, each 5 times: initial centres repeat, so clusters
    # start empty and are re-seeded at the farthest points
    base = rng.normal(0, 1, (20, 16)).astype(np.float32)
    return np.repeat(base, 5, axis=0), 12


@pytest.mark.parametrize("case", ["clusters", "descriptors", "duplicates"])
def test_lloyd_from_jax_initial_centres(rng, case):
    pts, k = _kmeans_case(case, rng)
    key = jax.random.PRNGKey(7)
    init = pts[np.asarray(jax.random.permutation(key, len(pts)))[:k]]
    if case == "duplicates":
        assert len(np.unique(init, axis=0)) < k
    jc, ja = jkm.kmeans(key, jnp.asarray(pts), jnp.ones(len(pts), bool), k, 15)
    tc, ta = tkm.kmeans_from_centers(torch.as_tensor(pts),
                                     torch.as_tensor(init), 15)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)


def test_port_kmeans_separates_clusters(rng):
    # the initial draw is k random points (as in the JAX package), so two
    # may start in one cluster and stay there: every seed whose draw puts
    # one centre in each cluster must separate them
    pts, centers_gt = _clusters(rng)
    separated = 0
    for seed in range(8):
        gen = torch.Generator().manual_seed(seed)
        init = tkm.kmeans_init(torch.Generator().manual_seed(seed),
                               torch.as_tensor(pts), 3).numpy()
        if len({int(np.argmin(np.linalg.norm(centers_gt - c, axis=1)))
                for c in init}) < 3:
            continue
        centers, assign = tkm.kmeans(gen, torch.as_tensor(pts), 3, 25)
        centers, assign = centers.numpy(), assign.numpy()
        for c in centers_gt:
            assert np.linalg.norm(centers - c, axis=1).min() < 0.5
        for i in range(3):
            labels = assign[i * 50:(i + 1) * 50]
            assert (labels == labels[0]).mean() > 0.95
        separated += 1
    assert separated >= 1


def test_hierarchical_build_consumes_the_numpy_stream_as_jax(rng):
    desc = np.concatenate(list(_fake_image_descriptors(rng).values()))
    opts = dict(branching=4, depth=2)
    j = jvi.VisualIndex(jvi.VisualIndexOptions(**opts))
    t = tvi.VisualIndex(tvi.VisualIndexOptions(**opts), device="cpu")
    j.build(desc, seed=3)
    t.build(desc, seed=3)
    # every node of both trees clustered >= 2 points, so both drew once per
    # node and the projection drawn after the tree is the same
    words = t._quantize(t._prep(desc))
    assert (np.bincount(words // 4, minlength=4) >= 2).all()
    jwords = jkm.quantize(j.levels, j._prep(desc))
    assert (np.bincount(jwords // 4, minlength=4) >= 2).all()
    np.testing.assert_array_equal(t.proj, j.proj)
    assert [lvl.shape for lvl in t.levels] == [lvl.shape for lvl in j.levels]


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    rng = np.random.default_rng(11)
    descs = _fake_image_descriptors(rng)
    j = jvi.VisualIndex(jvi.VisualIndexOptions(branching=8, depth=2))
    j.build(np.concatenate(list(descs.values())), seed=0)
    path = str(tmp_path_factory.mktemp("vocab") / "jax_vocab.npz")
    j.save(path)
    return descs, path


def _bits(sigs):
    return np.unpackbits(sigs.view(np.uint8), axis=1)


def test_quantize_signatures_query_given_jax_tree(jax_tree):
    descs, path = jax_tree
    j = jvi.VisualIndex.load(path)
    t = tvi.VisualIndex.load(path, device="cpu")
    rng = np.random.default_rng(5)
    all_desc = np.concatenate(list(descs.values()))
    jw = jkm.quantize(j.levels, j._prep(all_desc))
    tw = tkm.quantize(t.levels, t._prep(all_desc), device="cpu")
    assert (jw == tw).mean() >= 0.999
    jsig = j._signatures(j._prep(all_desc), jw)
    tsig = t._signatures(t._prep(all_desc), tw)
    assert (_bits(jsig) == _bits(tsig)).mean() >= 0.999
    for iid, d in descs.items():
        j.add_image(iid, d)
        t.add_image(iid, d)
    for iid in descs:
        noisy = np.clip(descs[iid].astype(np.float32)
                        + rng.normal(0, 2, descs[iid].shape), 0, 255
                        ).astype(np.uint8)
        jr, tr = j.query(noisy, 5), t.query(noisy, 5)
        assert [i for i, _ in tr] == [i for i, _ in jr]
        np.testing.assert_allclose([s for _, s in tr], [s for _, s in jr],
                                   rtol=1e-5)
        assert tr[0][0] == iid


def test_save_load_round_trips_between_packages(tmp_path, jax_tree):
    descs, jpath = jax_tree
    # JAX -> port: the same arrays
    j = jvi.VisualIndex.load(jpath)
    t = tvi.VisualIndex.load(jpath, device="cpu")
    assert t.options.branching == 8 and t.options.depth == 2
    for a, b in zip(t.levels, j.levels):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.proj, j.proj)
    np.testing.assert_array_equal(t.thresholds, j.thresholds)
    # port -> JAX: a tree trained by the port reads back in both packages
    own = tvi.VisualIndex(tvi.VisualIndexOptions(branching=4, depth=2),
                          device="cpu")
    own.build(np.concatenate(list(descs.values())), seed=1)
    tpath = str(tmp_path / "port_vocab.npz")
    own.save(tpath)
    for back in (jvi.VisualIndex.load(tpath),
                 tvi.VisualIndex.load(tpath, device="cpu")):
        assert (back.options.branching, back.options.depth) == (4, 2)
        for a, b in zip(back.levels, own.levels):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(back.proj, own.proj)
        np.testing.assert_array_equal(back.thresholds, own.thresholds)
    d = own._prep(descs[1])
    np.testing.assert_array_equal(
        jkm.quantize(own.levels, d), tkm.quantize(own.levels, d, "cpu"))


def test_vocab_tree_pairs_given_jax_tree(jax_tree):
    descs, path = jax_tree
    rng = np.random.default_rng(2)
    db = Database(":memory:")
    cam = db.write_camera(0, 100, 100, np.array([100.0, 50, 50]))
    for iid, d in descs.items():
        got = db.write_image(f"im{iid}.png", cam)
        db.write_keypoints(got, rng.uniform(0, 100, (len(d), 2)).astype(
            np.float32))
        db.write_descriptors(got, d)
    jp = jvi.vocab_tree_pairs(db, jvi.VisualIndex.load(path), 2)
    tp = tvi.vocab_tree_pairs(db, tvi.VisualIndex.load(path, device="cpu"), 2)
    assert tp == jp and len(tp) >= 3
    # the port's own tree, trained from the database
    own = tvi.build_vocab_tree_from_database(
        db, tvi.VisualIndexOptions(branching=8, depth=2), device="cpu")
    assert own.levels[1].shape == (8, 8, 128)
    db.close()


def test_vote_and_verify_equals_jax(rng):
    n = 60
    xy1 = rng.uniform(0, 500, (n, 2))
    ang, s = 0.4, 1.3
    R = s * np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    xy2 = xy1 @ R.T + np.array([40.0, -25.0])
    scale1 = rng.uniform(2, 4, n)
    ori1 = rng.uniform(-np.pi, np.pi, n)
    bad = rng.choice(n, n // 3, replace=False)
    xy2c = xy2.copy()
    xy2c[bad] = rng.uniform(0, 500, (len(bad), 2))
    cases = [(xy1, scale1, ori1, xy2c, scale1 * s, ori1 + ang),
             (xy1, scale1, ori1, rng.uniform(0, 500, (n, 2)),
              rng.uniform(2, 4, n), rng.uniform(-np.pi, np.pi, n)),
             (xy1[:2], scale1[:2], ori1[:2], xy2[:2], scale1[:2], ori1[:2])]
    out = [tvv.vote_and_verify(*c) for c in cases]
    assert out == [jvv.vote_and_verify(*c) for c in cases]
    assert out[0][1] >= int(0.9 * (n - len(bad))) and out[1][1] < out[0][1] / 3
