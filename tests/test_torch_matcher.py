"""The port's matcher (colmap_tpu_torch.features) against the JAX package.

The fused kernel's plain twin (`hopper_matcher._top2_fwd_rev_reference`,
which the wrapper runs on CPU tensors) is held against the Pallas kernel in
interpret mode and against the XLA scan matcher, on the same numpy inputs.
Tolerance: match-index agreement >= 0.999, the JAX package's own allowance
for near-tied similarities (tests/test_pallas_matcher.py); the port's twin
and the Pallas kernel use the same operation order, so in practice they
agree exactly. The CUDA kernel itself is compared with its twin on the card
by chip_smoke.py and tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from colmap_tpu.features import matching as jm
from colmap_tpu.features import pallas_matcher as jpm
from colmap_tpu_torch.features import hopper_matcher as hm
from colmap_tpu_torch.features import matching as tm

torch.set_num_threads(2)


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernel through the Pallas interpreter (test only)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    for name in ("_top2_fwd_rev_batch", "match_pairs_batch_pallas"):
        fn = getattr(jpm, name)
        if hasattr(fn, "__wrapped__"):
            monkeypatch.setattr(jpm, name, fn.__wrapped__)


def _pair_batch(rng, B=3, n=256, invalid_rows=True):
    d1 = rng.integers(0, 200, (B, n, 128)).astype(np.uint8)
    d2 = np.empty_like(d1)
    for b in range(B):
        perm = rng.permutation(n)
        d2[b] = np.clip(d1[b, perm].astype(int)
                        + rng.integers(-3, 4, (n, 128)), 0, 255)
    v1 = np.ones((B, n), bool)
    v2 = np.ones((B, n), bool)
    if invalid_rows:
        v2[0, : n // 4] = False  # padding rows in one pair of the block
        v1[1, n - n // 8:] = False
    return d1, d2, v1, v2


def _both(d1, d2, v1, v2):
    jb1 = jax.vmap(jm.prepare_descriptors)(d1, jnp.asarray(v1))
    jb2 = jax.vmap(jm.prepare_descriptors)(d2, jnp.asarray(v2))
    tb1 = tm.prepare_descriptors(d1, v1, device="cpu")
    tb2 = tm.prepare_descriptors(d2, v2, device="cpu")
    return jb1, jb2, tb1, tb2


def test_prepare_descriptors_bit_equal(rng):
    d = rng.integers(0, 256, (300, 128)).astype(np.uint8)
    v = rng.random(300) > 0.2
    jb = jm.prepare_descriptors(d, jnp.asarray(v))
    tb = tm.prepare_descriptors(d, v, device="cpu")
    for name in ("centered", "row_sum", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jb, name)),
                                      getattr(tb, name).numpy())
    # XLA:CPU rewrites 1/sqrt into an approximate rsqrt plus a Newton step,
    # which is not correctly rounded; torch's 1/sqrt is. <= 2 ulp apart.
    np.testing.assert_array_max_ulp(np.asarray(jb.inv_norm),
                                    tb.inv_norm.numpy(), maxulp=2)
    # the carried state: a JAX block fetched to the host becomes the port's
    cb = tm.block_from_numpy(*(np.asarray(x) for x in jb), device="cpu")
    for a, b, j in zip(tb, cb, jb):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b.numpy(), np.asarray(j))


def test_default_device_is_the_card(rng):
    """Without `device`, numpy input goes to the card (and raises where
    there is none); a tensor stays where it is; nothing falls back to the
    CPU unasked."""
    from colmap_tpu_torch.features import sift as tsift

    d = rng.integers(0, 256, (2, 64, 128)).astype(np.uint8)
    image = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    calls = (lambda: tm.prepare_descriptors(d),
             lambda: tm.block_from_numpy(d.astype(np.int8), d[..., 0],
                                         d[..., 1], d[..., 2] > 9),
             lambda: tsift.extract(image))
    if torch.cuda.is_available():
        for b in calls[:2]:
            assert all(x.is_cuda for x in b())
    else:
        for call in calls:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
    cpu = tm.prepare_descriptors(torch.as_tensor(d))
    assert all(x.device.type == "cpu" for x in cpu)
    again = tm.block_from_numpy(*cpu)
    assert all(x.device.type == "cpu" for x in again)
    for a, b in zip(cpu, again):
        assert torch.equal(a, b)


def test_twin_matches_pallas_interpret(rng, interpret):
    d1, d2, v1, v2 = _pair_batch(rng)
    jb1, jb2, tb1, tb2 = _both(d1, d2, v1, v2)
    ref = np.asarray(jpm.match_pairs_batch_pallas(jb1, jb2, tile_n=128,
                                                  tile_m=128))
    out = hm.match_pairs_batch_fused(tb1, tb2).numpy()
    assert out.shape == ref.shape == (3, 256)
    assert (out == ref).mean() >= 0.999
    assert (out >= 0).mean() > 0.5  # a real matching problem, not all -1
    # the raw top-2 statistics agree with the kernel's too
    jbest, jsec, jidx, jrb, jri = (np.asarray(x) for x in
                                   jpm._top2_fwd_rev_batch(jb1, jb2, 128, 128))
    best, sec, idx, rb, ri = (x.numpy() for x in hm.top2_fwd_rev(tb1, tb2))
    np.testing.assert_allclose(best, jbest, rtol=0, atol=1e-6)
    np.testing.assert_allclose(sec, jsec, rtol=0, atol=1e-6)
    assert (idx == jidx).mean() >= 0.999
    assert (ri == jri).mean() >= 0.999


def test_twin_matches_scan_matcher(rng):
    d1, d2, v1, v2 = _pair_batch(rng)
    jb1, jb2, tb1, tb2 = _both(d1, d2, v1, v2)
    ref = np.asarray(jm.match_pairs_batch_scan(jb1, jb2, tile_m=128))
    out = hm.match_pairs_batch_fused(tb1, tb2).numpy()
    assert (out == ref).mean() >= 0.999
    # and the port's exact matcher agrees with the JAX exact matcher
    ex = tm.match_pairs_batch(tb1, tb2).numpy()
    jex = np.asarray(jm.match_pairs_batch(jb1, jb2))
    assert (ex == jex).mean() >= 0.999
    assert (ex == out).mean() >= 0.999


def test_no_match_points_at_invalid_rows(rng):
    d1, d2, v1, v2 = _pair_batch(rng, B=2, n=128)
    _, _, tb1, tb2 = _both(d1, d2, v1, v2)
    out = hm.match_pairs_batch_fused(tb1, tb2).numpy()
    for b in range(2):
        m = out[b][out[b] >= 0]
        assert v2[b][m].all()
        assert (out[b][~v1[b]] == -1).all()


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    d1, d2, v1, v2 = _pair_batch(rng, B=1, n=128, invalid_rows=False)
    _, _, tb1, tb2 = _both(d1, d2, v1, v2)
    bad = tm.DescriptorBlock(tb1.centered[:, :100], tb1.row_sum[:, :100],
                             tb1.inv_norm[:, :100], tb1.valid[:, :100])
    with pytest.raises(ValueError):
        hm.top2_fwd_rev(bad, bad)  # capacity not a multiple of 64
    with pytest.raises(ValueError):
        hm.top2_fwd_rev(tb1._replace(row_sum=tb1.row_sum.double()), tb2)
    with pytest.raises(ValueError):
        hm.top2_fwd_rev(tb1, tm.DescriptorBlock(
            *(torch.cat([x, x]) for x in tb2)))  # pair counts differ


@pytest.mark.parametrize("max_err", [1.0, 4.0])
def test_guided_matcher_equals_jax(rng, max_err):
    """guided_match_descriptors on one pair at equal capacities: two views
    of random points, so the true matches satisfy x2^T F x1 = 0; a quarter
    of the second view's keypoints are moved off their epipolar lines."""
    n = 256
    K = np.array([[300.0, 0, 128], [0, 300, 128], [0, 0, 1]])
    a = 0.1
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.5, 0.05, 0.0])
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (n, 3))
    x1 = X @ K.T
    x1 = x1[:, :2] / x1[:, 2:]
    x2 = (X @ R.T + t) @ K.T
    x2 = x2[:, :2] / x2[:, 2:]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Kinv = np.linalg.inv(K)
    F = Kinv.T @ tx @ R @ Kinv
    F = (F / np.linalg.norm(F)).astype(np.float32)
    d1, d2, v1, v2 = _pair_batch(rng, B=2, n=n)  # pair 0 has padding rows
    perm = rng.permutation(n)  # d2's rows are d1's rows in this order
    d2[0] = np.clip(d1[0, perm].astype(int)
                    + rng.integers(-3, 4, (n, 128)), 0, 255)
    xy1 = x1.astype(np.float32)
    xy2 = x2[perm].astype(np.float32)
    xy2[: n // 4] += rng.uniform(-20, 20, (n // 4, 2)).astype(np.float32)
    jb1, jb2, tb1, tb2 = _both(d1, d2, v1, v2)
    ref = np.asarray(jm.guided_match_descriptors(
        jax.tree.map(lambda x: x[0], jb1), jax.tree.map(lambda x: x[0], jb2),
        jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(F), max_err))
    out = tm.guided_match_descriptors(
        tm.DescriptorBlock(*(x[0] for x in tb1)),
        tm.DescriptorBlock(*(x[0] for x in tb2)),
        torch.as_tensor(xy1), torch.as_tensor(xy2), torch.as_tensor(F),
        max_err).numpy()
    assert out.shape == ref.shape == (n,)
    assert (out == ref).mean() >= 0.999
    assert 0.3 * n < (out >= 0).sum() < 0.9 * n  # the gate removes matches
