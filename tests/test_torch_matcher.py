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
    tb1 = tm.prepare_descriptors(d1, v1)
    tb2 = tm.prepare_descriptors(d2, v2)
    return jb1, jb2, tb1, tb2


def test_prepare_descriptors_bit_equal(rng):
    d = rng.integers(0, 256, (300, 128)).astype(np.uint8)
    v = rng.random(300) > 0.2
    jb = jm.prepare_descriptors(d, jnp.asarray(v))
    tb = tm.prepare_descriptors(d, v)
    for name in ("centered", "row_sum", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jb, name)),
                                      getattr(tb, name).numpy())
    # XLA:CPU rewrites 1/sqrt into an approximate rsqrt plus a Newton step,
    # which is not correctly rounded; torch's 1/sqrt is. <= 2 ulp apart.
    np.testing.assert_array_max_ulp(np.asarray(jb.inv_norm),
                                    tb.inv_norm.numpy(), maxulp=2)
    # the carried state: a JAX block fetched to the host becomes the port's
    cb = tm.block_from_numpy(*(np.asarray(x) for x in jb))
    for a, b, j in zip(tb, cb, jb):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b.numpy(), np.asarray(j))


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
