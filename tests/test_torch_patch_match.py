"""The port's PatchMatch stereo against the JAX package, on the CPU.

Held on the same rendered room (numpy-seeded renderer, 96x72, 3 sources):
`_precompute` (1e-6); the photometric and the geometric cost of the same
planes (1e-4 absolute on 99.9% of the pixels, 1e-3 on all: the one-pass
variances of low-texture patches lose ~1e-4 to f32 in either package and
the sums run in other orders); neighbour propagation and the random normals
(1e-5); the whole solver fed JAX's own draws (`RecordedDraws` filled by
replaying `patch_match`'s `jax.random.split` chain, 2 iterations): depth
within 1e-3 relative and the same filter mask on >= 99% of the pixels
(near-ties in `c_c < cost` and in the top-k flip single pixels between f32
orders); the port's own generator held to tests/test_mvs.py's gates on the
4-image 160x120 room; and the active-colour evaluation equal to the masked
whole-image one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from colmap_tpu.mvs import patch_match as jpm
from colmap_tpu.scene import synthetic_images as synth
from colmap_tpu_torch.mvs import patch_match as tpm

torch.set_num_threads(2)


def _room(width, height, focal, n_images=4, seed=2):
    o = synth.RoomDatasetOptions(num_images=n_images, width=width,
                                 height=height, focal=focal, seed=seed)
    return synth.render_room_dataset(o, return_depth=True)


def _problem_arrays(room, ref=1, srcs=(0, 2, 3), geom=False):
    images, K, Rs, ts, depths = room
    srcs = list(srcs)
    R_rel = np.stack([Rs[s] @ Rs[ref].T for s in srcs])
    t_rel = np.stack([ts[s] - R_rel[i] @ ts[ref] for i, s in enumerate(srcs)])
    gt = depths[ref]
    arrs = dict(
        ref_image=images[ref].astype(np.float32) / 255.0,
        src_images=np.stack([images[s] for s in srcs]).astype(np.float32)
        / 255.0,
        K_ref=K.astype(np.float32),
        K_src=np.stack([K] * len(srcs)).astype(np.float32),
        R_rel=R_rel.astype(np.float32), t_rel=t_rel.astype(np.float32),
        depth_min=np.float32(gt[gt > 0].min() * 0.7),
        depth_max=np.float32(gt[gt > 0].max() * 1.3))
    if geom:
        arrs["src_depths"] = np.stack([depths[s] for s in srcs]).astype(
            np.float32)
    return arrs, gt


def _problems(arrs):
    return (jpm.PatchMatchProblem(**{k: jnp.asarray(v)
                                     for k, v in arrs.items()}),
            tpm.PatchMatchProblem(**{k: torch.as_tensor(v)
                                     for k, v in arrs.items()}))


def _options(**kw):
    return jpm.PatchMatchOptions(**kw), tpm.PatchMatchOptions(**kw)


@pytest.fixture(scope="module")
def small_room():
    return _room(96, 72, 84.0)


def _t(x):
    return torch.as_tensor(np.array(x))


def jax_draws(key, h, w, opts):
    """The draws of jpm.patch_match(key, ...) in its order, replayed with
    JAX's own split / uniform / normal calls (patch_match.py:296-375)."""
    k0, k1, key = jax.random.split(key, 3)
    initial = (_t(jax.random.uniform(k0, (h, w), jnp.float32)),
               _t(jax.random.normal(k1, (h, w, 3), jnp.float32)))

    def perturbation(k):
        ka, kb = jax.random.split(k)
        return (_t(jax.random.uniform(ka, (h, w), jnp.float32, -1, 1)),
                _t(jax.random.normal(kb, (h, w, 3), jnp.float32)))

    draws = []
    for _ in range(2 * opts.num_iterations):
        key, ks = jax.random.split(key)
        pkeys = jax.random.split(ks, opts.num_perturbations)
        draws += [perturbation(pkeys[j])
                  for j in range(opts.num_perturbations)]
    for _ in range(2 * opts.num_refinement_iterations):
        key, ks = jax.random.split(key)
        pkeys = jax.random.split(ks, 2)
        draws += [perturbation(pkeys[j]) for j in range(2)]
    return tpm.RecordedDraws(initial, draws)


def test_precompute_matches_jax(small_room):
    arrs, _ = _problem_arrays(small_room)
    jp, tp = _problems(arrs)
    jo, to = _options()
    ref = jpm._precompute(jp, jo)
    got = tpm._precompute(tp, to)
    for field in ref._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   atol=1e-6, err_msg=field)


def _planes(arrs, gt, seed):
    """Depths near the truth (1/3 of them random in the range) and random
    normals facing the camera."""
    rng = np.random.default_rng(seed)
    h, w = gt.shape
    depth = np.where(gt > 0, gt, arrs["depth_max"]) * rng.uniform(
        0.98, 1.02, (h, w))
    rand = rng.uniform(arrs["depth_min"], arrs["depth_max"], (h, w))
    depth = np.where(rng.uniform(size=(h, w)) < 1 / 3, rand, depth)
    normal = rng.normal(size=(h, w, 3)) + [0, 0, -3.0]
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    return depth.astype(np.float32), normal.astype(np.float32)


@pytest.mark.parametrize("geom", [False, True])
def test_cost_matches_jax(small_room, geom):
    arrs, gt = _problem_arrays(small_room, geom=geom)
    jp, tp = _problems(arrs)
    jo, to = _options(geom_consistency=geom)
    depth, normal = _planes(arrs, gt, seed=1)
    ref = np.asarray(jpm._cost_fn(jp, jpm._precompute(jp, jo), jo)(
        jnp.asarray(depth), jnp.asarray(normal)))
    got = tpm._cost_fn(tp, tpm._precompute(tp, to), to)(
        torch.as_tensor(depth), torch.as_tensor(normal)).numpy()
    # the NCC's one-pass variances (E[x^2] - E[x]^2) of low-texture patches
    # lose ~1e-4 to f32 rounding in either package, and the packages sum the
    # 121 taps in other orders: 1e-4 on 99.9% of the pixels, 1e-3 on all
    err = np.abs(got - ref)
    assert (err <= 1e-4).mean() >= 0.999, np.sort(err.ravel())[-10:]
    np.testing.assert_allclose(got, ref, atol=1e-3)
    # the planes are varied enough to reach every branch of the cost
    assert (ref >= 2.0).any() and (ref < 0.5).mean() > 0.2


def test_propagate_and_random_normals_match_jax(small_room):
    arrs, gt = _problem_arrays(small_room)
    jp, tp = _problems(arrs)
    rays = np.asarray(jpm._precompute(jp, jpm.PatchMatchOptions()).rays)
    depth, normal = _planes(arrs, gt, seed=2)
    for shift in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        # JAX's `propagate`, patch_match.py:309-317 (local to patch_match)
        d_n = jnp.roll(depth, shift, (0, 1))
        n_n = jnp.roll(normal, shift, (0, 1))
        rays_n = jnp.roll(rays, shift, (0, 1))
        num = jnp.sum(n_n * (d_n[..., None] * rays_n), axis=-1)
        den = jnp.sum(n_n * rays, axis=-1)
        den = jnp.where(jnp.abs(den) < 1e-9, 1e-9, den)
        d_t, n_t = tpm._propagate(torch.as_tensor(depth),
                                  torch.as_tensor(normal),
                                  torch.as_tensor(rays), shift)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(num / den),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_n))
    key = jax.random.PRNGKey(3)
    g = _t(jax.random.normal(key, depth.shape + (3,), jnp.float32))
    np.testing.assert_allclose(
        tpm._random_normals(g, torch.as_tensor(rays)).numpy(),
        np.asarray(jpm._random_normals(key, jnp.asarray(rays))), atol=1e-5)


def test_solver_on_jax_draws_matches_jax(small_room):
    arrs, gt = _problem_arrays(small_room)
    jp, tp = _problems(arrs)
    jo, to = _options(num_iterations=2)
    key = jax.random.PRNGKey(0)
    d_j, n_j, c_j = (np.asarray(x) for x in jpm.patch_match(key, jp, jo))
    draws = jax_draws(key, *gt.shape, to)
    d_t, n_t, c_t = (x.numpy() for x in tpm.patch_match(draws, tp, to))
    assert draws._next == tpm.num_perturbation_draws(to)
    rel = np.abs(d_t - d_j) / np.maximum(np.abs(d_j), 1e-6)
    assert (rel <= 1e-3).mean() >= 0.99, (rel <= 1e-3).mean()
    assert ((d_t > 0) == (d_j > 0)).mean() >= 0.99
    np.testing.assert_allclose(np.linalg.norm(n_t[d_t > 0], axis=-1), 1.0,
                               atol=1e-5)
    assert 0.4 < (d_j > 0).mean()


def test_port_generator_meets_jax_gates():
    """tests/test_mvs.py:101-129 on the port, drawing from a
    torch.Generator: the 4-image room at 160x120, reference defaults."""
    room = _room(160, 120, 140.0)
    arrs, gt = _problem_arrays(room)
    tp = _problems(arrs)[1]
    g = torch.Generator().manual_seed(0)
    depth, normal, _ = (x.numpy() for x in tpm.patch_match(
        tpm.GeneratorDraws(g, gt.shape), tp, tpm.PatchMatchOptions()))
    ok = (depth > 0) & (gt > 0)
    assert ok.mean() > 0.4
    rel = np.abs(depth - gt)[ok] / gt[ok]
    assert np.median(rel) < 0.05, np.median(rel)
    assert (rel < 0.05).mean() > 0.6
    np.testing.assert_allclose(np.linalg.norm(normal[ok], axis=-1), 1.0,
                               atol=1e-3)


@pytest.mark.parametrize("geom", [False, True])
def test_active_half_equals_whole_image(geom):
    room = _room(48, 36, 42.0)
    arrs, _ = _problem_arrays(room, geom=geom)
    tp = _problems(arrs)[1]
    to = tpm.PatchMatchOptions(num_iterations=2, geom_consistency=geom)
    outs = []
    for active_half in (True, False):
        g = torch.Generator().manual_seed(5)
        outs.append(tpm.patch_match(tpm.GeneratorDraws(g, (36, 48)), tp, to,
                                    active_half=active_half))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert (outs[0][0] > 0).float().mean() > 0.2
