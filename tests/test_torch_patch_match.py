"""The port's PatchMatch stereo against the JAX package on the CPU, and
its cost kernel against the plain twin on the card.

Held on the same rendered room (numpy-seeded renderer, 96x72, 3 sources):
`_precompute` (1e-6); the photometric and the geometric cost of the same
planes, also at 1 and 5 sources and window step 2 (1e-4 absolute on
99.9% of the pixels, 1e-3 on all: the one-pass variances of low-texture
patches lose ~1e-4 to f32 in either package and the sums run in other
orders); neighbour propagation and the random normals
(1e-5); the whole solver fed JAX's own draws (`RecordedDraws` filled by
replaying `patch_match`'s `jax.random.split` chain, 2 iterations): depth
within 1e-3 relative and the same filter mask on >= 99% of the pixels
(near-ties in `c_c < cost` and in the top-k flip single pixels between f32
orders); the port's own generator held to tests/test_mvs.py's gates on the
4-image 160x120 room; and the active-colour evaluation equal to the masked
whole-image one. The per-solve constants that `_precompute` hoists out of
the cost are the ones `_set_cost` computed per call, and CPU tensors never
reach the kernel.

On the card (`-m cuda`; the tests skip without a CUDA device): the cost
kernel (`hopper_patch_match`, one launch per `_set_cost` call) against the
twin `_set_cost_reference` on the same CUDA inputs, at the benchmark cell's
640x480 with 8 sources (both passes, both checkerboard colours and the
whole image), at 1, 3 and 13 sources, window radius 2 and 5 at steps 1
and 2, 96x72 and 2048x1536, with the tolerance above: the kernel's warp,
in-source test and geometric term are the twin's operation for operation,
and only the seven sums' order and the photometric sample's coordinate
path (grid_sample's [-1, 1] round trip in the twin) differ. On the cell's
own rendered scene both are held against the twin's float64 evaluation
of the same inputs (on the CPU too, at 96x72), and the kernel launches
once per call and refuses sizes beyond its limits. The machine with the
card has no JAX; there the JAX tests skip:

    python -m pytest tests/test_torch_patch_match.py -m cuda -q --noconftest -o addopts=""
"""

import importlib.util

import numpy as np
import pytest
import torch

from colmap_tpu_torch import bench_patch_match as bpm
from colmap_tpu_torch.mvs import hopper_patch_match as hpm
from colmap_tpu_torch.mvs import patch_match as tpm
from colmap_tpu_torch.scene import synthetic_images as synth
from colmap_tpu_torch.util import timer

# the machine with the card has no JAX and runs the port alone; wherever
# JAX is installed the JAX package is imported, and a broken import fails
HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    import jax
    import jax.numpy as jnp

    from colmap_tpu.mvs import patch_match as jpm

needs_jax = pytest.mark.skipif(not HAVE_JAX, reason="needs JAX")

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


@pytest.fixture(scope="module")
def six_room():
    return _room(96, 72, 84.0, n_images=6)


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


@needs_jax
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


# (sources, window radius, window step); the first is the defaults' case
# (smaller windows hold more low-variance patches of this room, whose NCC
# loses more than 1e-4 on 0.2-1.5% of the pixels in either package)
_COST_CASES = [((0, 2, 3), 5, 1), ((0,), 5, 1), ((0, 2, 3, 4, 5), 5, 1),
               ((0, 2, 3), 5, 2), ((0, 2, 3, 4, 5), 5, 2)]


@needs_jax
@pytest.mark.parametrize("geom,srcs,radius,step", [
    pytest.param(geom, srcs, radius, step,
                 id=str(geom) if i == 0 else
                 f"{geom}-S{len(srcs)}-r{radius}-s{step}")
    for geom in (False, True) for i, (srcs, radius, step)
    in enumerate(_COST_CASES)])
def test_cost_matches_jax(small_room, six_room, geom, srcs, radius, step):
    room = six_room if max(srcs) > 3 else small_room
    arrs, gt = _problem_arrays(room, srcs=srcs, geom=geom)
    jp, tp = _problems(arrs)
    jo, to = _options(geom_consistency=geom, window_radius=radius,
                      window_step=step)
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


@needs_jax
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


@needs_jax
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


def _torch_problem(arrs, device="cpu"):
    return tpm.PatchMatchProblem(**{
        k: torch.as_tensor(np.asarray(v), device=device)
        for k, v in arrs.items()})


def _float64_costs(problem, pre, opts, S, depth, normal):
    """The twin's costs of the same float32 inputs evaluated in float64:
    the witness of how far a float32 evaluation rounds."""
    def up(nt):
        return nt._replace(**{
            k: v.double() for k, v in nt._asdict().items()
            if torch.is_tensor(v) and v.is_floating_point()})

    return tpm._set_cost_reference(up(problem), up(pre), opts, up(S),
                                   depth.double(), normal.double())


@pytest.mark.parametrize("geom", [False, True])
def test_twin_against_float64(small_room, geom):
    """At the defaults the twin's float32 costs are within the parity
    tolerance of its own float64 evaluation (the witness the card's test
    on the cell's scene holds the kernel and the twin to)."""
    arrs, gt = _problem_arrays(small_room, geom=geom)
    tp = _torch_problem(arrs)
    opts = tpm.PatchMatchOptions(geom_consistency=geom)
    pre = tpm._precompute(tp, opts)
    depth, normal = (torch.as_tensor(x) for x in _planes(arrs, gt, seed=1))
    for S in tpm._checker_sets(pre):
        d, n = depth.reshape(-1)[S.idx], normal.reshape(-1, 3)[S.idx]
        got = tpm._set_cost_reference(tp, pre, opts, S, d, n)
        exact = _float64_costs(tp, pre, opts, S, d, n)
        assert exact.dtype == torch.float64
        err = (got.double() - exact).abs()
        assert float((err <= 1e-4).double().mean()) >= 0.999
        assert float(err.max()) <= 1e-3, float(err.max())
        _reaches_every_branch(exact)


def test_precompute_hoists_the_cost_constants(small_room):
    """A = K_src R K_ref^-1, b = K_src t and K_src^-1, once a solve, are
    what `_set_cost` computed on every call, bit for bit; and the taps'
    spatial weights are the factor of `bil_w`."""
    arrs, _ = _problem_arrays(small_room, geom=True)
    tp = _torch_problem(arrs)
    pre = tpm._precompute(tp, tpm.PatchMatchOptions())
    Kinv = torch.linalg.inv(tp.K_ref)
    assert torch.equal(pre.Kinv, Kinv)
    assert pre.Kinv.is_contiguous() and pre.Ksrc_inv.is_contiguous()
    assert torch.equal(pre.A, tp.K_src @ tp.R_rel @ Kinv)
    assert torch.equal(pre.b, (tp.K_src @ tp.t_rel[..., None])[..., 0])
    assert torch.equal(pre.Ksrc_inv, torch.linalg.inv(tp.K_src))
    assert pre.spatial_w.shape == (121,) and pre.spatial_w.max() == 1.0
    inb = pre.bil_w > 0
    col = pre.bil_w[inb] / pre.spatial_w.expand_as(pre.bil_w)[inb]
    assert float(col.max()) <= 1.0 + 1e-6


def test_valid_share_test_is_exact():
    """The twin's `s_n * 2 > P` is `s_n / P > 0.5` in float32 for every
    whole count up to P + 7 (padding included), so the CPU results stay
    what they were."""
    for P in range(1, 1090):
        s_n = torch.arange(P + 8, dtype=torch.float32)
        assert torch.equal(s_n / P > 0.5, s_n * 2 > P), P


def test_cpu_tensors_never_reach_the_kernel(small_room):
    """A whole solve and the cost function on CPU tensors take the twin:
    no build, no launch."""
    arrs, gt = _problem_arrays(small_room, geom=True)
    tp = _torch_problem(arrs)
    opts = tpm.PatchMatchOptions(num_iterations=1, geom_consistency=True)
    before = hpm.launches
    g = torch.Generator().manual_seed(3)
    depth, _, _ = tpm.patch_match(tpm.GeneratorDraws(g, gt.shape), tp, opts)
    d, n = _planes(arrs, gt, seed=4)
    tpm._cost_fn(tp, tpm._precompute(tp, opts), opts)(
        torch.as_tensor(d), torch.as_tensor(n))
    assert hpm.launches == before == 0
    assert hpm._lib is None
    assert (depth > 0).float().mean() > 0.2


def test_kernel_wrapper_refuses_what_it_cannot_launch(small_room):
    arrs, gt = _problem_arrays(small_room)
    tp = _torch_problem(arrs)
    opts = tpm.PatchMatchOptions()
    pre = tpm._precompute(tp, opts)
    S = tpm._checker_sets(pre)[0]
    d, n = (torch.as_tensor(x).reshape(-1, *x.shape[2:])[S.idx]
            for x in _planes(arrs, gt, seed=5))
    with pytest.raises(ValueError, match="CUDA tensors"):
        hpm.set_cost(tp, pre, opts, S.idx, d, n)
    with pytest.raises(ValueError, match="no PatchMatch cost"):
        tpm._set_cost(tp, pre, opts, S, d.to("meta"), n.to("meta"))
    assert hpm.launches == 0


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cost kernel has no CPU mode")
    return "cuda"


def _kernel_against_twin(problem, opts, S, depth, normal, pre=None):
    """One `_set_cost` call (one launch) against the twin on the same
    CUDA inputs; returns the twin's costs."""
    pre = pre if pre is not None else tpm._precompute(problem, opts)
    d = depth.reshape(-1)[S.idx]
    n = normal.reshape(-1, 3)[S.idx]
    before = hpm.launches
    got = tpm._set_cost(problem, pre, opts, S, d, n)
    assert hpm.launches == before + 1
    ref = tpm._set_cost_reference(problem, pre, opts, S, d, n)
    torch.cuda.synchronize()
    # the seven sums run in another order than the twin's reductions and
    # the one-pass variances of low-texture windows lose ~1e-4 to float32:
    # 1e-4 on 99.9% of the pixels, 1e-3 on all
    err = (got - ref).abs()
    assert float((err <= 1e-4).float().mean()) >= 0.999, \
        torch.sort(err).values[-10:]
    assert float(err.max()) <= 1e-3, float(err.max())
    return ref


def _reaches_every_branch(ref):
    """The planes give both good and poor costs."""
    assert bool((ref > 1.0).any())
    assert float((ref < 0.5).float().mean()) > 0.2


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [False, True])
@pytest.mark.parametrize("which", ["colour0", "colour1", "whole"])
def test_kernel_equals_twin_at_the_cell(cuda, geom, which):
    """The benchmark cell's shape: 640x480, 8 sources, window radius 5."""
    problem, gt = bpm.plane_problem(480, 640, 8, cuda, seed=1, geom=geom)
    opts = tpm.PatchMatchOptions(geom_consistency=geom)
    pre = tpm._precompute(problem, opts)
    S = (tpm._pixel_set(pre, torch.arange(gt.numel(), device=cuda))
         if which == "whole" else tpm._checker_sets(pre)[int(which[-1])])
    depth, normal = bpm.plane_candidates(problem, gt, seed=2)
    _reaches_every_branch(
        _kernel_against_twin(problem, opts, S, depth, normal, pre))


def _cell_scene(device, seed):
    """The benchmark cell's own scene, from its workload file: the orbit
    room with texture at seven scales rendered at 640x480 through TUM's
    Freiburg 3 calibration; keyframe 5 of the 12 is the reference and the
    8 keyframes nearest it are its sources (their true depth maps are the
    geometric pass's input). Returns (problem, true depth, true normals)
    on `device`."""
    import json
    import os

    from benchmark.inputs import render, workspace

    with open(os.path.join(os.path.dirname(__file__), "..", "benchmark",
                           "workloads", "tum_rgbd_fr3.dense.json")) as f:
        p = json.load(f)["params"]
    orbit = render.Orbit(num_images=p["orbit_frames"], width=p["width"],
                         height=p["height"], texture_res=p["texture_res"])
    c = p["camera"]
    K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]],
                  [0, 0, 1.0]])
    frames = [k * p["frame_step"] for k in (5, 1, 2, 3, 4, 6, 7, 8, 9)]
    faces = render.orbit_faces(orbit)
    Rs, ts = render.orbit_poses(orbit, frames)
    g = torch.Generator(device=device).manual_seed(seed)
    tex = render.draw_textures(len(faces), orbit.texture_res, g,
                               p["texture_cells"], p["texture_weights"])
    images, depth, face = render.render(tex, faces, K, Rs, ts, p["width"],
                                        p["height"], with_face=True)
    normal = workspace.true_normals(face[:1].cpu().numpy(),
                                    render.face_normals(faces, Rs[:1]), K)
    R_rel = np.stack([R @ Rs[0].T for R in Rs[1:]])
    t_rel = np.stack([t - R_rel[i] @ ts[0] for i, t in enumerate(ts[1:])])
    gt = depth[0]

    def put(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    problem = tpm.PatchMatchProblem(
        ref_image=images[0].to(torch.float32) / 255.0,
        src_images=images[1:].to(torch.float32) / 255.0, K_ref=put(K),
        K_src=put(np.stack([K] * 8)), R_rel=put(R_rel), t_rel=put(t_rel),
        depth_min=put(float(gt[gt > 0].min()) * 0.7),
        depth_max=put(float(gt[gt > 0].max()) * 1.3), src_depths=depth[1:])
    return problem, gt, put(normal[0])


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [False, True])
def test_kernel_against_float64_on_the_cells_scene(cuda, geom):
    """The benchmark cell's own rendered room at 640x480 with 8 sources,
    both colours: the kernel and the twin each against the float64
    evaluation of the same planes. The kernel is within 1e-5 of float64
    on at least as many pixels as the twin and its mean error is no
    larger (its sums about the window's centre cancel less); at 1e-4 the
    two leave float64 on the same ~0.03% of the geometric pass's pixels
    (the geometric term's float32 coordinates, the same operations in
    both), give or take a few ties at the threshold, so there the kernel
    is held to the twin by the parity tolerance."""
    problem, gt, true_n = _cell_scene(cuda, seed=1)
    if not geom:
        problem = problem._replace(src_depths=None)
    opts = tpm.PatchMatchOptions(geom_consistency=geom)
    pre = tpm._precompute(problem, opts)
    gen = torch.Generator(device=cuda).manual_seed(2)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=cuda)

    # depths within 2% of the truth (a third anywhere in the range),
    # normals half near the surface's and half random, facing the camera
    lo, hi = float(problem.depth_min), float(problem.depth_max)
    depth = torch.where((rand(*gt.shape) < 1 / 3) | (gt <= 0),
                        lo + (hi - lo) * rand(*gt.shape),
                        gt * (0.98 + 0.04 * rand(*gt.shape)))
    noise = torch.randn((*gt.shape, 3), generator=gen, device=cuda)
    normal = torch.where(rand(*gt.shape, 1) < 0.5, true_n + 0.05 * noise,
                         noise + torch.tensor([0, 0, -3.0], device=cuda))
    normal = normal / normal.norm(dim=-1, keepdim=True)
    errs = {"kernel": [], "twin": [], "kernel-twin": []}
    for S in tpm._checker_sets(pre):
        d, n = depth.reshape(-1)[S.idx], normal.reshape(-1, 3)[S.idx]
        before = hpm.launches
        got = tpm._set_cost(problem, pre, opts, S, d, n)
        assert hpm.launches == before + 1
        twin = tpm._set_cost_reference(problem, pre, opts, S, d, n)
        exact = _float64_costs(problem, pre, opts, S, d, n)
        _reaches_every_branch(exact)
        errs["kernel"].append((got.double() - exact).abs())
        errs["twin"].append((twin.double() - exact).abs())
        errs["kernel-twin"].append((got - twin).abs().double())
    errs = {k: torch.cat(e) for k, e in errs.items()}
    reading = {k: (float((e <= 1e-5).double().mean()),
                   float((e <= 1e-4).double().mean()), float(e.mean()),
                   float(e.max())) for k, e in errs.items()}
    assert reading["kernel"][0] >= reading["twin"][0], reading
    assert reading["kernel"][2] <= reading["twin"][2], reading
    assert reading["kernel-twin"][1] >= 0.999, reading
    assert reading["kernel-twin"][3] <= 1e-3, reading


@pytest.fixture(scope="module")
def smooth_room():
    """The port's own room at 640x480 (its coarse texture: flat windows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cost kernel has no CPU mode")
    return _room(640, 480, 576.0, n_images=9)


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [False, True])
def test_kernel_against_float64_on_flat_windows(cuda, smooth_room, geom):
    """Where the windows are nearly flat the float32 NCC is ill-posed and
    two float32 evaluations part: there the twin is the one that leaves
    float64 (its one-pass variances cancel) and the kernel, whose sums run
    about the window's centre, stays within 1e-3 of it on 99.9% of the
    pixels, nearer than the twin at 1e-5 and 1e-4 and in the mean."""
    arrs, gt = _problem_arrays(smooth_room, ref=0, srcs=range(1, 9),
                               geom=geom)
    problem = _torch_problem(arrs, cuda)
    opts = tpm.PatchMatchOptions(geom_consistency=geom)
    pre = tpm._precompute(problem, opts)
    depth, normal = (torch.as_tensor(x, device=cuda)
                     for x in _planes(arrs, gt, seed=0))
    errs = {"kernel": [], "twin": []}
    for S in tpm._checker_sets(pre):
        d, n = depth.reshape(-1)[S.idx], normal.reshape(-1, 3)[S.idx]
        got = tpm._set_cost(problem, pre, opts, S, d, n)
        twin = tpm._set_cost_reference(problem, pre, opts, S, d, n)
        exact = _float64_costs(problem, pre, opts, S, d, n)
        errs["kernel"].append((got.double() - exact).abs())
        errs["twin"].append((twin.double() - exact).abs())
    errs = {k: torch.cat(e) for k, e in errs.items()}
    reading = {k: [float((e <= t).double().mean()) for t in (1e-5, 1e-4,
                                                            1e-3)]
               + [float(e.mean())] for k, e in errs.items()}
    kernel, twin = reading["kernel"], reading["twin"]
    assert kernel[2] >= 0.999, reading
    assert kernel[0] >= twin[0] and kernel[1] >= twin[1], reading
    assert kernel[3] <= twin[3], reading


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [False, True])
@pytest.mark.parametrize("n_src", [1, 3, 13])
def test_kernel_equals_twin_across_sources(cuda, n_src, geom):
    """Fewer sources than a group of the kernel, and more than three."""
    problem, gt = bpm.plane_problem(120, 160, n_src, cuda, seed=n_src,
                                     geom=geom)
    opts = tpm.PatchMatchOptions(geom_consistency=geom)
    pre = tpm._precompute(problem, opts)
    depth, normal = bpm.plane_candidates(problem, gt, seed=3)
    for S in tpm._checker_sets(pre):
        _kernel_against_twin(problem, opts, S, depth, normal, pre)


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [False, True])
@pytest.mark.parametrize("radius,step", [(2, 1), (2, 2), (5, 1), (5, 2)])
def test_kernel_equals_twin_across_windows(cuda, radius, step, geom):
    problem, gt = bpm.plane_problem(120, 160, 4, cuda, seed=7, geom=geom)
    opts = tpm.PatchMatchOptions(window_radius=radius, window_step=step,
                                 geom_consistency=geom, top_k=3)
    pre = tpm._precompute(problem, opts)
    depth, normal = bpm.plane_candidates(problem, gt, seed=4)
    _reaches_every_branch(_kernel_against_twin(
        problem, opts, tpm._checker_sets(pre)[1], depth, normal, pre))


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [False, True])
def test_kernel_equals_twin_on_the_small_room(cuda, small_room, geom):
    """96x72, the rendered room of the JAX parity tests, 3 sources."""
    arrs, gt = _problem_arrays(small_room, geom=geom)
    problem = _torch_problem(arrs, cuda)
    opts = tpm.PatchMatchOptions(geom_consistency=geom)
    pre = tpm._precompute(problem, opts)
    d, n = (torch.as_tensor(x, device=cuda) for x in _planes(arrs, gt, 1))
    for S in tpm._checker_sets(pre):
        _kernel_against_twin(problem, opts, S, d, n, pre)


@pytest.mark.cuda
def test_kernel_equals_twin_at_2048x1536(cuda):
    """The ETH3D size's maps: one call, 8 sources, both terms."""
    problem, gt = bpm.plane_problem(1536, 2048, 8, cuda, seed=11, geom=True)
    opts = tpm.PatchMatchOptions(geom_consistency=True)
    pre = tpm._precompute(problem, opts)
    depth, normal = bpm.plane_candidates(problem, gt, seed=6)
    _reaches_every_branch(_kernel_against_twin(
        problem, opts, tpm._checker_sets(pre)[0], depth, normal, pre))


@pytest.mark.cuda
def test_kernel_refuses_sizes_beyond_its_limits(cuda):
    """The C entry holds the launch limits: min(top_k, sources) above 32
    comes back as a ValueError, and nothing is counted."""
    problem, gt = bpm.plane_problem(16, 16, 33, cuda, seed=1)
    opts = tpm.PatchMatchOptions(top_k=33)
    pre = tpm._precompute(problem, opts)
    S = tpm._checker_sets(pre)[0]
    depth, normal = bpm.plane_candidates(problem, gt, seed=2)
    before = hpm.launches
    with pytest.raises(ValueError, match="refused top_k 33, 33 sources"):
        tpm._set_cost(problem, pre, opts, S, depth.reshape(-1)[S.idx],
                      normal.reshape(-1, 3)[S.idx])
    assert hpm.launches == before


@pytest.mark.cuda
def test_solver_launches_once_per_cost_call(cuda):
    """A whole solve on the card: every `patch_match.cost` span is one
    launch of the kernel (86 at the defaults), and the maps are sound."""
    problem, gt = bpm.plane_problem(120, 160, 4, cuda, seed=9, geom=False)
    opts = tpm.PatchMatchOptions()
    before = hpm.launches
    g = torch.Generator(device=cuda).manual_seed(0)
    with timer.span("test.solve") as job:
        depth, normal, _ = tpm.patch_match(tpm.GeneratorDraws(g, gt.shape),
                                           problem, opts)
    torch.cuda.synchronize()
    costs = [s for s in timer.job_spans(job.id)
             if s.name == "patch_match.cost"]
    assert hpm.launches - before == len(costs) == 86
    ok = depth > 0
    assert float(ok.float().mean()) > 0.5
    rel = ((depth - gt).abs() / gt)[ok]
    assert float(rel.median()) < 0.02, float(rel.median())
