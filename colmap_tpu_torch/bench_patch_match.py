"""Time the port's PatchMatch stereo on one GPU.

    python -m colmap_tpu_torch.bench_patch_match [--out FILE]

The JAX package's dense-stereo cell (bench.py:236-300) on the port: a
rendered room (seed 2, focal 0.9 x width), reference image 0 with sources
1..4, depth range from the ground truth (0.7 x min, 1.3 x max), the
reference defaults (window 11 x 11, 5 iterations of 4-neighbour
propagation and 2 perturbations, 3 refinement iterations, top-2 trimmed
mean, no geometric term). At 640x480: one warm-up solve, three timed
solves (maps/s, Mpix/s), the peak device memory, and one solve under
torch.profiler (the top kernels, the kernel launches per map and the
device's busy share: kernel time over wall time). Then one 2048x1536
problem (the reference's max_image_size regime): seconds and peak memory.
Both are held to the ground truth (estimated share, median relative depth
error). Last, one launch of each kind the solver makes (`launch_times`:
the initial costs, a propagation and a refinement half-iteration) at the
dense cell's shape, 640x480 with 8 sources, in both passes: ms a launch,
ns a plane evaluation and the launch's bound.

The bound is the least time the card could take for the photometric
cost's arithmetic: the port evaluates (1 + num_iterations * (4 +
num_perturbations) + 4 * num_refinement_iterations) whole-image
equivalents of the cost (a propagation candidate only on the active
checkerboard colour), each tap of each source at FLOPS_PER_TAP float32
operations, against the card's float32 peak outside the tensor cores.
Prints one JSON line; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from colmap_tpu_torch.bench_ba import top_device_ops
from colmap_tpu_torch.mvs import patch_match as pm
from colmap_tpu_torch.scene import synthetic_images as synth

SIZE, SOURCES, BIG = (640, 480), 4, (2048, 1536)
FP32_FLOPS_PER_S = 67e12  # H100 SXM, published, at a 700 W power limit
# per tap and source in _photometric_cost: the affine warp (3 adds), two
# divisions, the normalisation to grid_sample's [-1, 1] (2 multiply-adds),
# the bilinear sample (2 floors, 4 fraction terms, 4 weights, 4 multiplies,
# 3 adds: 17), the weighted products (6) and the seven running sums (7);
# the compares of the in-image test are not counted
FLOPS_PER_TAP = 3 + 2 + 4 + 17 + 6 + 7
# per source in _geom_cost: the point into the source (R X + t: 18), its
# projection (15) and division (2, clamp 1), the bilinear depth sample
# (17), the back-projected ray (15) scaled by the depth less t (6), back
# into the reference (R^T: 15), its projection (15, clamp 1, 2 divisions),
# the pixel distance (6), the clamp and mask (2), and the regulariser's
# multiply-add (2)
GEOM_FLOPS_PER_SOURCE = 18 + 15 + 3 + 17 + 15 + 6 + 15 + 18 + 6 + 2 + 2
# one plane evaluation's own count, which the kernel's bound takes (the
# solve's bound above counts the twin's operations): per pixel, source and
# tap the affine warp (3 adds), two quotients, the bilinear sample (17),
# the source sample's three weighted products (w v, w v v, w r v) and the
# seven sums; per pixel and tap, shared by the sources, the reference
# tap's bilateral weight (r - r_c, its square and scale, exp, the spatial
# factor: 5) and w r, w r r (2); the per-source NCC from the sums (~16
# against 121 taps) is not counted
CALL_FLOPS_PER_SOURCE_TAP = 3 + 2 + 17 + 3 + 7
CALL_FLOPS_PER_TAP = 5 + 2


def build(width: int, height: int, n_src: int, device="cuda"):
    """The JAX bench's problem: (PatchMatchProblem on device, GT depth)."""
    o = synth.RoomDatasetOptions(num_images=n_src + 1, width=width,
                                 height=height, focal=0.9 * width, seed=2)
    images, K, Rs, ts, depths = synth.render_room_dataset(o, return_depth=True)
    ref, srcs = 0, list(range(1, n_src + 1))
    R_rel = np.stack([Rs[s] @ Rs[ref].T for s in srcs])
    t_rel = np.stack([ts[s] - R_rel[i] @ ts[ref] for i, s in enumerate(srcs)])
    gt = depths[ref]

    def put(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    problem = pm.PatchMatchProblem(
        ref_image=put(images[ref]) / 255.0,
        src_images=put(np.stack([images[s] for s in srcs])) / 255.0,
        K_ref=put(K), K_src=put(np.stack([K] * n_src)), R_rel=put(R_rel),
        t_rel=put(t_rel), depth_min=put(gt[gt > 0].min() * 0.7),
        depth_max=put(gt[gt > 0].max() * 1.3))
    return problem, gt


def _rotation(rng, degrees: float) -> np.ndarray:
    """A rotation by `degrees` about a random axis."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = np.deg2rad(degrees)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k


def plane_problem(height: int, width: int, n_src: int, device="cuda",
                  seed: int = 0, geom: bool = False):
    """A problem whose every window has texture, at any size and source
    count: a tilted plane 3 m away, textured by 24 random sinusoids (0.3 to
    12 cycles a metre up to a width of 640, proportionally finer above, so
    that a window holds as much texture at any size), seen by the
    reference camera (focal 0.9 x width)
    and `n_src` sources turned 2-5 degrees and moved up to 0.4 m, with 1%
    pixel noise. Returns (PatchMatchProblem on `device`, true depth [H, W]);
    with `geom`, the sources' true depth maps, a tenth of their pixels
    zeroed as if filtered, are its `src_depths`."""
    h, w = height, width
    rng = np.random.default_rng(seed)
    f = 0.9 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    D = 3.0
    dev = torch.device(device)
    f64 = torch.float64

    def t64(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)

    g = t64([0.15, -0.1, 1.0])  # the plane g . X = D
    cycles = rng.uniform(0.3, 12.0, (24, 1)) * max(1.0, w / 640)
    direction = rng.normal(size=(24, 2))
    freq = t64(cycles * direction
               / np.linalg.norm(direction, axis=-1, keepdims=True))
    phase = t64(rng.uniform(0, 2 * np.pi, 24))
    amp = t64(rng.uniform(0.5, 1.0, 24) / np.sqrt(24))
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=f64),
                            torch.arange(w, device=dev, dtype=f64),
                            indexing="ij")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def image(R, t, centre):
        """Intensity and depth of the plane seen by the camera (R, t),
        pixel (x, y) on the ray through (x + centre, y + centre)."""
        q = torch.stack([xs + centre, ys + centre, torch.ones_like(xs)], -1)
        rr = q @ t64(np.linalg.inv(K).T) @ t64(R)  # R^T K^-1 q, row form
        c = t64(R.T @ t)
        lam = (D + g @ c) / (rr @ g)
        X = lam[..., None] * rr - c
        tex = (amp * torch.sin(2 * np.pi * (X[..., :2] @ freq.T)
                               + phase)).sum(-1)
        noise = torch.randn(tex.shape, generator=gen, device=dev, dtype=f64)
        return (0.5 + 0.25 * tex + 0.01 * noise).clamp(0, 1), lam

    # the solver's rays pass through the reference pixels' centres (+0.5)
    # and it samples a source at its pixel coordinates (the JAX sampler's)
    ref, gt = image(np.eye(3), np.zeros(3), 0.5)
    srcs, depths, Rs, ts = [], [], [], []
    for _ in range(n_src):
        R = _rotation(rng, rng.uniform(2, 5))
        t = rng.uniform(-0.4, 0.4, 3) * [1, 0.5, 0.25]
        img, lam = image(R, t, 0.0)
        keep = torch.rand(lam.shape, generator=gen, device=dev) > 0.1
        srcs.append(img)
        depths.append(lam * keep)
        Rs.append(R)
        ts.append(t)

    def put(x):
        return t64(x).to(torch.float32) if not torch.is_tensor(x) \
            else x.to(torch.float32)

    problem = pm.PatchMatchProblem(
        ref_image=put(ref), src_images=put(torch.stack(srcs)), K_ref=put(K),
        K_src=put(np.stack([K] * n_src)), R_rel=put(np.stack(Rs)),
        t_rel=put(np.stack(ts)), depth_min=put(float(gt.min()) * 0.7),
        depth_max=put(float(gt.max()) * 1.3),
        src_depths=put(torch.stack(depths)) if geom else None)
    return problem, gt.to(torch.float32)


def plane_candidates(problem, gt: torch.Tensor, seed: int):
    """Planes to evaluate on a `plane_problem`: depths within 2% of the
    truth (a third drawn anywhere in the depth range), normals half near the
    plane's and half random, all facing the camera; (depth [H, W], normal
    [H, W, 3]) on the problem's device."""
    gen = torch.Generator(device=gt.device).manual_seed(seed)
    h, w = gt.shape

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=gt.device)

    lo, hi = float(problem.depth_min), float(problem.depth_max)
    depth = torch.where(rand(h, w) < 1 / 3, lo + (hi - lo) * rand(h, w),
                        gt * (0.98 + 0.04 * rand(h, w)))
    true_n = -torch.tensor([0.15, -0.1, 1.0], device=gt.device)
    noise = torch.randn((h, w, 3), generator=gen, device=gt.device)
    normal = torch.where(rand(h, w, 1) < 0.5, true_n + 0.05 * noise,
                         noise + torch.tensor([0, 0, -3.0], device=gt.device))
    return depth, normal / normal.norm(dim=-1, keepdim=True)


def cost_evaluations(opts: pm.PatchMatchOptions) -> int:
    """Whole-image equivalents of the cost one solve evaluates."""
    return (1 + opts.num_iterations * (4 + opts.num_perturbations)
            + 2 * opts.num_refinement_iterations * 2)


def bound_ms(width: int, height: int, n_src: int,
             opts: pm.PatchMatchOptions) -> float:
    taps = (2 * opts.window_radius // opts.window_step + 1) ** 2
    flops = (width * height * cost_evaluations(opts) * n_src * taps
             * FLOPS_PER_TAP)
    return flops / FP32_FLOPS_PER_S * 1e3


def cost_call_bound_ms(pixels: int, n_src: int, opts: pm.PatchMatchOptions,
                       geometric: bool) -> float:
    """The least time the kernel could take to evaluate one plane at each
    of `pixels` pixels (its float32 operations over the float32 peak); a
    launch of C candidates takes C times it."""
    taps = (2 * opts.window_radius // opts.window_step + 1) ** 2
    per = taps * (n_src * CALL_FLOPS_PER_SOURCE_TAP + CALL_FLOPS_PER_TAP)
    if geometric:
        per += n_src * GEOM_FLOPS_PER_SOURCE
    return pixels * per / FP32_FLOPS_PER_S * 1e3


CELL = (640, 480, 8)  # the dense cell's maps: width, height, sources


def launch_times(device="cuda", reps: int = 20) -> list:
    """One launch of each kind the solver makes (`patch_match._selector`:
    the initial planes on every pixel, a propagation half-iteration's 4 +
    num_perturbations candidates on one colour, a refinement
    half-iteration's 2 candidates on both colours, the last two built in
    the launch from the held planes and the draws) at the cell's shape, on
    `plane_problem` (texture in every window), photometric and geometric:
    ms a launch (CUDA events over `reps` launches), ns a plane evaluation,
    and the bound: `cost_call_bound_ms` of the launch's pixels times its
    candidates."""
    from colmap_tpu_torch.bench_matcher import cuda_ms
    from colmap_tpu_torch.mvs import hopper_patch_match as hpm

    width, height, n_src = CELL
    colour1 = int(pm._colours(height, width, device)[1].numel())
    out = []
    for geom in (False, True):
        problem, gt = plane_problem(height, width, n_src, device, seed=1,
                                    geom=geom)
        opts = pm.PatchMatchOptions(geom_consistency=geom)
        select = pm._selector(problem, pm._precompute(problem, opts), opts)
        n_pert = opts.num_perturbations
        depth, normal = plane_candidates(problem, gt, seed=2)
        gen = torch.Generator(device=device).manual_seed(3)
        draws = [pm.GeneratorDraws(gen, (height, width)).perturbation()
                 for _ in range(n_pert)]
        cost = torch.empty_like(depth)
        select.costs(None, depth, normal, cost)
        for kind, colour, pixels, c in (
                ("init", None, width * height, 1),
                ("propagation", 1, colour1, 4 + n_pert),
                ("refinement", None, width * height, 2)):
            if kind == "init":
                def launch(out=torch.empty_like(cost)):
                    select.costs(None, depth, normal, out)
            else:
                propagate = kind == "propagation"
                scales = [(0.5 if propagate else 0.02) / (j + 1)
                          for j in range(c - 4 * propagate)]
                state = (cost.clone(), depth.clone(), normal.clone())

                def launch(colour=colour, propagate=propagate,
                           scales=scales, state=state):
                    select.keep_better(colour, propagate,
                                       draws[:len(scales)], scales, *state)

            before = hpm.launches
            launch()
            if hpm.launches != before + 1:
                raise RuntimeError(f"a {kind} launch took "
                                   f"{hpm.launches - before} launches")
            ms = min(cuda_ms(launch, reps), cuda_ms(launch, reps))
            bound = c * cost_call_bound_ms(pixels, n_src, opts, geom)
            out.append(dict(
                kind=kind, geometric=geom, width=width, height=height,
                sources=n_src, pixels=pixels, candidates=c, ms=ms,
                ns_per_evaluation=ms * 1e6 / (pixels * c), bound_ms=bound,
                share=bound / ms))
    return out


def solve(problem, opts, seed=0):
    g = torch.Generator(device=problem.ref_image.device)
    g.manual_seed(seed)
    out = pm.patch_match(pm.GeneratorDraws(g, problem.ref_image.shape),
                         problem, opts)
    torch.cuda.synchronize()
    return out


def accuracy(depth: torch.Tensor, gt: np.ndarray) -> dict:
    d = depth.cpu().numpy()
    ok = (d > 0) & (gt > 0)
    rel = np.abs(d - gt)[ok] / gt[ok]
    return dict(estimated=float((d > 0).mean()),
                median_rel_error=float(np.median(rel)) if ok.any() else None)


def run(device="cuda"):
    """The 640x480 cell, then the 2048x1536 problem; returns a dict."""
    opts = pm.PatchMatchOptions()
    (width, height), n_src = SIZE, SOURCES
    problem, gt = build(width, height, n_src, device)
    solve(problem, opts)  # warm-up
    secs = []
    for _ in range(3):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        depth, _, _ = solve(problem, opts)
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    ops, dev_ms, wall_ms, launches = top_device_ops(
        lambda: solve(problem, opts), k=8)
    best = min(secs)
    out = dict(
        width=width, height=height, sources=n_src,
        cost_evaluations=cost_evaluations(opts), solve_s=secs,
        maps_per_s=1.0 / best, mpix_per_s=width * height / 1e6 / best,
        peak_bytes=peak, bound_ms=bound_ms(width, height, n_src, opts),
        bound_by="operations", profiled_wall_ms=wall_ms,
        profiled_device_ms=dev_ms, busy_share=dev_ms / wall_ms,
        launches_per_map=launches,
        top_device_ops=[dict(name=n, ms=ms, calls=c) for n, ms, c in ops],
        **accuracy(depth, gt))
    del problem
    bw, bh = BIG
    problem, gt = build(bw, bh, n_src, device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    depth, _, _ = solve(problem, opts)
    out["big"] = dict(width=bw, height=bh, solve_s=time.perf_counter() - t0,
                      peak_bytes=torch.cuda.max_memory_allocated(),
                      bound_ms=bound_ms(bw, bh, n_src, opts),
                      **accuracy(depth, gt))
    del problem
    out["launches"] = launch_times(device)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_patch_match needs a CUDA device")
    out = run()
    out["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
