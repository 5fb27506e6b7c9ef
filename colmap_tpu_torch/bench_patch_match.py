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
error).

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
