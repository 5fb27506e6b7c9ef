"""PatchMatch's plane selection on Hopper: one fused kernel per half-iteration.

`csrc/patch_match_cost.cu` evaluates, per pixel of a set and each of C
candidate planes, the warp of every window tap into every source, the
bilinear sample, the bilateral NCC, the optional geometric term and the
mean of the top_k lowest source costs, and then keeps, per pixel, the
candidates in order where each is strictly better than the held plane, in
one launch; it is built with nvcc at first use and called through ctypes.
The solver makes one launch for the initial costs (`plane_costs`), one per
propagation half-iteration (4 + num_perturbations candidates on one
colour) and one per refinement half-iteration (2 candidates on both
colours; `select_planes`): 17 a solve at the defaults. A half-iteration's
launch builds its candidates itself, bit for bit as the torch code of
`mvs/patch_match.py` would (`_candidates`: the four neighbours' planes and
the perturbations by the solver's draws, the depths clamped to the
problem's range), from the held planes, the draws and their scales: no
[C, H, W] candidate tensor and none of the ~1,050 torch launches a solve
that built them. At odd H or W a wrapped neighbour shares the launch's
colour, so a propagation launch then reads the neighbours from a copy of
the planes taken before it.
A block holds 32 pixels and min(C, 8) warps, one candidate a warp; at
640x480 a propagation launch is 4,800 blocks of 6 warps over 528 slots
(9.1 waves), a refinement launch 9,600 blocks of 2 warps over 1,584 (6.1).
Keep-if-better is strict and in candidate order: a NaN cost never wins and
a NaN held cost is never beaten.

Its plain PyTorch twin is `_keep_better_reference` in `mvs/patch_match.py`,
on the candidates `_candidates` builds. The solver's `_selector` picks
once a solve: CUDA tensors come here and launch the kernel or raise; CPU
tensors take that torch code and the twin, which alone builds the
reference patches and their weights (the kernel computes them in
registers). The kernel replaces no TPU kernel (the JAX package computes
the cost with XLA ops).
"""

from __future__ import annotations

import ctypes
import threading

import torch

launches = 0  # kernel launches
evaluations = 0  # plane evaluations: pixels x candidates of each launch
built = 0  # candidate planes built in the kernel: pixels x candidates

_INVALID_VALUE = 1  # cudaErrorInvalidValue: the C entry refused its sizes
MAX_DRAWS = 16  # `kMaxDraws`: the perturbation draws a launch reads

_lib = None
# shard threads (parallel/) build and launch at once: the first build and
# the counters' read-modify-write are taken under this lock
_lock = threading.Lock()

_PTRS = ctypes.POINTER(ctypes.c_void_p)
_FLOATS = ctypes.POINTER(ctypes.c_float)


def _library():
    global _lib
    with _lock:
        if _lib is None:
            from colmap_tpu_torch.cuda_build import load_library

            lib = load_library("patch_match_cost", ["patch_match_cost.cu"])
            fn = lib.patch_match_cost
            fn.argtypes = ([ctypes.c_void_p] * 17 + [_PTRS, _PTRS, _FLOATS]
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                           + [ctypes.c_int] * 8 + [ctypes.c_float] * 3
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def build() -> None:
    """Compile (or load the cached build of) the cost kernel."""
    _library()


def _check(name: str, t: torch.Tensor, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous and on {device}")


def plane_costs(problem, pre, opts, idx, depth: torch.Tensor,
                normal: torch.Tensor, cost: torch.Tensor) -> None:
    """One launch, the initial form: the cost of the plane depth [H, W],
    normal [H, W, 3] at the flat reference pixels `idx` [N] (int64; None:
    every pixel), written into cost [H, W]. Every tensor lies on one CUDA
    device, float32 and contiguous; the launch goes to that device on the
    calling thread's current stream."""
    h, w = problem.ref_image.shape
    _launch(problem, pre, opts, idx, cost, [
        ("depth", depth, (h, w)), ("normal", normal, (h, w, 3))], 1,
        (depth, normal) + (None,) * 6)


def select_planes(problem, pre, opts, idx, cost: torch.Tensor,
                  depth: torch.Tensor, normal: torch.Tensor, draws,
                  scales, propagate: bool) -> None:
    """One launch of a half-iteration at the flat reference pixels `idx`
    [N] (int64; None: every pixel): build the candidate planes of each
    pixel as `patch_match._candidates` does (with `propagate`, the planes
    of the four neighbours first; then the perturbation of the held plane
    by each draw (u [H, W], g [H, W, 3]) at its scale; each depth clamped to
    [problem.depth_min, problem.depth_max]), evaluate them and replace the
    held plane (depth [H, W], normal [H, W, 3], cost [H, W], updated in
    place) by candidate j, in order, where its cost is strictly below the
    held cost. A NaN cost never wins and a NaN held cost is never beaten.
    Every tensor lies on one CUDA device, float32 and contiguous; the
    launch goes to that device on the calling thread's current stream."""
    h, w = problem.ref_image.shape
    draws = list(draws)
    scales = [float(s) for s in scales]
    if len(scales) != len(draws):
        raise ValueError(f"{len(draws)} draws and {len(scales)} scales")
    checks = [("depth", depth, (h, w)), ("normal", normal, (h, w, 3)),
              ("depth_min", problem.depth_min, ()),
              ("depth_max", problem.depth_max, ())]
    for k, (u, g) in enumerate(draws):
        checks += [(f"u[{k}]", u, (h, w)), (f"g[{k}]", g, (h, w, 3))]
    prev = (depth, normal)
    if propagate and (h % 2 or w % 2):
        # a wrapped neighbour shares the launch's colour: read the planes
        # as they stood before the launch
        prev = (depth.clone(), normal.clone())
    _launch(problem, pre, opts, idx, cost, checks,
            4 * bool(propagate) + len(draws),
            (None, None, depth, normal, *prev, problem.depth_min,
             problem.depth_max), draws, scales, propagate)


def _launch(problem, pre, opts, idx, cost, checks, c, planes, draws=(),
            scales=(), propagate=False) -> None:
    """One launch of C = `c` candidates. `planes`: the C entry's cand_d,
    cand_n, depth, normal, prev_depth, prev_normal, depth_min and
    depth_max, None where the form takes none; `checks`: (name, tensor,
    shape) of the form's float32 inputs."""
    global launches, evaluations, built
    dev = cost.device
    if dev.type != "cuda":
        raise ValueError(f"the cost kernel takes CUDA tensors, got {dev}")
    s, h, w = problem.src_images.shape
    n = h * w if idx is None else idx.shape[0]
    f32 = torch.float32
    nwin = 2 * opts.window_radius // opts.window_step + 1
    geom = opts.geom_consistency and problem.src_depths is not None
    # the launch limits (sizes, window, top_k, candidates, draws) are the
    # C entry's alone
    checks = [(name, t, shape, f32) for name, t, shape in checks] + [
        ("cost", cost, (h, w), f32),
        ("ref_image", problem.ref_image, (h, w), f32),
        ("src_images", problem.src_images, (s, h, w), f32),
        ("rays", pre.rays, (h, w, 3), f32),
        ("spatial_w", pre.spatial_w, (nwin * nwin,), f32),
        ("Kinv", pre.Kinv, (3, 3), f32), ("A", pre.A, (s, 3, 3), f32),
        ("b", pre.b, (s, 3), f32)]
    if idx is not None:
        checks.append(("idx", idx, (n,), torch.int64))
    if geom:
        checks += [("src_depths", problem.src_depths, (s, h, w), f32),
                   ("K_ref", problem.K_ref, (3, 3), f32),
                   ("K_src", problem.K_src, (s, 3, 3), f32),
                   ("R_rel", problem.R_rel, (s, 3, 3), f32),
                   ("t_rel", problem.t_rel, (s, 3), f32),
                   ("Ksrc_inv", pre.Ksrc_inv, (s, 3, 3), f32)]
    for name, t, shape, dtype in checks:
        _check(name, t, shape, dtype, dev)
    lib = _library()

    def ptr(t, given=True):
        return t.data_ptr() if t is not None and given else None

    nd = len(draws)
    u = (ctypes.c_void_p * nd)(*(d[0].data_ptr() for d in draws)) if nd \
        else None
    g = (ctypes.c_void_p * nd)(*(d[1].data_ptr() for d in draws)) if nd \
        else None
    sc = (ctypes.c_float * nd)(*scales) if nd else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the launch goes to the calling thread's current device: make it the
    # tensors' card (a shard thread on cuda:1 may have another current)
    with torch.cuda.device(dev):
        err = lib.patch_match_cost(
            problem.ref_image.data_ptr(), problem.src_images.data_ptr(),
            pre.rays.data_ptr(), pre.spatial_w.data_ptr(),
            pre.Kinv.data_ptr(), pre.A.data_ptr(), pre.b.data_ptr(),
            ptr(idx), ptr(planes[0]), ptr(planes[1]), cost.data_ptr(),
            *(ptr(t) for t in planes[2:]), u, g, sc, nd, int(propagate),
            ptr(problem.src_depths, geom), ptr(problem.K_ref, geom),
            ptr(problem.K_src, geom), ptr(problem.R_rel, geom),
            ptr(problem.t_rel, geom), ptr(pre.Ksrc_inv, geom),
            h, w, s, n, c, opts.window_radius, opts.window_step,
            opts.top_k, 2 * opts.sigma_color ** 2,
            opts.geom_consistency_regularizer,
            opts.geom_consistency_max_cost, stream)
    if err == _INVALID_VALUE:
        raise ValueError(
            f"the cost kernel refused top_k {opts.top_k}, {s} sources, "
            f"window radius {opts.window_radius} step {opts.window_step}, "
            f"{w}x{h} images, {c} candidates, {nd} draws (its limits: "
            f"`patch_match_cost` in csrc/patch_match_cost.cu)")
    if err != 0:
        raise RuntimeError(f"patch_match_cost launch failed: cudaError {err}")
    with _lock:
        launches += 1
        evaluations += n * c
        if planes[0] is None:
            built += n * c
