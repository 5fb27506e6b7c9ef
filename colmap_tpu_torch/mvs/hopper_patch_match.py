"""PatchMatch's plane selection on Hopper: one fused kernel per half-iteration.

`csrc/patch_match_cost.cu` evaluates, per pixel of a set and each of C
candidate planes, the warp of every window tap into every source, the
bilinear sample, the bilateral NCC, the optional geometric term and the
mean of the top_k lowest source costs, and then keeps, per pixel, the
candidates in order where each is strictly better than the held plane, in
one launch (`select_planes`); it is built with nvcc at first use and
called through ctypes. The solver makes one launch for the initial costs,
one per propagation half-iteration (4 + num_perturbations candidates on
one colour) and one per refinement half-iteration (2 candidates on both
colours): 17 a solve at the defaults, where it made 86 launches of one
candidate on one colour and 13 torch launches a candidate to select.
A block holds 32 pixels and min(C, 8) warps, one candidate a warp; at
640x480 a one-colour, one-candidate launch was 1,200 blocks over the
card's 792 slots (1.52 waves), a propagation launch is 4,800 blocks of 6
warps over 528 slots (9.1 waves), a refinement launch 9,600 blocks of 2
warps over 1,584 (6.1). Keep-if-better is strict and in candidate order:
a NaN cost never wins and a NaN held cost is never beaten. The cost of
one plane a pixel is the launch's C = 1 case with no held plane.

Its plain PyTorch twin is `_keep_better_reference` in `mvs/patch_match.py`.
The solver's `_selector` picks once a solve: CUDA tensors come here and
launch the kernel or raise; CPU tensors take the twin, which alone builds
the reference patches and their weights (the kernel computes them in
registers). The kernel replaces no TPU kernel (the JAX package
computes the cost with XLA ops).
"""

from __future__ import annotations

import ctypes
import threading

import torch

launches = 0  # kernel launches
evaluations = 0  # plane evaluations: pixels x candidates of each launch

_INVALID_VALUE = 1  # cudaErrorInvalidValue: the C entry refused its sizes

_lib = None
# shard threads (parallel/) build and launch at once: the first build and
# the counters' read-modify-write are taken under this lock
_lock = threading.Lock()


def _library():
    global _lib
    with _lock:
        if _lib is None:
            from colmap_tpu_torch.cuda_build import load_library

            lib = load_library("patch_match_cost", ["patch_match_cost.cu"])
            fn = lib.patch_match_cost
            fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 8
                           + [ctypes.c_float] * 3 + [ctypes.c_void_p])
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


def select_planes(problem, pre, opts, idx, cand_d: torch.Tensor,
                  cand_n: torch.Tensor, cost: torch.Tensor,
                  depth: torch.Tensor = None,
                  normal: torch.Tensor = None) -> None:
    """One launch: evaluate the C candidate planes (cand_d [C, H, W],
    cand_n [C, H, W, 3]) at the flat reference pixels `idx` [N] (int64;
    None: every pixel) and, per pixel, replace the held plane (depth
    [H, W], normal [H, W, 3], cost [H, W], updated in place) by candidate j,
    in order j = 0 .. C-1, where its cost is strictly below the held cost.
    A NaN cost never wins and a NaN held cost is never beaten. Without depth and normal
    there is no held plane: C must be 1 and its cost is written. Every
    tensor lies on one CUDA device, float32 and contiguous; the launch goes
    to that device on the calling thread's current stream."""
    global launches, evaluations
    dev = cost.device
    if dev.type != "cuda":
        raise ValueError(f"the cost kernel takes CUDA tensors, got {dev}")
    if (depth is None) != (normal is None):
        raise ValueError("depth and normal are given together or not at all")
    s, h, w = problem.src_images.shape
    c = cand_d.shape[0]
    n = h * w if idx is None else idx.shape[0]
    f32 = torch.float32
    nwin = 2 * opts.window_radius // opts.window_step + 1
    geom = opts.geom_consistency and problem.src_depths is not None
    # the launch limits (sizes, window, top_k, candidates) are the C
    # entry's alone
    checks = [("cand_d", cand_d, (c, h, w), f32),
              ("cand_n", cand_n, (c, h, w, 3), f32),
              ("cost", cost, (h, w), f32),
              ("ref_image", problem.ref_image, (h, w), f32),
              ("src_images", problem.src_images, (s, h, w), f32),
              ("rays", pre.rays, (h, w, 3), f32),
              ("spatial_w", pre.spatial_w, (nwin * nwin,), f32),
              ("Kinv", pre.Kinv, (3, 3), f32), ("A", pre.A, (s, 3, 3), f32),
              ("b", pre.b, (s, 3), f32)]
    if idx is not None:
        checks.append(("idx", idx, (n,), torch.int64))
    if depth is not None:
        checks += [("depth", depth, (h, w), f32),
                   ("normal", normal, (h, w, 3), f32)]
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

    stream = torch.cuda.current_stream(dev).cuda_stream
    # the launch goes to the calling thread's current device: make it the
    # tensors' card (a shard thread on cuda:1 may have another current)
    with torch.cuda.device(dev):
        err = lib.patch_match_cost(
            problem.ref_image.data_ptr(), problem.src_images.data_ptr(),
            pre.rays.data_ptr(), pre.spatial_w.data_ptr(),
            pre.Kinv.data_ptr(), pre.A.data_ptr(), pre.b.data_ptr(),
            ptr(idx), cand_d.data_ptr(), cand_n.data_ptr(), cost.data_ptr(),
            ptr(depth), ptr(normal),
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
            f"{w}x{h} images, {c} candidates (its limits: "
            f"`patch_match_cost` in csrc/patch_match_cost.cu)")
    if err != 0:
        raise RuntimeError(f"patch_match_cost launch failed: cudaError {err}")
    with _lock:
        launches += 1
        evaluations += n * c

