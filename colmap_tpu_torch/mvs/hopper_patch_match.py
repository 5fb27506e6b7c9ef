"""PatchMatch's cost on Hopper: one fused kernel per `_set_cost` call.

`csrc/patch_match_cost.cu` computes, per pixel of a set and its candidate
plane, the warp of every window tap into every source, the bilinear sample,
the bilateral NCC, the optional geometric term and the mean of the top_k
lowest source costs in one launch; it is built with nvcc at first use and
called through ctypes. Its plain PyTorch twin is `_set_cost_reference` in
`mvs/patch_match.py`, which `_set_cost` takes for CPU tensors; CUDA tensors
come here and launch the kernel or raise. The kernel replaces no TPU kernel
(the JAX package computes the cost with XLA ops).
"""

from __future__ import annotations

import ctypes
import threading

import torch

launches = 0  # kernel launches, one per `_set_cost` call on CUDA

_INVALID_VALUE = 1  # cudaErrorInvalidValue: the C entry refused its sizes

_lib = None
# shard threads (parallel/) build and launch at once: the first build and
# the counter's read-modify-write are taken under this lock
_lock = threading.Lock()


def _library():
    global _lib
    with _lock:
        if _lib is None:
            from colmap_tpu_torch.cuda_build import load_library

            lib = load_library("patch_match_cost", ["patch_match_cost.cu"])
            fn = lib.patch_match_cost
            fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 7
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


def set_cost(problem, pre, opts, idx: torch.Tensor, depth: torch.Tensor,
             normal: torch.Tensor) -> torch.Tensor:
    """The aggregated cost [N] of the planes (depth [N], normal [N, 3]) at
    the flat reference pixels `idx` [N] (int64), by the kernel: the same
    function as `patch_match._set_cost_reference`. Every tensor lies on one
    CUDA device, float32 and contiguous; the launch goes to that device on
    the calling thread's current stream."""
    global launches
    dev = depth.device
    if dev.type != "cuda":
        raise ValueError(f"the cost kernel takes CUDA tensors, got {dev}")
    s, h, w = problem.src_images.shape
    n = idx.shape[0]
    f32 = torch.float32
    nwin = 2 * opts.window_radius // opts.window_step + 1
    geom = opts.geom_consistency and problem.src_depths is not None
    # the launch limits (sizes, window, top_k) are the C entry's alone
    checks = [("idx", idx, (n,), torch.int64), ("depth", depth, (n,), f32),
              ("normal", normal, (n, 3), f32),
              ("ref_image", problem.ref_image, (h, w), f32),
              ("src_images", problem.src_images, (s, h, w), f32),
              ("rays", pre.rays, (h, w, 3), f32),
              ("spatial_w", pre.spatial_w, (nwin * nwin,), f32),
              ("Kinv", pre.Kinv, (3, 3), f32), ("A", pre.A, (s, 3, 3), f32),
              ("b", pre.b, (s, 3), f32)]
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
    out = torch.empty(n, dtype=f32, device=dev)

    def ptr(t):
        return t.data_ptr() if geom else None

    stream = torch.cuda.current_stream(dev).cuda_stream
    # the launch goes to the calling thread's current device: make it the
    # tensors' card (a shard thread on cuda:1 may have another current)
    with torch.cuda.device(dev):
        err = lib.patch_match_cost(
            problem.ref_image.data_ptr(), problem.src_images.data_ptr(),
            pre.rays.data_ptr(), pre.spatial_w.data_ptr(),
            pre.Kinv.data_ptr(), pre.A.data_ptr(), pre.b.data_ptr(),
            idx.data_ptr(), depth.data_ptr(), normal.data_ptr(),
            ptr(problem.src_depths), ptr(problem.K_ref), ptr(problem.K_src),
            ptr(problem.R_rel), ptr(problem.t_rel), ptr(pre.Ksrc_inv),
            out.data_ptr(), h, w, s, n, opts.window_radius,
            opts.window_step, opts.top_k, 2 * opts.sigma_color ** 2,
            opts.geom_consistency_regularizer,
            opts.geom_consistency_max_cost, stream)
    if err == _INVALID_VALUE:
        raise ValueError(
            f"the cost kernel refused top_k {opts.top_k}, {s} sources, "
            f"window radius {opts.window_radius} step {opts.window_step}, "
            f"{w}x{h} images (its limits: `patch_match_cost` in "
            f"csrc/patch_match_cost.cu)")
    if err != 0:
        raise RuntimeError(f"patch_match_cost launch failed: cudaError {err}")
    with _lock:
        launches += 1
    return out
