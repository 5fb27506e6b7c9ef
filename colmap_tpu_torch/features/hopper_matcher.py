"""Fused descriptor matcher on Hopper: exact int8 dot products + running
top-2 (forward) + argmax (reverse, for the cross check) in one sweep.

Port of colmap_tpu/features/pallas_matcher.py. The TPU kernel
(`_matcher_kernel`, and its bf16 twin `_matcher_kernel_bf16`) becomes the
CUDA kernel `csrc/matcher_top2.cu`, built with nvcc at first use and called
through ctypes. `top2_fwd_rev` is its wrapper: on a CUDA tensor it launches
the kernel (or raises), on a CPU tensor it runs the plain PyTorch twin
`_top2_fwd_rev_reference`. `match_pairs_batch_fused` is the counterpart of
`match_pairs_batch_pallas`, with the same epilogue.

The similarity uses the TPU kernel's operation order in both the kernel and
the twin, (dots + 128*rs1 + 128*rs2 - 128^3) * (inv1*inv2), so the two agree
bit for bit; masked entries are -3e38 and every argmax takes the lowest
index on ties.
"""

from __future__ import annotations

import ctypes

import torch

from colmap_tpu_torch.features.matching import DescriptorBlock, MatchingOptions

_NEG = -3.0e38
TILE = 64  # the kernel's query/target tile; N and M must be multiples of it

# The reverse pass writes an (N/64, M) partial (best, index) buffer per pair;
# the wrapper splits the pair axis into chunks whose scratch stays below this
# many bytes (190 pairs at 8192^2 would need 1.6 GB in one launch).
SCRATCH_BYTES = 1 << 30
MAX_GRID_Y = 65535  # pairs per launch: the pair axis is the grid's y axis

launches = 0  # kernel launches (one per pair chunk), read by chip_smoke.py

_lib = None


def _library():
    global _lib
    if _lib is None:
        from colmap_tpu_torch.cuda_build import load_library

        lib = load_library("matcher_top2", ["matcher_top2.cu"])
        fn = lib.matcher_top2_fwd_rev
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 8)
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def build() -> None:
    """Compile (or load the cached build of) the matcher kernel."""
    _library()


def _check_block(b: DescriptorBlock, name: str):
    c = b.centered
    if c.dim() != 3 or c.shape[-1] != 128 or c.dtype != torch.int8:
        raise ValueError(f"{name}.centered must be (B, N, 128) int8, got "
                         f"{tuple(c.shape)} {c.dtype}")
    B, n = c.shape[:2]
    if n % TILE:
        raise ValueError(f"{name}: capacity {n} is not a multiple of {TILE}")
    for field, dtype in (("row_sum", torch.float32),
                         ("inv_norm", torch.float32), ("valid", torch.bool)):
        t = getattr(b, field)
        if t.shape != (B, n) or t.dtype != dtype:
            raise ValueError(f"{name}.{field} must be ({B}, {n}) {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    for t in b:
        if not t.is_contiguous() or t.device != c.device:
            raise ValueError(f"{name}: every field must be contiguous and on "
                             f"{c.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")


def _top2_fwd_rev_kernel(b1: DescriptorBlock, b2: DescriptorBlock):
    global launches
    lib = _library()
    B, n = b1.centered.shape[:2]
    m = b2.centered.shape[1]
    dev = b1.centered.device
    f32, i32 = torch.float32, torch.int32
    best = torch.empty((B, n), dtype=f32, device=dev)
    second = torch.empty((B, n), dtype=f32, device=dev)
    idx = torch.empty((B, n), dtype=i32, device=dev)
    rbest = torch.empty((B, m), dtype=f32, device=dev)
    ridx = torch.empty((B, m), dtype=i32, device=dev)
    per_pair = (n // TILE) * m * 8
    chunk = max(1, min(B, MAX_GRID_Y, SCRATCH_BYTES // per_pair))
    pbest = torch.empty((chunk, n // TILE, m), dtype=f32, device=dev)
    pidx = torch.empty((chunk, n // TILE, m), dtype=i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for s in range(0, B, chunk):
        e = min(B, s + chunk)

        def p(t):
            return t[s:e].data_ptr()

        err = lib.matcher_top2_fwd_rev(
            p(b1.centered), p(b2.centered), p(b1.row_sum), p(b1.inv_norm),
            p(b1.valid), p(b2.row_sum), p(b2.inv_norm), p(b2.valid),
            e - s, n, m, p(best), p(second), p(idx), pbest.data_ptr(),
            pidx.data_ptr(), p(rbest), p(ridx), stream)
        if err != 0:
            raise RuntimeError(f"matcher_top2 launch failed: cudaError {err}")
        launches += 1
    return best, second, idx, rbest, ridx


def _top2_fwd_rev_reference(b1: DescriptorBlock, b2: DescriptorBlock,
                            max_elems: int = 1 << 27):
    """Plain PyTorch twin of the kernel. Materializes (chunk, N, M)
    similarities, so the pair axis is split to keep each chunk below
    `max_elems` similarities."""
    B, n = b1.centered.shape[:2]
    m = b2.centered.shape[1]
    dev = b1.centered.device
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    chunk = max(1, min(B, max_elems // max(1, n * m)))
    outs = []
    cols = torch.arange(m, device=dev)
    for s in range(0, B, chunk):
        e = min(B, s + chunk)
        # f32 product of centered values: exact, every partial sum < 2^24
        dots = torch.matmul(b1.centered[s:e].to(torch.float32),
                            b2.centered[s:e].to(torch.float32).transpose(1, 2))
        sims = (dots + 128.0 * b1.row_sum[s:e, :, None]
                + 128.0 * b2.row_sum[s:e, None, :] - 128.0 ** 3)
        sims = sims * (b1.inv_norm[s:e, :, None] * b2.inv_norm[s:e, None, :])
        fs = torch.where(b2.valid[s:e, None, :], sims, neg)
        best = fs.amax(-1)
        idx = torch.argmax(fs, dim=-1)
        second = torch.where(cols == idx[..., None], neg, fs).amax(-1)
        del fs
        rs = torch.where(b1.valid[s:e, :, None], sims, neg)
        outs.append((best, second, idx.to(torch.int32), rs.amax(-2),
                     torch.argmax(rs, dim=-2).to(torch.int32)))
        del rs, sims, dots
    return tuple(torch.cat(parts) for parts in zip(*outs))


def top2_fwd_rev(b1: DescriptorBlock, b2: DescriptorBlock):
    """One-sweep forward top-2 + reverse argmax for a batch of pairs.

    b1/b2: centered (B, N, 128) int8, row_sum / inv_norm (B, N) f32, valid
    (B, N) bool, contiguous, N and M multiples of 64. Returns (best, second,
    idx) each (B, N) and (rev_best, rev_idx) each (B, M). CUDA tensors go
    through the kernel, CPU tensors through the plain twin.
    """
    _check_block(b1, "b1")
    _check_block(b2, "b2")
    if b1.centered.shape[0] != b2.centered.shape[0]:
        raise ValueError("b1 and b2 must hold the same number of pairs")
    if b1.centered.device != b2.centered.device:
        raise ValueError("b1 and b2 must be on one device")
    if b1.centered.is_cuda:
        return _top2_fwd_rev_kernel(b1, b2)
    if b1.centered.device.type != "cpu":
        raise ValueError(f"no matcher for device {b1.centered.device}")
    return _top2_fwd_rev_reference(b1, b2)


def select_from_top2(best, second, idx, rbest, ridx, valid1,
                     options: MatchingOptions) -> torch.Tensor:
    """The matcher's epilogue: distance gate, ratio test and cross check.
    Returns (B, N) int32 match indices (-1 = none)."""
    best_dist = torch.arccos(torch.clamp(best, -1.0, 1.0))
    second_dist = torch.arccos(torch.clamp(second, -1.0, 1.0))
    ok = best > -1e20
    ok &= best_dist <= options.max_distance
    ok &= best_dist < options.max_ratio * second_dist
    idx = idx.to(torch.int64)
    if options.cross_check:
        n = best.shape[1]
        rev = torch.where(rbest > -1e20, ridx.to(torch.int64),
                          torch.full_like(ridx, -1, dtype=torch.int64))
        rev_at_best = torch.gather(rev, 1, torch.clamp(idx, min=0))
        ok &= rev_at_best == torch.arange(n, device=best.device)[None, :]
    return torch.where(ok & valid1, idx,
                       torch.full_like(idx, -1)).to(torch.int32)


def match_pairs_batch_fused(b1: DescriptorBlock, b2: DescriptorBlock,
                            options: MatchingOptions = MatchingOptions()
                            ) -> torch.Tensor:
    """Pair-batched matcher through the fused kernel (twin on the CPU).
    Returns (B, N) int32 match indices into b2 (-1 = none)."""
    best, second, idx, rbest, ridx = top2_fwd_rev(b1, b2)
    return select_from_top2(best, second, idx, rbest, ridx, b1.valid,
                            options)
