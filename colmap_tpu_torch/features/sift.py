"""SIFT feature extraction in PyTorch.

Port of colmap_tpu/features/sift.py, default path: window sampling, L1_ROOT
descriptors, first_octave=-1. The stages are the JAX ones, written as eager
torch ops on one image at a time:

- Gaussian scale space: separable blurs as banded matrix products (strip-
  blocked on long axes), computed level to level like VLFeat;
- DoG extrema: one 3x3x3 max / min pool over the stacked DoG volume;
- fixed-capacity candidate selection with top-k over the response map;
- bulk Newton refinement of all candidates on gathered 3x3x3 neighborhoods;
- orientation and descriptor histograms from fixed sample grids. Where the
  JAX package samples gradients through per-keypoint windows and separable
  interpolation-weight matrices (an MXU formulation), the port gathers the
  same two window taps per axis and combines them with the same weights;
  samples outside the window contribute zero in both.

The banded blurs and the histogram contractions are plain XLA in the JAX
package (no Pallas kernel) and stay torch ops here. Affine shape estimation
and domain-size pooling raise NotImplementedError (ROADMAP queue 1 item 2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SiftExtractionOptions:
    """Mirrors colmap_tpu's SiftExtractionOptions (reference sift.h:37-113)."""

    max_image_size: int = 3200
    max_num_features: int = 8192
    first_octave: int = -1
    num_octaves: int = 4
    octave_resolution: int = 3
    peak_threshold: float = 0.02 / 3.0
    edge_threshold: float = 10.0
    max_num_orientations: int = 2
    normalization: str = "L1_ROOT"  # or "L2"
    # not ported: setting either raises in check()
    estimate_affine_shape: bool = False
    domain_size_pooling: bool = False
    octave_capacity: int = 4096
    sampling: str = "window"  # "window" or "gather"
    batch_size: int = 4

    def check(self):
        assert self.octave_resolution >= 1
        assert self.max_num_orientations in (1, 2)
        assert self.normalization in ("L1_ROOT", "L2")
        assert self.sampling in ("window", "gather")
        if self.estimate_affine_shape or self.domain_size_pooling:
            raise NotImplementedError(
                "SIFT affine shape / domain-size pooling: ROADMAP queue 1 "
                "item 2")


# --------------------------------------------------------------------------
# Gaussian scale space
# --------------------------------------------------------------------------

_SIGMA0 = 1.6
_SIGMA_N = 0.5


def _band_matrix(n: int, sigma: float, device) -> torch.Tensor:
    """Row-normalized Gaussian band matrix [n, n]."""
    i = torch.arange(n, dtype=_F32, device=device)
    B = torch.exp(-0.5 * ((i[:, None] - i[None, :]) / sigma) ** 2)
    return B / B.sum(1, keepdim=True)


def _blur_axis0_blocked(img: torch.Tensor, sigma: float, tile: int = 512
                        ) -> torch.Tensor:
    """Gaussian blur along axis 0 as overlapping strips of `tile` rows, each
    one (tile, tile+2r) matrix product; edge padding stands in for the
    border renormalization of the dense band matrix."""
    h, w = img.shape
    r = max(1, int(math.ceil(4.0 * sigma)))
    hp_rows = ((h + tile - 1) // tile) * tile
    padded = F.pad(img[None, None], (0, 0, r, r + (hp_rows - h)),
                   mode="replicate")[0, 0]
    n = hp_rows // tile
    idx = ((np.arange(n) * tile)[:, None]
           + np.arange(tile + 2 * r)[None, :])
    strips = padded[torch.as_tensor(idx, device=img.device)]
    i = np.arange(tile)[:, None]
    j = np.arange(tile + 2 * r)[None, :]
    B = np.exp(-0.5 * (((i + r) - j) / sigma) ** 2)
    B = (B / B.sum(1, keepdims=True)).astype(np.float32)
    out = torch.matmul(torch.as_tensor(B, device=img.device), strips)
    return out.reshape(hp_rows, w)[:h]


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of a [H, W] image as matrix products."""
    if sigma < 1e-6:
        return img
    h, w = img.shape
    r = max(1, int(math.ceil(4.0 * sigma)))
    tile = 512
    if h > 2 * tile and tile >= 4 * r:
        img = _blur_axis0_blocked(img, sigma, tile)
    else:
        img = torch.matmul(_band_matrix(h, sigma, img.device), img)
    if w > 2 * tile and tile >= 4 * r:
        img = _blur_axis0_blocked(img.T, sigma, tile).T
    else:
        img = torch.matmul(img, _band_matrix(w, sigma, img.device).T)
    return img


def _resize_weights(m: int, n: int) -> np.ndarray:
    """(m, n) triangle-kernel resampling weights, the weight matrix of
    jax.image.resize(method="bilinear", antialias=True) for one axis."""
    scale = np.float32(n / m)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(m, dtype=np.float32)[:, None])
         / kernel_scale)
    wts = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = wts.sum(0, keepdims=True)
    wts = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                   wts / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], wts, 0).astype(np.float32)


def _resize_bilinear(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """Antialiased bilinear resize of [H, W] (jax.image.resize semantics)."""
    h, w = img.shape
    if nh != h:
        img = torch.matmul(torch.as_tensor(_resize_weights(h, nh),
                                           device=img.device).T, img)
    if nw != w:
        img = torch.matmul(img, torch.as_tensor(_resize_weights(w, nw),
                                                device=img.device))
    return img


def _upsample2(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    return _resize_bilinear(img, 2 * h, 2 * w)


def _num_octaves(h: int, w: int, first_octave: int, max_octaves: int) -> int:
    base = min(h, w) * (2 ** (-first_octave))
    n = 0
    while base >= 32 and n < max_octaves:
        base //= 2
        n += 1
    return max(n, 1)


def _build_octave(base: torch.Tensor, S: int) -> torch.Tensor:
    """Incremental blurs: [S+3, H, W] levels; level s at sigma0*2^(s/S)."""
    levels = [base]
    for s in range(1, S + 3):
        prev_sigma = _SIGMA0 * (2.0 ** ((s - 1) / S))
        cur_sigma = _SIGMA0 * (2.0 ** (s / S))
        inc = math.sqrt(max(cur_sigma ** 2 - prev_sigma ** 2, 1e-8))
        levels.append(_blur(levels[-1], inc))
    return torch.stack(levels)


# --------------------------------------------------------------------------
# Extrema detection + bulk refinement
# --------------------------------------------------------------------------


def _detect_candidates(dog: torch.Tensor, peak_threshold: float, cap: int):
    """Up to `cap` DoG extrema of [S+2, H, W]; returns (s, y, x, valid)."""
    ns, h, w = dog.shape
    v = dog[None, None]
    mx = F.max_pool3d(v, 3, stride=1)[0, 0]
    mn = -F.max_pool3d(-v, 3, stride=1)[0, 0]
    c = dog[1:-1, 1:-1, 1:-1]
    thr = 0.8 * peak_threshold
    is_ext = ((c >= mx) & (c > thr)) | ((c <= mn) & (c < -thr))
    resp = torch.where(is_ext, torch.abs(c), torch.zeros_like(c))
    flat = resp.reshape(-1)
    k = min(cap, flat.shape[0])
    vals, idx = torch.topk(flat, k)
    hw = (h - 2) * (w - 2)
    s = idx // hw + 1
    rem = idx % hw
    y = rem // (w - 2) + 1
    x = rem % (w - 2) + 1
    return s, y, x, vals > 0.0


# 27 neighbor offsets, index = (ds+1)*9 + (dy+1)*3 + (dx+1)
_OFFS = np.array([(ds, dy, dx)
                  for ds in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                 np.int64)


def _solve3x3_sym(a, b, c, d, e, f, g0, g1, g2):
    """Solve H x = -g for symmetric H = [[a,b,c],[b,d,e],[c,e,f]] (bulk)."""
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = torch.where(torch.abs(det) > 1e-16, 1.0 / det,
                          torch.zeros_like(det))
    x0 = -(co00 * g0 + co01 * g1 + co02 * g2) * inv_det
    x1 = -(co01 * g0 + co11 * g1 + co12 * g2) * inv_det
    x2 = -(co02 * g0 + co12 * g1 + co22 * g2) * inv_det
    return x0, x1, x2


def _step(o):
    return torch.where(o > 0.6, 1, torch.where(o < -0.6, -1, 0))


def _refine_bulk(dog: torch.Tensor, s, y, x, peak_threshold: float,
                 edge_threshold: float):
    """Batched Newton refinement of extrema with 3 static re-centering steps
    on gathered [K, 27] neighborhoods (VLFeat's keypoint refinement)."""
    ns, h, w = dog.shape
    flat = dog.reshape(-1)
    doffs = torch.as_tensor(_OFFS[:, 0] * h * w + _OFFS[:, 1] * w
                            + _OFFS[:, 2], device=dog.device)

    def P(p, ds, dy, dx):
        return p[:, (ds + 1) * 9 + (dy + 1) * 3 + (dx + 1)]

    off_s = off_y = off_x = val = edge_ok = None
    for _ in range(3):
        center = (s * h + y) * w + x
        p = flat[center[:, None] + doffs[None, :]]  # [K, 27]
        c = P(p, 0, 0, 0)
        gs = 0.5 * (P(p, 1, 0, 0) - P(p, -1, 0, 0))
        gy = 0.5 * (P(p, 0, 1, 0) - P(p, 0, -1, 0))
        gx = 0.5 * (P(p, 0, 0, 1) - P(p, 0, 0, -1))
        hss = P(p, 1, 0, 0) + P(p, -1, 0, 0) - 2 * c
        hyy = P(p, 0, 1, 0) + P(p, 0, -1, 0) - 2 * c
        hxx = P(p, 0, 0, 1) + P(p, 0, 0, -1) - 2 * c
        hsy = 0.25 * (P(p, 1, 1, 0) - P(p, 1, -1, 0) - P(p, -1, 1, 0)
                      + P(p, -1, -1, 0))
        hsx = 0.25 * (P(p, 1, 0, 1) - P(p, 1, 0, -1) - P(p, -1, 0, 1)
                      + P(p, -1, 0, -1))
        hyx = 0.25 * (P(p, 0, 1, 1) - P(p, 0, 1, -1) - P(p, 0, -1, 1)
                      + P(p, 0, -1, -1))
        os_, oy_, ox_ = _solve3x3_sym(hss, hsy, hsx, hyy, hyx, hxx,
                                      gs, gy, gx)
        os_ = torch.clamp(os_, -1.5, 1.5)
        oy_ = torch.clamp(oy_, -1.5, 1.5)
        ox_ = torch.clamp(ox_, -1.5, 1.5)
        val = c + 0.5 * (gs * os_ + gy * oy_ + gx * ox_)
        tr = hxx + hyy
        det2 = hxx * hyy - hyx * hyx
        r = edge_threshold
        edge_ok = (det2 > 0) & (tr * tr * r < (r + 1) ** 2 * det2)
        off_s, off_y, off_x = os_, oy_, ox_
        y = torch.clamp(y + _step(oy_), 1, h - 2)
        x = torch.clamp(x + _step(ox_), 1, w - 2)

    ok = (torch.abs(val) >= peak_threshold) & edge_ok
    max_off = torch.maximum(torch.abs(off_s),
                            torch.maximum(torch.abs(off_y), torch.abs(off_x)))
    ok &= max_off <= 1.5
    fs = s.to(_F32) + off_s
    fy = y.to(_F32) + off_y
    fx = x.to(_F32) + off_x
    ok &= (fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h - 1)
    return fs, fy, fx, torch.abs(val), ok


# --------------------------------------------------------------------------
# Gradients + sampling from a level volume
# --------------------------------------------------------------------------


def _gradients(gauss: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients of [S, H, W] Gaussian levels."""
    gy = torch.zeros_like(gauss)
    gx = torch.zeros_like(gauss)
    gy[:, 1:-1, :] = 0.5 * (gauss[:, 2:, :] - gauss[:, :-2, :])
    gx[:, :, 1:-1] = 0.5 * (gauss[:, :, 2:] - gauss[:, :, :-2])
    return gx, gy


def _bilinear_vol2(grad_flat: torch.Tensor, h: int, w: int,
                   base: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Bilinear sample of a packed-gradient [L*H*W, 2] array at [K, P]
    coords (base: [K] flat level offsets). Taps outside the image count
    zero. Returns (gx, gy) [K, P]."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = ys - y0
    fx = xs - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)

    def tap(yi, xi, wgt):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (base[:, None] + torch.clamp(yi, 0, h - 1) * w
               + torch.clamp(xi, 0, w - 1))
        v = grad_flat[idx]  # [K, P, 2]
        return torch.where(inb, wgt, torch.zeros_like(wgt))[..., None] * v

    out = (tap(y0i, x0i, (1 - fy) * (1 - fx))
           + tap(y0i, x0i + 1, (1 - fy) * fx)
           + tap(y0i + 1, x0i, fy * (1 - fx))
           + tap(y0i + 1, x0i + 1, fy * fx))
    return out[..., 0], out[..., 1]


def _nearest_vol2(grad_flat: torch.Tensor, h: int, w: int,
                  base: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Nearest-neighbor packed-gradient sample (orientation histograms)."""
    yi = torch.round(ys).to(torch.int64)
    xi = torch.round(xs).to(torch.int64)
    inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    idx = (base[:, None] + torch.clamp(yi, 0, h - 1) * w
           + torch.clamp(xi, 0, w - 1))
    v = grad_flat[idx] * inb[..., None]
    return v[..., 0], v[..., 1]


_WIN_H = 96
_WIN_W = 128


def _win_eligible(h: int, w: int) -> bool:
    return h >= _WIN_H and w >= _WIN_W


def _window_vol2(grad_vol: torch.Tensor, lvl: torch.Tensor, fy: torch.Tensor,
                 fx: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                 nearest: bool = False):
    """Sample (gx, gy) [K, P] from [L, H, W, 2] gradients through a
    (96, 128) window per keypoint, placed around (fy, fx) and clipped into
    the image. Bilinear: the two taps per axis with weights
    max(0, 1 - |r - row|), summed rows first as in the JAX window matmuls.
    Nearest: the first window row/column within 0.5. Taps outside the
    window contribute zero."""
    L, h, w, _ = grad_vol.shape
    oy = torch.clamp(torch.round(fy).to(torch.int64) - _WIN_H // 2, 0,
                     h - _WIN_H)
    ox = torch.clamp(torch.round(fx).to(torch.int64) - _WIN_W // 2, 0,
                     w - _WIN_W)
    ry = ys - oy[:, None].to(ys.dtype)  # window-relative coords
    rx = xs - ox[:, None].to(xs.dtype)
    flat = grad_vol.reshape(-1, 2)
    base = lvl[:, None] * (h * w) + oy[:, None] * w + ox[:, None]  # [K, 1]

    def fetch(r, c):  # r, c window-relative int64 [K, P], in the window
        return flat[base + torch.clamp(r, 0, _WIN_H - 1) * w
                    + torch.clamp(c, 0, _WIN_W - 1)]

    if nearest:
        r = torch.ceil(ry - 0.5).to(torch.int64)
        c = torch.ceil(rx - 0.5).to(torch.int64)
        inw = (r >= 0) & (r < _WIN_H) & (c >= 0) & (c < _WIN_W)
        v = fetch(r, c) * inw[..., None]
        return v[..., 0], v[..., 1]

    r0 = torch.floor(ry)
    c0 = torch.floor(rx)

    def wgt(rel, k, size):
        ok = (k >= 0) & (k < size)
        wv = torch.clamp(1.0 - torch.abs(rel - k), min=0.0)
        return torch.where(ok, wv, torch.zeros_like(wv))

    wy0, wy1 = wgt(ry, r0, _WIN_H), wgt(ry, r0 + 1, _WIN_H)
    wx0, wx1 = wgt(rx, c0, _WIN_W), wgt(rx, c0 + 1, _WIN_W)
    r0i, c0i = r0.to(torch.int64), c0.to(torch.int64)
    a0 = (wy0[..., None] * fetch(r0i, c0i)
          + wy1[..., None] * fetch(r0i + 1, c0i))
    a1 = (wy0[..., None] * fetch(r0i, c0i + 1)
          + wy1[..., None] * fetch(r0i + 1, c0i + 1))
    out = wx0[..., None] * a0 + wx1[..., None] * a1
    return out[..., 0], out[..., 1]


# --------------------------------------------------------------------------
# Orientation histograms (bulk)
# --------------------------------------------------------------------------

_NUM_ORI_BINS = 36
_ORI_GRID = 16


def _orientations_bulk(grad_flat, h, w, base, fy, fx, sigma, max_num: int,
                       grad_vol=None, lvl=None):
    """Dominant orientations of all keypoints: [K] inputs -> theta, valid
    [K, max_num]. 36-bin Gaussian-weighted histogram over the 3*1.5*sigma
    window, circular box smoothing x6, parabolic peak interpolation."""
    dev = fy.device
    g = _ORI_GRID
    lin = (np.arange(g, dtype=np.float32) + 0.5) / g * 2.0 - 1.0
    uy, ux = np.meshgrid(lin, lin, indexing="ij")
    unit = np.stack([uy.reshape(-1), ux.reshape(-1)])  # [2, P]
    r2u = torch.as_tensor(unit[0] ** 2 + unit[1] ** 2, device=dev)
    unit = torch.as_tensor(unit, device=dev)

    wsig = 1.5 * sigma
    wrad = 3.0 * wsig
    ys = fy[:, None] + unit[0][None, :] * wrad[:, None]
    xs = fx[:, None] + unit[1][None, :] * wrad[:, None]
    if grad_vol is not None and _win_eligible(h, w):
        sgx, sgy = _window_vol2(grad_vol, lvl, fy, fx, ys, xs, nearest=True)
    else:
        sgx, sgy = _nearest_vol2(grad_flat, h, w, base, ys, xs)
    mag = torch.sqrt(sgx * sgx + sgy * sgy)
    ang = torch.atan2(sgy, sgx)
    r2 = r2u[None, :] * (wrad * wrad)[:, None]
    wgt = torch.exp(-r2 / (2.0 * (wsig * wsig)[:, None])) * mag
    wgt = torch.where(r2u[None, :] <= 1.0, wgt, torch.zeros_like(wgt))

    nb = _NUM_ORI_BINS
    b = (ang + math.pi) / (2 * math.pi) * nb
    b0 = torch.floor(b - 0.5)
    f = b - 0.5 - b0
    i0 = torch.remainder(b0.to(torch.int64), nb)
    i1 = torch.remainder(i0 + 1, nb)
    hist = torch.zeros(fy.shape[0], nb, dtype=_F32, device=dev)
    hist = hist.scatter_add(1, i0, wgt * (1 - f)).scatter_add(1, i1, wgt * f)

    for _ in range(6):
        hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0

    hp = torch.roll(hist, 1, 1)
    hn = torch.roll(hist, -1, 1)
    is_peak = ((hist > hp) & (hist > hn)
               & (hist >= 0.8 * hist.amax(1, keepdim=True)))
    peak_val = torch.where(is_peak, hist, torch.full_like(hist, -1.0))
    vals, idx = torch.topk(peak_val, max_num, dim=1)
    hpi = torch.gather(hp, 1, idx)
    hni = torch.gather(hn, 1, idx)
    denom = hpi - 2 * vals + hni
    di = torch.where(torch.abs(denom) > 1e-12, 0.5 * (hpi - hni) / denom,
                     torch.zeros_like(denom))
    theta = (idx.to(_F32) + di + 0.5) / nb * 2 * math.pi - math.pi
    return theta, vals > 0.0


# --------------------------------------------------------------------------
# Descriptors (bulk)
# --------------------------------------------------------------------------

_NBP = 4
_NBO = 8
_DESC_GRID = 16
_MAGNIF = 3.0


def _axis_weights(coord: np.ndarray) -> np.ndarray:
    b0 = np.floor(coord)
    f = coord - b0
    b0i = b0.astype(np.int32)
    wm = np.zeros((coord.shape[0], _NBP), np.float32)
    for i, (bi, fi) in enumerate(zip(b0i, f)):
        if 0 <= bi < _NBP:
            wm[i, bi] = 1.0 - fi
        if 0 <= bi + 1 < _NBP:
            wm[i, bi + 1] = fi
    return wm


def _descriptor_grid():
    q = _DESC_GRID
    half = _NBP / 2.0
    lin = (np.arange(q, dtype=np.float32) + 0.5) / q * _NBP - half
    vv, uu = np.meshgrid(lin, lin, indexing="ij")
    u, v = uu.reshape(-1), vv.reshape(-1)
    win = np.exp(-(u ** 2 + v ** 2) / (2.0 * half * half))
    wy = _axis_weights(v + half - 0.5)
    wx = _axis_weights(u + half - 0.5)
    wyx = np.einsum("py,px->pyx", wy, wx).reshape(u.shape[0], _NBP * _NBP)
    return u, v, win, wyx


_GRID = _descriptor_grid()


def _descriptors_bulk(grad_flat, h, w, base, fy, fx, sigma, theta,
                      grad_vol=None, lvl=None):
    """128-D SIFT descriptors of all oriented keypoints ([K] inputs): a
    4x4x8 trilinear histogram over a 3-sigma-per-bin window, Gaussian
    weighted, rotated to the keypoint frame."""
    dev = fy.device
    u_np, v_np, win_np, wyx_np = _GRID
    u = torch.as_tensor(u_np, device=dev)
    v = torch.as_tensor(v_np, device=dev)

    sbp = _MAGNIF * sigma
    ct, st = torch.cos(theta), torch.sin(theta)
    ox = sbp[:, None] * (ct[:, None] * u[None, :] - st[:, None] * v[None, :])
    oy = sbp[:, None] * (st[:, None] * u[None, :] + ct[:, None] * v[None, :])
    ys = fy[:, None] + oy
    xs = fx[:, None] + ox
    if grad_vol is not None and _win_eligible(h, w):
        sgx, sgy = _window_vol2(grad_vol, lvl, fy, fx, ys, xs)
    else:
        sgx, sgy = _bilinear_vol2(grad_flat, h, w, base, ys, xs)
    mag = torch.sqrt(sgx * sgx + sgy * sgy)
    ang = torch.atan2(sgy, sgx) - theta[:, None]
    ang = torch.remainder(ang + 4 * math.pi, 2 * math.pi)

    wgt = mag * torch.as_tensor(win_np, dtype=_F32, device=dev)[None, :]
    ob = ang / (2 * math.pi) * _NBO
    ob0 = torch.floor(ob)
    of = ob - ob0
    o0 = torch.remainder(ob0.to(torch.int64), _NBO)
    o1 = torch.remainder(o0 + 1, _NBO)
    wo = (F.one_hot(o0, _NBO).to(_F32) * (1 - of)[..., None]
          + F.one_hot(o1, _NBO).to(_F32) * of[..., None])  # [K, P, 8]
    t = wgt[:, :, None] * wo
    wyx = torch.as_tensor(wyx_np, device=dev)
    desc = torch.einsum("pq,kpo->kqo", wyx, t)  # [K, 16, 8]
    return desc.reshape(-1, _NBP * _NBP * _NBO)


def _normalize_desc(desc: torch.Tensor, normalization: str) -> torch.Tensor:
    if normalization == "L1_ROOT":
        d = desc / torch.clamp(desc.sum(1, keepdim=True), min=1e-12)
        return torch.sqrt(d)
    d = desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True),
                           min=1e-12)
    d = torch.clamp(d, max=0.2)
    return d / torch.clamp(torch.linalg.norm(d, dim=1, keepdim=True),
                           min=1e-12)


# --------------------------------------------------------------------------
# Full pipeline
# --------------------------------------------------------------------------


def _extract_octave(gauss: torch.Tensor, octave_scale: float,
                    opts: SiftExtractionOptions, coord_offset: float = 0.0,
                    cap: int = 0):
    """Detection + description on one octave [S+3, H, W]; fixed-capacity
    outputs in original-image coords (orig = octave_scale*x + offset)."""
    S = opts.octave_resolution
    ns, h, w = gauss.shape
    dog = gauss[1:] - gauss[:-1]
    cap = cap or opts.octave_capacity

    s, y, x, cand_valid = _detect_candidates(dog, opts.peak_threshold, cap)
    fs, fy, fx, resp, ok = _refine_bulk(dog, s, y, x, opts.peak_threshold,
                                        opts.edge_threshold)
    ok &= cand_valid

    # compact survivors before the orientation/descriptor stages
    keep = max(1024, cap // 2)
    if keep < fs.shape[0]:
        score = torch.where(ok, resp, torch.full_like(resp, -1.0))
        sel = torch.topk(score, keep).indices
        fs, fy, fx, resp, ok = fs[sel], fy[sel], fx[sel], resp[sel], ok[sel]

    sigma_oct = _SIGMA0 * torch.exp2(fs / S)
    gx, gy = _gradients(gauss)
    grad_flat = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    lvl = torch.clamp(torch.round(fs).to(torch.int64), 0, S + 2)
    lvl_base = lvl * (h * w)
    grad_vol = (torch.stack([gx, gy], dim=-1) if opts.sampling == "window"
                else None)

    max_ori = opts.max_num_orientations
    theta, tvalid = _orientations_bulk(grad_flat, h, w, lvl_base, fy, fx,
                                       sigma_oct, max_ori, grad_vol=grad_vol,
                                       lvl=lvl)

    k = fs.shape[0]
    n = k * max_ori

    def rep(a):
        return a[:, None].expand(k, max_ori).reshape(n)

    kp_fy, kp_fx, kp_sigma = rep(fy), rep(fx), rep(sigma_oct)
    kp_theta = theta.reshape(n)
    kp_valid = (tvalid & ok[:, None]).reshape(n)
    kp_desc = _descriptors_bulk(grad_flat, h, w, rep(lvl_base), kp_fy, kp_fx,
                                kp_sigma, kp_theta, grad_vol=grad_vol,
                                lvl=rep(lvl))
    return (kp_fx * octave_scale + coord_offset,
            kp_fy * octave_scale + coord_offset,
            kp_sigma * octave_scale, kp_theta, rep(resp), kp_valid, kp_desc)


def _extract_static(image: torch.Tensor, opts: SiftExtractionOptions
                    ) -> Dict[str, torch.Tensor]:
    """Core extractor on a [H, W] f32 image in [0, 1]; fixed-capacity
    outputs (max_num_features rows with a valid mask)."""
    h, w = image.shape
    S = opts.octave_resolution
    n_oct = _num_octaves(h, w, opts.first_octave, opts.num_octaves)
    if opts.first_octave < 0:
        base = _upsample2(image)
        cur_sigma = 2.0 * _SIGMA_N
        octave_scale = 0.5
        coord_offset = -0.25  # upsampled pixel i -> i/2 - 0.25 in original
    else:
        base = image
        cur_sigma = _SIGMA_N
        octave_scale = 1.0
        coord_offset = 0.0
    base = _blur(base, math.sqrt(max(_SIGMA0 ** 2 - cur_sigma ** 2, 1e-8)))

    outs = []
    for o in range(n_oct):
        gauss = _build_octave(base, S)
        cap_o = max(512, opts.octave_capacity >> (2 * o))
        outs.append(_extract_octave(gauss, octave_scale, opts, coord_offset,
                                    cap=cap_o))
        if o + 1 < n_oct:
            base = gauss[S][::2, ::2]
            octave_scale *= 2.0

    kp_x, kp_y, kp_scale, kp_theta, kp_resp, kp_valid, kp_desc = (
        torch.cat(parts) for parts in zip(*outs))
    kp_desc = _normalize_desc(kp_desc, opts.normalization)
    desc_u8 = torch.clamp(torch.round(512.0 * kp_desc), 0, 255).to(torch.uint8)

    # keep the top max_num_features by scale, response as tie-breaker
    score = torch.where(kp_valid, kp_scale * 1e3 + kp_resp,
                        torch.full_like(kp_scale, float("-inf")))
    k = min(opts.max_num_features, score.shape[0])
    idx = torch.topk(score, k).indices
    return {
        "xy": torch.stack([kp_x[idx], kp_y[idx]], dim=-1),
        "scale": kp_scale[idx],
        "orientation": kp_theta[idx],
        "response": kp_resp[idx],
        "valid": kp_valid[idx],
        "descriptors": desc_u8[idx],
    }


# --------------------------------------------------------------------------
# Host-facing API
# --------------------------------------------------------------------------


def _bucket_shape(h: int, w: int, quantum: int = 64) -> Tuple[int, int]:
    return -(-h // quantum) * quantum, -(-w // quantum) * quantum


def _to_u8_gray(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.ndim == 3:
        img = (img @ np.array([0.299, 0.587, 0.114], np.float32)
               if img.shape[-1] == 3 else img[..., 0])
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img, np.float32) * (255.0 if img.max() <= 1.0
                                                     else 1.0), 0, 255
                      ).astype(np.uint8)
    return np.ascontiguousarray(img)


def _prepare_u8(image: np.ndarray, options: SiftExtractionOptions
                ) -> Tuple[np.ndarray, float, int, int]:
    """Grayscale + downscale + pad to the (64-quantum) shape bucket."""
    img = _to_u8_gray(image)
    h, w = img.shape
    scale = 1.0
    if max(h, w) > options.max_image_size:
        scale = options.max_image_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        small = _resize_bilinear(torch.as_tensor(img, dtype=_F32), nh, nw)
        img = torch.clamp(torch.round(small), 0, 255).to(torch.uint8).numpy()
        h, w = nh, nw
    bh, bw = _bucket_shape(h, w)
    padded = np.zeros((bh, bw), np.uint8)
    padded[:h, :w] = img
    return padded, scale, h, w


def _finalize_features(feats: Dict[str, np.ndarray], scale: float,
                       h: int, w: int) -> Dict[str, np.ndarray]:
    xy = feats["xy"]
    valid = (feats["valid"] & (xy[:, 0] < w) & (xy[:, 1] < h)
             & (xy[:, 0] >= 0) & (xy[:, 1] >= 0))
    return {
        "xy": xy[valid] / scale,
        "scale": feats["scale"][valid] / scale,
        "orientation": feats["orientation"][valid],
        "response": feats["response"][valid],
        "descriptors": feats["descriptors"][valid],
    }


def extract_batch(images_u8: torch.Tensor,
                  options: SiftExtractionOptions = SiftExtractionOptions()
                  ) -> Dict[str, torch.Tensor]:
    """Batched extraction of [B, H, W] uint8 images (bucket-padded) on their
    device: a dict of fixed-capacity [B, max_num_features, ...] tensors plus
    the valid mask. Images run one after another (the JAX version vmaps)."""
    options.check()
    outs = [_extract_static(im.to(_F32) / 255.0, options) for im in images_u8]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def extract(image: np.ndarray,
            options: SiftExtractionOptions = SiftExtractionOptions(),
            device="cpu") -> Dict[str, np.ndarray]:
    """Extract SIFT features from one image (uint8/f32, gray or RGB) on
    `device`. Returns numpy arrays of the valid keypoints: xy [N,2],
    scale [N], orientation [N], response [N], descriptors uint8 [N,128]."""
    padded, scale, h, w = _prepare_u8(image, options)
    out = extract_batch(torch.as_tensor(padded, device=device)[None], options)
    feats = {k: v[0].cpu().numpy() for k, v in out.items()}
    return _finalize_features(feats, scale, h, w)


def keypoints_to_affine(xy: np.ndarray, scale: np.ndarray,
                        orientation: np.ndarray) -> np.ndarray:
    """Keypoints in the reference 6-column layout (x, y, a11, a12, a21, a22)
    with a = scale * R(theta)."""
    c = np.cos(orientation) * scale
    s = np.sin(orientation) * scale
    return np.stack([xy[:, 0], xy[:, 1], c, -s, s, c],
                    axis=-1).astype(np.float32)


def affine_to_keypoints(kp6: np.ndarray):
    """Inverse of keypoints_to_affine: returns (xy, scale, orientation)."""
    kp6 = np.asarray(kp6, np.float32)
    if kp6.shape[1] == 2:
        return (kp6, np.ones(len(kp6), np.float32),
                np.zeros(len(kp6), np.float32))
    a11, a12, a21, a22 = kp6[:, 2], kp6[:, 3], kp6[:, 4], kp6[:, 5]
    scale = np.sqrt(np.maximum((a11 * a11 + a12 * a12 + a21 * a21
                                + a22 * a22) / 2, 0))
    ori = np.arctan2(a21, a11)
    return kp6[:, :2], scale, ori
