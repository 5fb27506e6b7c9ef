"""PatchMatch multi-view stereo as torch ops.

Port of colmap_tpu/mvs/patch_match.py (reference:
src/colmap/mvs/patch_match.h:57-205, patch_match_cuda.cu). The algorithm
is the JAX module's, not the reference's sequential sweep:

- red-black checkerboard propagation: each half-iteration offers every
  pixel of one colour the planes of its 4 neighbours plus
  `num_perturbations` random perturbations of its own plane, then
  `num_refinement_iterations` passes of perturbation-only refinement over
  all pixels;
- the plane-induced warp in closed form per pixel and window tap,
  H_p q = A q + (K2 t) ((K1^-T n_p) . q) / (n_p . X_p) with A = K2 R K1^-1,
  computed elementwise (no matrix product per pixel), for all sources at
  once; the source is sampled by grid_sample (bilinear, zero outside: the
  JAX sampler's values);
- bilateral-weighted NCC from six running weighted sums over chunks of
  window rows, so peak memory is [sources, pixels, chunk] (the chunk is
  the whole 11x11 window at 640x480 with 8 sources, one to three rows
  at 2048x1536);
- the trimmed mean of the `top_k` best sources, an optional geometric
  term (forward-backward reprojection against the source depth maps) and
  the NCC filter.

On CUDA tensors the cost of a pixel set (`_set_cost`) is one launch of
the hand-written kernel csrc/patch_match_cost.cu (`hopper_patch_match`),
which computes the warp, the samples, the NCC over all sources, the
geometric term and the top-k without any [sources, pixels, taps]
temporary; the torch code here, `_set_cost_reference`, is its plain twin
and runs on CPU tensors. The per-solve constants of the cost (the warp's
A and b, K_src^-1, the taps' spatial weights) come from `_precompute`.

The JAX solver evaluates every candidate over the whole image and masks
the inactive colour. Costs are independent per pixel, so here a
propagation candidate is evaluated only on the active colour
(`active_half=True`, the default), with results equal to the masked
whole-image form (`active_half=False`, kept for that comparison).

The random draws (initial depths and normals, perturbations) come from a
`Draws` object in the JAX solver's order: `GeneratorDraws` takes them from a
`torch.Generator`, `RecordedDraws` replays given tensors (the tests fill it
from JAX's key chain).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from colmap_tpu_torch.mvs import hopper_patch_match
from colmap_tpu_torch.util.timer import span

_F32 = torch.float32
# The JAX solver sums the window taps in chunks of 8 and pads the last
# chunk with taps at offset (0, 0) and weight 0, which still count towards
# the valid-tap share (`s_n`); the port adds the same count.
_JAX_TAP_CHUNK = 8
# elements of one [sources, pixels, taps] temporary: the window rows
# evaluated at once are as many as fit this budget (at least one)
_CHUNK_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class PatchMatchOptions:
    """Mirrors PatchMatchOptions (reference: mvs/patch_match.h:57-130)."""

    window_radius: int = 5  # reference default (patch_match.h:71)
    window_step: int = 1
    sigma_color: float = 0.2
    # reference default -1 resolves to window_radius (patch_match.h:81)
    sigma_spatial: float = -1.0
    num_iterations: int = 5
    num_perturbations: int = 2
    # fine perturbation-only passes after the propagation loop
    num_refinement_iterations: int = 3
    top_k: int = 2  # trimmed-mean aggregation over sources
    geom_consistency: bool = False
    geom_consistency_regularizer: float = 0.3  # reference default
    geom_consistency_max_cost: float = 3.0  # reference default
    filter: bool = True
    filter_min_ncc: float = 0.1  # reference default


class PatchMatchProblem(NamedTuple):
    """One reference image + its sources (tensors on one device)."""

    ref_image: torch.Tensor  # [H, W] f32 in [0, 1]
    src_images: torch.Tensor  # [S, H, W]
    K_ref: torch.Tensor  # [3, 3]
    K_src: torch.Tensor  # [S, 3, 3]
    R_rel: torch.Tensor  # [S, 3, 3] src_from_ref rotation
    t_rel: torch.Tensor  # [S, 3]
    depth_min: torch.Tensor  # scalar
    depth_max: torch.Tensor  # scalar
    src_depths: Optional[torch.Tensor] = None  # [S, H, W] for geom consistency


# -- random draws ------------------------------------------------------------


class GeneratorDraws:
    """The solver's draws from a torch.Generator: uniform initial depths in
    [0, 1) and standard-normal initial normals, then per perturbation a
    uniform in [-1, 1) and a standard-normal normal offset, each of the
    image's shape, drawn on the generator's device."""

    def __init__(self, generator: torch.Generator, shape: Tuple[int, int]):
        self.generator = generator
        self.shape = tuple(shape)

    def _draw(self):
        dev = self.generator.device
        u = torch.rand(self.shape, generator=self.generator, device=dev)
        g = torch.randn(self.shape + (3,), generator=self.generator,
                        device=dev)
        return u, g

    def initial(self):
        return self._draw()

    def perturbation(self):
        u, g = self._draw()
        return u * 2 - 1, g


class RecordedDraws:
    """Replays given draws: `initial` = (uniform [H, W] in [0, 1), normal
    [H, W, 3]); `perturbations` = [(uniform [H, W] in [-1, 1), normal
    [H, W, 3]), ...] in the order the solver asks for them."""

    def __init__(self, initial, perturbations: Sequence):
        self._initial = initial
        self._perturbations = list(perturbations)
        self._next = 0

    def initial(self):
        return self._initial

    def perturbation(self):
        out = self._perturbations[self._next]
        self._next += 1
        return out


def num_perturbation_draws(options: PatchMatchOptions) -> int:
    """How many `perturbation()` draws one solve takes."""
    return 2 * (options.num_iterations * options.num_perturbations
                + options.num_refinement_iterations * 2)


# -- precomputation ------------------------------------------------------------


def _window_offsets(radius: int, step: int) -> np.ndarray:
    r = np.arange(-radius, radius + 1, step)
    oy, ox = np.meshgrid(r, r, indexing="ij")
    return np.stack([oy.reshape(-1), ox.reshape(-1)], -1).astype(np.float32)


def _bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Sample [H, W] at float coords of any shape; (value, in_bounds).
    Taps clamp to the image; a sample outside [0, H-1] x [0, W-1] reads 0."""
    h, w = img.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = ys - y0
    fx = xs - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    inb = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    flat = img.reshape(-1)
    y0c, y1c = y0i.clamp(0, h - 1) * w, (y0i + 1).clamp(0, h - 1) * w
    x0c, x1c = x0i.clamp(0, w - 1), (x0i + 1).clamp(0, w - 1)
    gy, gx = 1 - fy, 1 - fx
    v = (flat.take(y0c + x0c) * (gy * gx) + flat.take(y0c + x1c) * (gy * fx)
         + flat.take(y1c + x0c) * (fy * gx) + flat.take(y1c + x1c) * (fy * fx))
    return torch.where(inb, v, torch.zeros_like(v)), inb


class _Precomp(NamedTuple):
    rays: torch.Tensor  # [H, W, 3]
    pix: torch.Tensor  # [H, W, 2]
    ref_patch: torch.Tensor  # [H, W, P]
    bil_w: torch.Tensor  # [H, W, P]
    offs: torch.Tensor  # [P, 2] (oy, ox)
    Kinv: torch.Tensor  # [3, 3] K_ref^-1
    # the per-solve constants of the cost: the taps' spatial weights, the
    # warp's A = K_src R K_ref^-1 and b = K_src t, and K_src^-1 for the
    # geometric term
    spatial_w: torch.Tensor  # [P]
    A: torch.Tensor  # [S, 3, 3]
    b: torch.Tensor  # [S, 3]
    Ksrc_inv: torch.Tensor  # [S, 3, 3]


def _pixel_grid(h: int, w: int, device):
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return ys, xs


def _precompute(problem: PatchMatchProblem,
                opts: PatchMatchOptions) -> _Precomp:
    ref = problem.ref_image
    h, w = ref.shape
    dev = ref.device
    offsets = _window_offsets(opts.window_radius, opts.window_step)
    offs = torch.as_tensor(offsets, device=dev)
    ys, xs = _pixel_grid(h, w, dev)
    pix = torch.stack([xs.to(_F32) + 0.5, ys.to(_F32) + 0.5], -1)
    Kinv = torch.linalg.inv(problem.K_ref)
    rays = torch.stack([Kinv[c, 0] * pix[..., 0] + Kinv[c, 1] * pix[..., 1]
                        + Kinv[c, 2] for c in range(3)], -1)

    # ref patches via one gather over [H, W, P] integer coords
    oi = offs.to(torch.int64)
    py = ys[..., None] + oi[:, 0]
    px = xs[..., None] + oi[:, 1]
    inb = (py >= 0) & (py < h) & (px >= 0) & (px < w)
    idx = py.clamp(0, h - 1) * w + px.clamp(0, w - 1)
    ref_patch = torch.where(inb, ref.reshape(-1).take(idx),
                            torch.zeros((), device=dev))

    # bilateral weights (reference: PhotoConsistencyCostComputer :411)
    col = torch.exp(-(ref_patch - ref[..., None]) ** 2
                    / (2 * opts.sigma_color ** 2))
    sigma_spatial = (opts.sigma_spatial if opts.sigma_spatial > 0
                     else float(opts.window_radius))
    sp = np.exp(-(offsets[:, 0] ** 2 + offsets[:, 1] ** 2)
                / (2 * sigma_spatial ** 2)).astype(np.float32)
    spatial_w = torch.as_tensor(sp, device=dev)
    bil_w = col * spatial_w * inb
    return _Precomp(
        rays=rays, pix=pix, ref_patch=ref_patch, bil_w=bil_w, offs=offs,
        Kinv=Kinv.contiguous(), spatial_w=spatial_w,
        A=problem.K_src @ problem.R_rel @ Kinv,
        b=(problem.K_src @ problem.t_rel[..., None])[..., 0],
        Ksrc_inv=torch.linalg.inv(problem.K_src).contiguous())


class _PixelSet(NamedTuple):
    """A set of reference pixels (flat indices) with their per-pixel
    constants over the window taps: the bilateral weight w, w * r and
    w * r * r for the reference patch r."""

    idx: torch.Tensor  # [N] int64
    px: torch.Tensor  # [N]
    py: torch.Tensor  # [N]
    rays: torch.Tensor  # [N, 3]
    bw: torch.Tensor  # [N, P]
    bwr: torch.Tensor  # [N, P]
    bwrr: torch.Tensor  # [N, P]


def _pixel_set(pre: _Precomp, idx: torch.Tensor) -> _PixelSet:
    p = pre.ref_patch.shape[-1]
    pix = pre.pix.reshape(-1, 2)[idx]
    rp = pre.ref_patch.reshape(-1, p)[idx]
    bw = pre.bil_w.reshape(-1, p)[idx]
    bwr = bw * rp
    return _PixelSet(idx=idx, px=pix[:, 0], py=pix[:, 1],
                     rays=pre.rays.reshape(-1, 3)[idx], bw=bw, bwr=bwr,
                     bwrr=bwr * rp)


def _checker_sets(pre: _Precomp) -> List[_PixelSet]:
    """The two colours of the checkerboard: (y + x) even, then odd."""
    h, w = pre.pix.shape[:2]
    ys, xs = _pixel_grid(h, w, pre.pix.device)
    colour = ((ys + xs) % 2).reshape(-1)
    return [_pixel_set(pre, torch.nonzero(colour == c).reshape(-1))
            for c in (0, 1)]


# -- the cost ------------------------------------------------------------------


def _mat3(M: torch.Tensor, v: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """M @ v for 3x3 M [..., 3, 3] and v given as its 3 component tensors;
    M's leading axes broadcast against the components' leading axes."""
    return [M[..., c, 0, None] * v[0] + M[..., c, 1, None] * v[1]
            + M[..., c, 2, None] * v[2] for c in range(3)]


def _photometric_cost(problem, S: _PixelSet, A, b, m, inv_ndotX, window):
    """1 - bilateral NCC of every source [S, N] for the pixels of S; 2
    where fewer than half the taps land in the source or the reference
    patch is flat.

    Per source and pixel the warped tap is affine in the window offset:
    H q = base + ox * gx + oy * gy, with base, gx, gy per pixel. The taps
    of a window row share base + ox * gx, so a chunk of rows costs one add
    per component; the source is sampled by grid_sample (bilinear, zero
    outside, corners aligned to pixel centres: the JAX sampler's values).
    It computes in the images' dtype: float32 on the solver's path, float64
    for a witness of its rounding."""
    src = problem.src_images
    ns, h, w = src.shape
    n = S.px.shape[0]
    ny = nx = len(window)
    mi = [m[c] * inv_ndotX for c in range(3)]
    base, gx, gy = [], [], []
    for c in range(3):
        Ap = A[:, c, 0, None] * S.px + A[:, c, 1, None] * S.py \
            + A[:, c, 2, None]
        base.append(Ap + b[:, c, None] * (mi[0] * S.px + mi[1] * S.py + mi[2]))
        gx.append(A[:, c, 0, None] + b[:, c, None] * mi[0])
        gy.append(A[:, c, 1, None] + b[:, c, None] * mi[1])
    dev = src.device
    ox = oy = torch.as_tensor(window, device=dev)
    scale = torch.tensor([2.0 / max(w - 1, 1), 2.0 / max(h - 1, 1)],
                         device=dev)

    def clamp_z(z):
        return z.masked_fill_(torch.abs(z) < 1e-9, 1e-9)

    def in_source(sxy, z):
        """0 <= sx <= w - 1, 0 <= sy <= h - 1 (false for NaN) and z > 0."""
        sx, sy = sxy[..., 0], sxy[..., 1]
        return ((sx.clamp(0, w - 1) == sx) & (sy.clamp(0, h - 1) == sy)
                & (z > 0))

    # the tap at offset (0, 0): the JAX solver's padding taps read it
    z0 = clamp_z(base[2].clone())
    valid0 = in_source(torch.stack(base[:2], -1) / z0[..., None], z0)
    sums = [torch.zeros((ns, n), dtype=src.dtype, device=dev)
            for _ in range(7)]
    rows = max(1, min(ny, _CHUNK_ELEMS // max(ns * n * nx, 1)))
    # (x, y) interleaved, as grid_sample takes them: [S, N, nx, 2] per row
    row_xy = (torch.stack(base[:2], -1)[:, :, None]
              + ox[:, None] * torch.stack(gx[:2], -1)[:, :, None])
    gy_xy = torch.stack(gy[:2], -1)
    row_z = base[2][..., None] + ox * gx[2][..., None]
    for r0 in range(0, ny, rows):
        r1 = min(ny, r0 + rows)
        oy_r = oy[r0:r1, None]
        z = clamp_z((row_z[:, :, None] + oy_r * gy[2][..., None, None]
                     ).reshape(ns, n, -1))
        # the source pixels (sx, sy), then in place grid_sample's [-1, 1]
        sxy = (row_xy[:, :, None] + oy_r[..., None] * gy_xy[:, :, None, None]
               ).reshape(ns, n, -1, 2).div_(z[..., None])
        valid = in_source(sxy, z).to(src.dtype)
        v = torch.nn.functional.grid_sample(
            src[:, None], sxy.mul_(scale).sub_(1), mode="bilinear",
            padding_mode="zeros", align_corners=True)[:, 0]
        del z, sxy
        t0, t1 = r0 * nx, r1 * nx
        # the seven sums of w = bil_w * valid: w, w r, w r r, w v, w v v,
        # w r v and the valid count, in place where a product is reused
        wgt = S.bw[:, t0:t1] * valid
        wr = S.bwr[:, t0:t1] * valid
        sums[0] += wgt.sum(-1)
        sums[1] += wr.sum(-1)
        sums[6] += valid.sum(-1)
        sums[2] += torch.mul(S.bwrr[:, t0:t1], valid, out=valid).sum(-1)
        wv = wgt.mul_(v)
        sums[3] += wv.sum(-1)
        sums[4] += wv.mul_(v).sum(-1)
        sums[5] += wr.mul_(v).sum(-1)
    sw, s_r, s_rr, s_v, s_vv, s_rv, s_n = sums
    P = ny * nx
    s_n = s_n + (-P % _JAX_TAP_CHUNK) * valid0.to(src.dtype)
    sw = torch.clamp(sw, min=1e-6)
    mu_r = s_r / sw
    mu_s = s_v / sw
    var_r = s_rr / sw - mu_r * mu_r
    var_s = s_vv / sw - mu_s * mu_s
    cov = s_rv / sw - mu_r * mu_s
    ncc = cov * torch.rsqrt(torch.clamp(var_r * var_s, min=1e-10))
    cost = torch.clamp(1.0 - ncc, 0.0, 2.0)
    # s_n / P > 0.5 as 2 s_n > P: the same on the CPU (s_n and P are whole
    # numbers), exact on CUDA, where a division by a number is a product
    # with its rounded reciprocal
    return torch.where((s_n * 2 > P) & (var_r > 1e-8), cost,
                       torch.full_like(cost, 2.0))


def _geom_cost(problem, Ksrc_inv, X, px, py, opts):
    """Forward-backward reprojection error [S, N] vs the source depth maps
    (reference: LikelihoodComputer, patch_match_cuda.cu:656). X: the
    reference-camera points as 3 component tensors [N]."""
    R, t = problem.R_rel, problem.t_rel
    Xs = [c + t[:, i, None] for i, c in enumerate(_mat3(R, X))]
    ps = _mat3(problem.K_src, Xs)
    zz = torch.clamp(ps[2], min=1e-9)
    sx = ps[0] / zz
    sy = ps[1] / zz
    d_src, inb = zip(*(_bilinear(d, y, x) for d, y, x in
                       zip(problem.src_depths, sy, sx)))
    d_src, inb = torch.stack(d_src), torch.stack(inb)
    q = _mat3(Ksrc_inv, [sx, sy, torch.ones_like(sx)])
    d = [q[c] * d_src - t[:, c, None] for c in range(3)]
    # X_ref = R^T (Xs_hat - t)
    X_ref = _mat3(R.transpose(-1, -2), d)
    pr = _mat3(problem.K_ref, X_ref)
    rz = torch.clamp(pr[2], min=1e-9)
    err = torch.sqrt((pr[0] / rz - px) ** 2 + (pr[1] / rz - py) ** 2)
    max_cost = opts.geom_consistency_max_cost
    err = torch.where(inb & (d_src > 0) & (Xs[2] > 0), err,
                      torch.full_like(err, max_cost))
    return torch.clamp(err, max=max_cost)


def _window(opts: PatchMatchOptions) -> np.ndarray:
    """The window's offsets along one axis (rows and columns alike)."""
    return np.arange(-opts.window_radius, opts.window_radius + 1,
                     opts.window_step).astype(np.float32)


def _set_cost(problem: PatchMatchProblem, pre: _Precomp,
              opts: PatchMatchOptions, S: _PixelSet, depth: torch.Tensor,
              normal: torch.Tensor) -> torch.Tensor:
    """The aggregated cost [N] of the planes (depth [N], normal [N, 3]) at
    the pixels of S: per source the photometric cost (+ the weighted
    geometric term), then the mean of the top_k lowest. One span,
    `patch_match.cost`, per call. CUDA tensors go through the fused kernel
    (`hopper_patch_match`, one launch), CPU tensors through the plain twin
    `_set_cost_reference`."""
    with span("patch_match.cost"):
        if depth.is_cuda:
            return hopper_patch_match.set_cost(problem, pre, opts, S.idx,
                                               depth, normal)
        if depth.device.type != "cpu":
            raise ValueError(f"no PatchMatch cost for device {depth.device}")
        return _set_cost_reference(problem, pre, opts, S, depth, normal)


def _set_cost_reference(problem: PatchMatchProblem, pre: _Precomp,
                        opts: PatchMatchOptions, S: _PixelSet,
                        depth: torch.Tensor,
                        normal: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch twin of the cost kernel, on any device."""
    X = [depth * S.rays[:, c] for c in range(3)]
    ndotX = (normal[:, 0] * X[0] + normal[:, 1] * X[1]
             + normal[:, 2] * X[2])
    ndotX = torch.where(torch.abs(ndotX) < 1e-9,
                        torch.full_like(ndotX, 1e-9), ndotX)
    # m = K1^-T n, row vector form n @ K1^-1
    Kinv = pre.Kinv
    m = [normal[:, 0] * Kinv[0, c] + normal[:, 1] * Kinv[1, c]
         + normal[:, 2] * Kinv[2, c] for c in range(3)]
    costs = _photometric_cost(problem, S, pre.A, pre.b, m, 1.0 / ndotX,
                              _window(opts))
    if opts.geom_consistency and problem.src_depths is not None:
        costs = costs + opts.geom_consistency_regularizer * _geom_cost(
            problem, pre.Ksrc_inv, X, S.px, S.py, opts)
    k = min(opts.top_k, costs.shape[0])
    return torch.topk(costs, k, dim=0, largest=False).values.mean(0)


def _cost_fn(problem: PatchMatchProblem, pre: _Precomp,
             opts: PatchMatchOptions):
    """Returns cost(depth [H, W], normal [H, W, 3]) -> [H, W], evaluated
    colour by colour."""
    sets = _checker_sets(pre)

    def cost(depth, normal):
        out = torch.empty(depth.numel(), dtype=_F32, device=depth.device)
        for S in sets:
            out[S.idx] = _set_cost(problem, pre, opts, S,
                                   depth.reshape(-1)[S.idx],
                                   normal.reshape(-1, 3)[S.idx])
        return out.reshape(depth.shape)

    return cost


# -- the solver ----------------------------------------------------------------


def _unit(v: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(v * v, -1, keepdim=True))
    return v / torch.clamp(n, min=1e-9)


def _random_normals(g: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """Random unit normals facing the camera (n . ray < 0) from the
    standard-normal draw g [H, W, 3]."""
    n = _unit(g)
    d = torch.sum(n * rays, -1, keepdim=True)
    n = torch.where(d > 0, -n, n)
    n = 0.5 * n + 0.5 * _unit(-rays)
    return _unit(n)


def _propagate(depth, normal, rays, shift: Tuple[int, int]):
    """Depth induced at each pixel by the shifted neighbour's plane."""
    d_n = torch.roll(depth, shift, (0, 1))
    n_n = torch.roll(normal, shift, (0, 1))
    rays_n = torch.roll(rays, shift, (0, 1))
    num = torch.sum(n_n * (d_n[..., None] * rays_n), -1)
    den = torch.sum(n_n * rays, -1)
    den = torch.where(torch.abs(den) < 1e-9, torch.full_like(den, 1e-9), den)
    return num / den, n_n


def _perturb(draw, depth, normal, rays, scale: float):
    u, g = draw
    d = depth * torch.exp(u * scale)
    n = normal + g * scale
    nd = torch.sum(n * rays, -1, keepdim=True)
    return d, _unit(torch.where(nd > 0, -n, n))


@torch.no_grad()
def patch_match(draws, problem: PatchMatchProblem,
                options: PatchMatchOptions = PatchMatchOptions(),
                active_half: bool = True):
    """Run PatchMatch; returns (depth [H,W], normal [H,W,3], cost [H,W]) on
    the problem's device. `draws` is a GeneratorDraws or RecordedDraws.

    Filtered pixels (NCC too low) get depth 0. Its spans: `patch_match`
    around the whole call (it names what falls between the phases), and
    inside it `patch_match.precompute`, `patch_match.init`, one
    `patch_match.propagation` and one `patch_match.refinement` per
    half-iteration, `patch_match.filter`, and inside those one
    `patch_match.cost` per cost evaluation.
    """
    with span("patch_match"):
        return _patch_match(draws, problem, options, active_half)


def _patch_match(draws, problem: PatchMatchProblem,
                 options: PatchMatchOptions, active_half: bool):
    ref = problem.ref_image
    h, w = ref.shape
    dev = ref.device
    opts = options
    with span("patch_match.precompute"):
        pre = _precompute(problem, opts)
        rays = pre.rays
        dmin, dmax = problem.depth_min, problem.depth_max
        sets = _checker_sets(pre) if active_half else [
            _pixel_set(pre, torch.arange(h * w, device=dev))]

    def cost_at(S, depth, normal):
        return _set_cost(problem, pre, opts, S, depth.reshape(-1)[S.idx],
                         normal.reshape(-1, 3)[S.idx])

    def select(S, active, cand_d, cand_n, depth, normal, cost):
        """Keep each candidate (in order) where it lowers the cost at an
        active pixel of S."""
        df, nf, cf = depth.reshape(-1), normal.reshape(-1, 3), cost.reshape(-1)
        for d_c, n_c in zip(cand_d, cand_n):
            d_c = d_c.reshape(-1)[S.idx]
            n_c = n_c.reshape(-1, 3)[S.idx]
            c_c = _set_cost(problem, pre, opts, S, d_c, n_c)
            better = c_c < cf[S.idx]
            if active is not None:
                better &= active.reshape(-1)[S.idx]
            df[S.idx] = torch.where(better, d_c, df[S.idx])
            nf[S.idx] = torch.where(better[:, None], n_c, nf[S.idx])
            cf[S.idx] = torch.where(better, c_c, cf[S.idx])

    with span("patch_match.init"):
        u0, g0 = (t.to(dev) for t in draws.initial())
        log_lo = torch.log(dmin)
        log_hi = torch.log(dmax)
        depth = torch.exp(u0 * (log_hi - log_lo) + log_lo)
        normal = _random_normals(g0, rays)
        cost = torch.empty((h, w), dtype=_F32, device=dev)
        for S in sets:
            cost.reshape(-1)[S.idx] = cost_at(S, depth, normal)
        ys, xs = _pixel_grid(h, w, dev)
        checker = ((ys + xs) % 2).to(torch.bool)

    def draw():
        return tuple(t.to(dev) for t in draws.perturbation())

    for i in range(2 * opts.num_iterations):
        with span("patch_match.propagation", iteration=i):
            it = float(i // 2)
            cand = [_propagate(depth, normal, rays, shift)
                    for shift in ((1, 0), (-1, 0), (0, 1), (0, -1))]
            cand += [_perturb(draw(), depth, normal, rays,
                              0.5 * 2.0 ** -it / (j + 1))
                     for j in range(opts.num_perturbations)]
            cand_d = torch.clamp(torch.stack([c[0] for c in cand]), dmin,
                                 dmax)
            cand_n = torch.stack([c[1] for c in cand])
            if active_half:
                # colour (y + x) % 2 == 1 is active on even half-iterations
                select(sets[(i + 1) % 2], None, cand_d, cand_n, depth,
                       normal, cost)
            else:
                select(sets[0], checker ^ bool(i % 2), cand_d, cand_n, depth,
                       normal, cost)

    for i in range(2 * opts.num_refinement_iterations):
        with span("patch_match.refinement", iteration=i):
            scale = 0.02 * 2.0 ** -float(i // 2)
            cand = [_perturb(draw(), depth, normal, rays, scale / (j + 1))
                    for j in range(2)]
            cand_d = torch.clamp(torch.stack([c[0] for c in cand]), dmin,
                                 dmax)
            cand_n = torch.stack([c[1] for c in cand])
            for S in sets:
                select(S, None, cand_d, cand_n, depth, normal, cost)

    with span("patch_match.filter"):
        if opts.filter:
            # reference filtering: photometric cost = 1 - ncc must clear
            # filter_min_ncc (patch_match.h); geometric part is additive
            thresh = 1.0 - opts.filter_min_ncc
            if opts.geom_consistency:
                thresh = thresh + (opts.geom_consistency_regularizer
                                   * opts.geom_consistency_max_cost * 0.5)
            keep = cost < thresh
            depth = torch.where(keep, depth, torch.zeros_like(depth))
            normal = torch.where(keep[..., None], normal,
                                 torch.zeros_like(normal))
    return depth, normal, cost
