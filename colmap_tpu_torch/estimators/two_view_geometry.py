"""Two-view geometry estimation: the E/F/H decision cascade + pose recovery.

Port of colmap_tpu/estimators/two_view_geometry.py. The three RANSACs
(E 5-point, F 7-point, H 4-point) and the inlier-ratio arbitration run on a
batch of pairs at once: every tensor carries a leading pair axis B where the
JAX version is vmapped over pairs.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from colmap_tpu_torch.estimators import (
    essential_matrix as em,
    fundamental_matrix as fm,
    homography_matrix as hm,
)
from colmap_tpu_torch.geometry import rigid3
from colmap_tpu_torch.geometry.essential import pose_from_essential_matrix
from colmap_tpu_torch.geometry.homography import pose_from_homography
from colmap_tpu_torch.geometry.triangulation import (
    calculate_triangulation_angle, triangulate_point)
from colmap_tpu_torch.optim.ransac import RansacOptions, ransac


class TwoViewConfig(enum.IntEnum):
    """Matches the reference enum (scene/two_view_geometry.h:40-62)."""

    UNDEFINED = 0
    DEGENERATE = 1
    CALIBRATED = 2
    UNCALIBRATED = 3
    PLANAR = 4
    PANORAMIC = 5
    PLANAR_OR_PANORAMIC = 6
    WATERMARK = 7
    MULTIPLE = 8


@dataclasses.dataclass(frozen=True)
class TwoViewGeometryOptions:
    min_num_inliers: int = 15
    max_error_px: float = 4.0
    min_E_F_inlier_ratio: float = 0.95
    max_H_inlier_ratio: float = 0.8
    ransac: RansacOptions = dataclasses.field(
        default_factory=lambda: RansacOptions(num_samples=512,
                                              lo_iterations=2))
    compute_relative_pose: bool = False
    detect_watermark: bool = True
    watermark_min_inlier_ratio: float = 0.7
    watermark_border_size: float = 0.1


class TwoViewGeometry(NamedTuple):
    config: torch.Tensor  # (B,) int32
    E: torch.Tensor  # (B, 3, 3)
    F: torch.Tensor  # (B, 3, 3)
    H: torch.Tensor  # (B, 3, 3)
    inlier_mask: torch.Tensor  # (B, N) bool, of the winning model
    num_inliers: torch.Tensor  # (B,) int32
    cam2_from_cam1: torch.Tensor  # (B, 7), identity unless pose recovery ran
    tri_angle: torch.Tensor  # (B,) median triangulation angle (rad)


def estimate_two_view_geometry(
    generator: torch.Generator,
    rays1: torch.Tensor,  # (B, N, 2) normalized camera coords
    rays2: torch.Tensor,
    pix1: torch.Tensor,  # (B, N, 2) pixel coords
    pix2: torch.Tensor,
    valid: torch.Tensor,  # (B, N) bool
    mean_focal: torch.Tensor,  # (B,) geometric-mean focal of the two cams
    options: TwoViewGeometryOptions,
    sizes1: Optional[torch.Tensor] = None,  # (B, 2) [width, height]
    sizes2: Optional[torch.Tensor] = None,  # enables watermark detection
) -> TwoViewGeometry:
    """Calibrated two-view estimation of a batch of pairs: E (normalized
    coords), F and H (pixels) RANSACs, then the reference's arbitration.
    Samples are drawn from `generator` in the order E, F, H."""
    err_E = options.max_error_px / mean_focal
    err_px = torch.full_like(mean_focal, options.max_error_px)

    res_E = _ransac_dynamic_error(
        generator, em.solve_5pt, em.residuals, em.refit, (rays1, rays2),
        valid, 5, options.ransac, err_E)
    res_F = _ransac_dynamic_error(
        generator, fm.solve_7pt, fm.residuals, fm.refit, (pix1, pix2),
        valid, 7, options.ransac, err_px)
    res_H = _ransac_dynamic_error(
        generator, hm.solve_4pt, hm.residuals, hm.refit, (pix1, pix2),
        valid, 4, options.ransac, err_px)

    nE, nF, nH = res_E.num_inliers, res_F.num_inliers, res_H.num_inliers
    best_EF = torch.maximum(nE, nF)
    calibrated = nE >= options.min_E_F_inlier_ratio * best_EF.to(torch.float32)

    def full(v):
        return torch.full_like(nE, int(v))

    config = torch.where(calibrated, full(TwoViewConfig.CALIBRATED),
                         full(TwoViewConfig.UNCALIBRATED))
    num_inliers = torch.where(calibrated, nE, nF)
    inlier_mask = torch.where(calibrated[:, None], res_E.inlier_mask,
                              res_F.inlier_mask)

    # planar/panoramic overrides when H explains (almost) everything
    h_dominant = (nH.to(torch.float32)
                  > options.max_H_inlier_ratio * num_inliers.to(torch.float32))
    config = torch.where(h_dominant, full(TwoViewConfig.PLANAR_OR_PANORAMIC),
                         config)
    num_inliers = torch.where(h_dominant, torch.maximum(nH, num_inliers),
                              num_inliers)
    inlier_mask = torch.where(h_dominant[:, None], res_H.inlier_mask,
                              inlier_mask)

    if options.detect_watermark and sizes1 is not None and sizes2 is not None:
        wm = _detect_watermark(res_H.inlier_mask & valid, pix1, pix2,
                               sizes1, sizes2, options)
        config = torch.where(wm, full(TwoViewConfig.WATERMARK), config)

    enough = num_inliers >= options.min_num_inliers
    config = torch.where(enough, config, full(TwoViewConfig.DEGENERATE))
    num_inliers = torch.where(enough, num_inliers, torch.zeros_like(num_inliers))
    inlier_mask = inlier_mask & enough[:, None]

    B = rays1.shape[0]
    pose = rigid3.identity(rays1.dtype, rays1.device).expand(B, 7)
    tri_angle = torch.zeros(B, dtype=rays1.dtype, device=rays1.device)
    if options.compute_relative_pose:
        pose, tri_angle = recover_relative_pose(
            config, res_E.model, res_H.model, rays1, rays2, inlier_mask)

    return TwoViewGeometry(
        config=config.to(torch.int32), E=res_E.model, F=res_F.model,
        H=res_H.model, inlier_mask=inlier_mask,
        num_inliers=num_inliers.to(torch.int32), cam2_from_cam1=pose,
        tri_angle=tri_angle)


def _detect_watermark(h_inliers, pix1, pix2, sizes1, sizes2,
                      options: TwoViewGeometryOptions):
    """Watermark test (reference: two_view_geometry.cc:559): H inliers in
    the border of both images that follow one 2D translation."""
    cnt = h_inliers.sum(-1)
    n_inl = torch.clamp(cnt, min=1)

    def outside_box(pix, sizes):
        w, h = sizes[:, 0:1], sizes[:, 1:2]
        b = options.watermark_border_size * torch.sqrt(w ** 2 + h ** 2)
        inside = ((pix[..., 0] > b) & (pix[..., 0] < w - b)
                  & (pix[..., 1] > b) & (pix[..., 1] < h - b))
        return ~inside

    both_border = outside_box(pix1, sizes1) & outside_box(pix2, sizes2)
    border_ratio = (h_inliers & both_border).sum(-1) / n_inl

    t = pix2 - pix1
    n = t.shape[1]
    k = torch.clamp(cnt // 2, 0, n - 1)

    def masked_median(v):
        sv = torch.sort(torch.where(h_inliers, v, torch.full_like(v, 1e12)),
                        dim=-1).values
        return torch.gather(sv, 1, k[:, None])[:, 0]

    t_med = torch.stack([masked_median(t[..., 0]), masked_median(t[..., 1])],
                        dim=-1)
    close = ((t - t_med[:, None, :]) ** 2).sum(-1) < options.max_error_px ** 2
    trans_ratio = (h_inliers & close).sum(-1) / n_inl
    thr = options.watermark_min_inlier_ratio
    return (border_ratio >= thr) & (trans_ratio >= thr)


def _ransac_dynamic_error(generator, solver, residual_fn, refit_fn, data,
                          valid, sample_size, opts: RansacOptions,
                          max_error: torch.Tensor):
    """RANSAC with a per-pair max_error (B,): residuals are rescaled by it
    and scored against 1."""
    scale = 1.0 / torch.clamp(max_error, min=1e-12) ** 2

    def scaled_residuals(model, d):
        r = residual_fn(model, d)
        return r * scale.reshape((-1,) + (1,) * (r.dim() - 1))

    return ransac(generator, solver, scaled_residuals, refit_fn, data, valid,
                  sample_size, dataclasses.replace(opts, max_error=1.0))


def recover_relative_pose(config, E, H, rays1, rays2, inlier_mask):
    """cam2_from_cam1 (B, 7) + median triangulation angle over inliers (B,).

    E -> cheirality-voted decomposition; H -> the homography refit on the
    normalized rays over the inliers, then Malis-Vargas decomposition.
    """
    pose_E, _, _ = pose_from_essential_matrix(E, rays1, rays2, inlier_mask)
    H_norm, _ = hm.refit(H, (rays1, rays2), inlier_mask.to(rays1.dtype))
    pose_H, _, _ = pose_from_homography(H_norm, rays1, rays2, inlier_mask)
    use_H = config == int(TwoViewConfig.PLANAR_OR_PANORAMIC)
    pose = torch.where(use_H[:, None], pose_H, pose_E)

    n = rays1.shape[1]
    identity = rigid3.identity(rays1.dtype, rays1.device)
    posed = pose[:, None, :]
    X = triangulate_point(identity, posed, rays1, rays2)  # (B, N, 3)
    c1 = torch.zeros(3, dtype=rays1.dtype, device=rays1.device)
    c2 = rigid3.projection_center(pose)[:, None, :]
    angles = calculate_triangulation_angle(c1, c2, X)
    z1 = X[..., 2]
    z2 = rigid3.apply(posed, X)[..., 2]
    ok = inlier_mask & (z1 > 1e-6) & (z2 > 1e-6)
    a = torch.sort(torch.where(ok, angles, torch.full_like(angles,
                                                           float("inf"))),
                   dim=-1).values
    k = torch.clamp(ok.sum(-1) // 2, 0, n - 1)
    med = torch.gather(a, 1, k[:, None])[:, 0]
    med = torch.where(torch.isfinite(med), med, torch.zeros_like(med))
    return pose, med


def estimate_multiple_two_view_geometries(
    generator: torch.Generator,
    rays1: torch.Tensor,  # (N, 2) normalized camera coords of one pair
    rays2: torch.Tensor,
    pix1: torch.Tensor,  # (N, 2) pixel coords
    pix2: torch.Tensor,
    valid: torch.Tensor,  # (N,) bool
    mean_focal: torch.Tensor,  # () geometric-mean focal of the two cams
    options: TwoViewGeometryOptions,
    max_models: int = 4,
) -> Tuple[List[TwoViewGeometry], int]:
    """Multi-model estimation of one pair (reference:
    EstimateMultipleTwoViewGeometries, two_view_geometry.cc:235): estimate
    a geometry, remove its inliers, and repeat until too few matches remain
    or `max_models` were found. Returns the geometries (numpy, one pair
    each) and the combined config (MULTIPLE when there is more than one).

    A host loop over the batched estimator, as in the JAX package; each
    round draws from a generator of its own, seeded from `generator`, as
    the JAX package splits its key once a round."""
    geometries: List[TwoViewGeometry] = []
    cur_valid = valid.detach().cpu().numpy().astype(bool).copy()
    dev = rays1.device
    for _ in range(max_models):
        if cur_valid.sum() < options.min_num_inliers:
            break
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device))
        sub = torch.Generator(device=dev).manual_seed(seed)
        g = estimate_two_view_geometry(
            sub, rays1[None], rays2[None], pix1[None], pix2[None],
            torch.as_tensor(cur_valid, device=dev)[None],
            torch.as_tensor(mean_focal, dtype=rays1.dtype, device=dev)[None],
            options)
        g = TwoViewGeometry(*(x[0].cpu().numpy() for x in g))
        if int(g.num_inliers) < options.min_num_inliers:
            break
        if int(g.config) in (int(TwoViewConfig.DEGENERATE),
                             int(TwoViewConfig.UNDEFINED)):
            break
        geometries.append(g)
        cur_valid &= ~g.inlier_mask
    combined = (int(TwoViewConfig.MULTIPLE) if len(geometries) > 1
                else (int(geometries[0].config) if geometries
                      else int(TwoViewConfig.DEGENERATE)))
    return geometries, combined
