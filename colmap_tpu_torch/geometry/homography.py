"""Homography decomposition (Malis-Vargas), batched.

Port of colmap_tpu/geometry/homography.py. The JAX version picks one of three normal-vector formulas with
lax.switch; here all three are built and the right one selected per batch
element.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.estimators.utils import svd
from colmap_tpu_torch.geometry import rigid3, rotation as rot
from colmap_tpu_torch.geometry.triangulation import triangulate_point


def homography_from_pose(K1: torch.Tensor, K2: torch.Tensor,
                         R: torch.Tensor, t: torch.Tensor, n: torch.Tensor,
                         d: torch.Tensor) -> torch.Tensor:
    """H = K2 (R - t n^T / d) K1^-1 of the plane n.X = d, batched."""
    return (K2 @ (R - t[..., :, None] @ n[..., None, :]
                  / d[..., None, None]) @ torch.linalg.inv(K1))


def _normalize_homography(H: torch.Tensor) -> torch.Tensor:
    """Scale H so its middle singular value is 1."""
    _, s, _ = svd(H)
    return H / s[..., 1:2, None]


def decompose_homography(H: torch.Tensor):
    """Malis-Vargas analytic decomposition of a calibrated homography.

    H: (..., 3, 3) normalized-coordinate homography. Returns candidate
    (R (..., 4, 3, 3), t (..., 4, 3), n (..., 4, 3)).
    """
    H = _normalize_homography(H)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    S = H.transpose(-1, -2) @ H - eye

    def s_(i, j):
        return S[..., i, j]

    def opposite_of_minor(row, col):
        x1 = 2 if col == 0 else 0
        x2 = 1 if col == 2 else 2
        y1 = 2 if row == 0 else 0
        y2 = 1 if row == 2 else 2
        return s_(y1, x2) * s_(y2, x1) - s_(y1, x1) * s_(y2, x2)

    M00 = opposite_of_minor(0, 0)
    M11 = opposite_of_minor(1, 1)
    M22 = opposite_of_minor(2, 2)
    rt00 = torch.sqrt(torch.clamp(M00, min=0.0))
    rt11 = torch.sqrt(torch.clamp(M11, min=0.0))
    rt22 = torch.sqrt(torch.clamp(M22, min=0.0))
    M01 = opposite_of_minor(0, 1)
    M12 = opposite_of_minor(1, 2)
    M02 = opposite_of_minor(0, 2)

    def sgn(x):
        return torch.where(x >= 0, 1.0, -1.0).to(H.dtype)

    e12, e02, e01 = sgn(M12), sgn(M02), sgn(M01)

    nS = torch.stack([torch.abs(s_(0, 0)), torch.abs(s_(1, 1)),
                      torch.abs(s_(2, 2))], dim=-1)
    idx = torch.argmax(nS, dim=-1)

    def pair(a, b):
        return torch.stack([torch.stack(a, -1), torch.stack(b, -1)], -2)

    case0 = pair([s_(0, 0), s_(0, 1) + rt22, s_(0, 2) + e12 * rt11],
                 [s_(0, 0), s_(0, 1) - rt22, s_(0, 2) - e12 * rt11])
    case1 = pair([s_(0, 1) + rt22, s_(1, 1), s_(1, 2) - e02 * rt00],
                 [s_(0, 1) - rt22, s_(1, 1), s_(1, 2) + e02 * rt00])
    case2 = pair([s_(0, 2) + e01 * rt11, s_(1, 2) + rt00, s_(2, 2)],
                 [s_(0, 2) - e01 * rt11, s_(1, 2) - rt00, s_(2, 2)])
    cases = torch.stack([case0, case1, case2], dim=-3)  # (..., 3, 2, 3)
    npa = torch.gather(cases, -3, idx[..., None, None, None].expand(
        idx.shape + (1, 2, 3)))[..., 0, :, :]

    traceS = S[..., 0, 0] + S[..., 1, 1] + S[..., 2, 2]
    v = 2.0 * torch.sqrt(torch.clamp(1.0 + traceS - M00 - M11 - M22,
                                     min=0.0))
    S_ii = torch.gather(torch.diagonal(S, dim1=-2, dim2=-1), -1,
                        idx[..., None])[..., 0]
    ESii = sgn(S_ii)
    r = torch.sqrt(torch.clamp(2.0 + traceS + v, min=0.0))
    n_t = torch.sqrt(torch.clamp(2.0 + traceS - v, min=0.0))

    n1 = npa[..., 0, :] / (torch.linalg.norm(npa[..., 0, :], dim=-1,
                                             keepdim=True) + 1e-12)
    n2 = npa[..., 1, :] / (torch.linalg.norm(npa[..., 1, :], dim=-1,
                                             keepdim=True) + 1e-12)
    half_nt = (0.5 * n_t)[..., None]
    esii_t_r = (ESii * r)[..., None]
    nt = n_t[..., None]
    t1_star = half_nt * (esii_t_r * n2 - nt * n1)
    t2_star = half_nt * (esii_t_r * n1 - nt * n2)
    v_safe = torch.where(torch.abs(v) > 1e-12, v, torch.full_like(v, 1e-12))

    def rmat_from_tstar_n(t_star, n):
        outer = t_star[..., :, None] * n[..., None, :]
        return H @ (eye - (2.0 / v_safe)[..., None, None] * outer)

    R1 = rmat_from_tstar_n(t1_star, n1)
    t1 = (R1 @ t1_star[..., None])[..., 0]
    R2 = rmat_from_tstar_n(t2_star, n2)
    t2 = (R2 @ t2_star[..., None])[..., 0]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t1, -t1, t2, -t2], dim=-2)
    ns = torch.stack([n1, -n1, n2, -n2], dim=-2)
    pure_rot = torch.linalg.norm(S, dim=(-2, -1)) < 1e-4
    Rs = torch.where(pure_rot[..., None, None, None],
                     H[..., None, :, :].expand(Rs.shape), Rs)
    ts = torch.where(pure_rot[..., None, None], torch.zeros_like(ts), ts)
    return Rs, ts, ns


def pose_from_homography(H: torch.Tensor, uv1: torch.Tensor,
                         uv2: torch.Tensor,
                         mask: torch.Tensor | None = None):
    """The cheirality-consistent pose among the homography decompositions.

    H (..., 3, 3); uv1/uv2 (..., N, 2); mask (..., N). Returns (pose
    (..., 7), num_in_front (...), n (..., 3)).
    """
    Rs, ts, ns = decompose_homography(H)
    U, _, Vt = svd(Rs)  # project candidates onto SO3
    Rs = U @ Vt
    Rs = Rs * torch.sign(torch.linalg.det(Rs))[..., None, None]
    cands = rigid3.make(rot.rotmat_to_quat(Rs), ts)  # (..., 4, 7)
    if mask is None:
        mask = torch.ones(uv1.shape[:-1], dtype=torch.bool, device=uv1.device)
    identity = rigid3.identity(H.dtype, H.device)
    posed = cands[..., :, None, :]
    X = triangulate_point(identity, posed, uv1[..., None, :, :],
                          uv2[..., None, :, :])
    z1 = X[..., 2]
    z2 = rigid3.apply(posed, X)[..., 2]
    ok = (z1 > 1e-6) & (z2 > 1e-6) & (z1 < 1000.0) & (z2 < 1000.0)
    ok &= mask[..., None, :]
    counts = ok.sum(-1)
    best = torch.argmax(counts, dim=-1)
    pose = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 7)))[..., 0, :]
    count = torch.gather(counts, -1, best[..., None])[..., 0]
    n = torch.gather(ns, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    return pose, count, n
