"""Essential matrix estimation: Nistér 5-point, 8-point refit, Sampson residual.

Port of colmap_tpu/estimators/essential_matrix.py. The 5-point solver is the
same shape-static elimination: nullspace of the 5x9 epipolar system, the
ten cubic constraints expanded with static monomial multiplication tables,
one 10x10 solve, the degree-10 determinant polynomial and Durand-Kerner
roots. Every step takes any leading batch shape (..., 5, 2).
"""

from __future__ import annotations

import numpy as np
import torch

from colmap_tpu_torch.estimators.fundamental_matrix import (
    _epipolar_rows, sampson_residuals)
from colmap_tpu_torch.estimators.utils import (
    least_singular_vector, nullspace_from_rows, solve, svd)
from colmap_tpu_torch.math.polynomial import find_roots_durand_kerner

_MON1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # x, y, z, 1
_MON2 = [
    (2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1),
    (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]
# degree-<=3 monomials: the first 10 have (x,y)-degree >= 2, the last 10
# (x,y)-degree <= 1, which makes the elimination a plain [I | D] solve
_MON3_LEFT = [
    (3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0), (2, 0, 1),
    (1, 1, 1), (0, 2, 1), (2, 0, 0), (1, 1, 0), (0, 2, 0),
]
_MON3_RIGHT = [
    (1, 0, 2), (0, 1, 2), (1, 0, 1), (0, 1, 1), (1, 0, 0),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_MON3 = _MON3_LEFT + _MON3_RIGHT


def _mul_table(mon_a, mon_b, mon_out):
    idx = {m: i for i, m in enumerate(mon_out)}
    T = np.zeros((len(mon_a), len(mon_b), len(mon_out)), dtype=np.float32)
    for i, ma in enumerate(mon_a):
        for j, mb in enumerate(mon_b):
            T[i, j, idx[tuple(a + b for a, b in zip(ma, mb))]] = 1.0
    return T


_T11 = _mul_table(_MON1, _MON1, _MON2)  # (4, 4, 10)
_T21 = _mul_table(_MON2, _MON1, _MON3)  # (10, 4, 20)


def solve_5pt(p1: torch.Tensor, p2: torch.Tensor):
    """Nistér 5-point minimal solver on normalized rays.

    p1/p2: (..., 5, 2). Returns (E (..., 10, 3, 3), valid (..., 10)).
    """
    dtype, dev = p1.dtype, p1.device
    T11 = torch.as_tensor(_T11, device=dev)
    T21 = torch.as_tensor(_T21, device=dev)
    lead = p1.shape[:-2]

    def mul11(a, b):
        return torch.einsum("...i,...j,ijk->...k", a, b, T11)

    def mul21(a, b):
        return torch.einsum("...i,...j,ijk->...k", a, b, T21)

    A = _epipolar_rows(p1, p2)  # (..., 5, 9)
    ns = nullspace_from_rows(A, 4)  # (..., 9, 4) basis [X, Y, Z, W]
    Ep = ns.reshape(lead + (3, 3, 4))  # E entries as polynomials in x,y,z,1

    def e(i, j):
        return Ep[..., i, j, :]

    def m2(i1, j1, i2, j2):
        return mul11(e(i1, j1), e(i2, j2))

    det_row = (mul21(m2(1, 1, 2, 2) - m2(1, 2, 2, 1), e(0, 0))
               - mul21(m2(1, 0, 2, 2) - m2(1, 2, 2, 0), e(0, 1))
               + mul21(m2(1, 0, 2, 1) - m2(1, 1, 2, 0), e(0, 2)))  # (..., 20)

    EEt = torch.einsum("...ika,...jkb,abm->...ijm", Ep, Ep, T11)
    tr = EEt[..., 0, 0, :] + EEt[..., 1, 1, :] + EEt[..., 2, 2, :]
    C = (2.0 * torch.einsum("...ika,...kjb,abm->...ijm", EEt, Ep, T21)
         - torch.einsum("...a,...ijb,abm->...ijm", tr, Ep, T21))
    M = torch.cat([det_row[..., None, :], C.reshape(lead + (9, 20))],
                  dim=-2)  # (..., 10, 20)
    D = solve(M[..., :10], M[..., 10:])  # (..., 10, 10)

    # row i: alpha_i(z) x + beta_i(z) y + gamma_i(z), with
    # R = [xz^2, yz^2, xz, yz, x, y, z^3, z^2, z, 1] (ascending in z)
    def alpha(i):
        return torch.stack([D[..., i, 4], D[..., i, 2], D[..., i, 0]], -1)

    def beta(i):
        return torch.stack([D[..., i, 5], D[..., i, 3], D[..., i, 1]], -1)

    def gamma(i):
        return torch.stack([D[..., i, 9], D[..., i, 8], D[..., i, 7],
                            D[..., i, 6]], -1)

    def pad(p, n):
        return torch.cat([p, p.new_zeros(p.shape[:-1] + (n - p.shape[-1],))],
                         dim=-1)

    def shift(p):  # multiply by z
        return torch.cat([p.new_zeros(p.shape[:-1] + (1,)), p], dim=-1)

    def sub(a, b):
        n = max(a.shape[-1], b.shape[-1])
        return pad(a, n) - pad(b, n)

    rows = []
    for lo, hi in ((7, 4), (8, 5), (9, 6)):
        rows.append((sub(shift(alpha(lo)), alpha(hi)),
                     sub(shift(beta(lo)), beta(hi)),
                     sub(shift(gamma(lo)), gamma(hi))))

    def conv(p, q):
        n = p.shape[-1] + q.shape[-1] - 1
        out = p.new_zeros(p.shape[:-1] + (n,))
        for i in range(p.shape[-1]):
            out = out + pad(torch.cat([p.new_zeros(p.shape[:-1] + (i,)),
                                       p[..., i:i + 1] * q], dim=-1), n)
        return out

    (a1, b1, c1), (a2, b2, c2), (a3, b3, c3) = rows
    term1 = conv(a1, sub(conv(b2, c3), conv(b3, c2)))
    term2 = conv(b1, sub(conv(a2, c3), conv(a3, c2)))
    term3 = conv(c1, sub(conv(a2, b3), conv(a3, b2)))
    det_poly = pad(term1, 11) - pad(term2, 11) + pad(term3, 11)  # ascending

    roots = find_roots_durand_kerner(det_poly.flip(-1), num_iters=80)
    z = roots.real
    is_real = torch.abs(roots.imag) <= 1e-3 * (1.0 + torch.abs(z))

    def eval_asc(p, zz):
        out = torch.zeros_like(zz)
        for i in range(p.shape[-1] - 1, -1, -1):
            out = out * zz + p[..., i:i + 1]
        return out

    Bm = torch.stack([
        torch.stack([eval_asc(pad(a, 5), z), eval_asc(pad(b, 5), z),
                     eval_asc(pad(c, 5), z)], dim=-1)
        for (a, b, c) in rows], dim=-2)  # (..., 10, 3, 3) per root

    # nullspace of each 3x3 from the best-conditioned row-pair cross product
    r0, r1, r2 = Bm[..., 0, :], Bm[..., 1, :], Bm[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1, dim=-1),
                         torch.linalg.cross(r0, r2, dim=-1),
                         torch.linalg.cross(r1, r2, dim=-1)], dim=-2)
    best = torch.argmax(torch.linalg.norm(cands, dim=-1), dim=-1)
    sol = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    w = sol[..., 2]
    w_safe = torch.where(torch.abs(w) > 1e-12, w, torch.full_like(w, 1e-12))
    x = sol[..., 0] / w_safe
    y = sol[..., 1] / w_safe

    coeffs = torch.stack([x, y, z, torch.ones_like(z)], dim=-1)  # (..., 10, 4)
    E = torch.einsum("...rk,...ijk->...rij", coeffs, Ep)
    E = E / (torch.linalg.norm(E, dim=(-2, -1), keepdim=True) + 1e-12)
    valid = (is_real & (torch.abs(w) > 1e-10)
             & torch.isfinite(E).all(-1).all(-1))
    return E.to(dtype), valid


def project_to_essential(F: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: singular values -> (s, s, 0)."""
    U, s, Vt = svd(F)
    sigma = 0.5 * (s[..., 0] + s[..., 1])
    s_new = torch.stack([sigma, sigma, torch.zeros_like(sigma)], dim=-1)
    E = U @ (s_new[..., :, None] * Vt)
    return E / (torch.linalg.norm(E, dim=(-2, -1), keepdim=True) + 1e-12)


def _solve_8pt_essential(p1, p2, weights=None):
    A = _epipolar_rows(p1, p2)
    if weights is not None:
        A = A * torch.sqrt(weights)[..., None]
    f = least_singular_vector(A)
    E = project_to_essential(f.reshape(f.shape[:-1] + (3, 3)))
    ok = torch.isfinite(E).all(-1).all(-1)
    return E, ok


def solve_8pt(p1: torch.Tensor, p2: torch.Tensor):
    E, ok = _solve_8pt_essential(p1, p2)
    return E[..., None, :, :], ok[..., None]


def refit(model, data: tuple, weights: torch.Tensor):
    del model
    p1, p2 = data
    return _solve_8pt_essential(p1, p2, weights)


residuals = sampson_residuals
