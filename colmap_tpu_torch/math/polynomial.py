"""Polynomial roots as fixed-iteration PyTorch programs.

Port of colmap_tpu/math/polynomial.py: Durand-Kerner simultaneous
iteration in complex64 with a fixed iteration count (a Python loop where
JAX uses fori_loop), and the closed-form real cubic.
"""

from __future__ import annotations

import math

import torch


def find_roots_durand_kerner(coeffs: torch.Tensor,
                             num_iters: int = 60) -> torch.Tensor:
    """Roots of real polynomials (..., D+1), highest degree first.
    Returns complex64 roots (..., D)."""
    D = coeffs.shape[-1] - 1
    lead = coeffs[..., :1]
    lead = torch.where(torch.abs(lead) > 1e-12, lead,
                       torch.full_like(lead, 1e-12))
    cm = coeffs / lead  # monic

    # rescale z = s*w so the roots w are O(1)
    cauchy_r = 1.0 + torch.amax(torch.abs(cm[..., 1:]), dim=-1, keepdim=True)
    s = torch.clamp(cauchy_r ** (1.0 / D), min=1e-6)
    powers = torch.arange(D + 1, dtype=cm.dtype, device=cm.device)
    cm = cm / s ** powers
    c = cm.to(torch.complex64)

    cauchy = 1.0 + torch.amax(torch.abs(c[..., 1:]), dim=-1, keepdim=True)
    k = torch.arange(D, dtype=torch.float32, device=cm.device)
    angles = 2.0 * math.pi * k / D + 0.4
    unit = torch.complex(torch.cos(angles), torch.sin(angles))
    z = (0.7 * cauchy).to(torch.complex64) * unit
    eye = torch.eye(D, dtype=torch.complex64, device=cm.device)

    for _ in range(num_iters):
        p = c[..., 0:1].expand(z.shape)
        for i in range(1, D + 1):
            p = p * z + c[..., i:i + 1]
        diff = z[..., :, None] - z[..., None, :] + eye  # diagonal -> 1
        denom = torch.prod(diff, dim=-1)
        denom = torch.where(torch.abs(denom) > 1e-20, denom,
                            torch.full_like(denom, 1e-20))
        delta = p / denom
        mag = torch.abs(delta)
        delta = torch.where(mag > 1.0, delta / mag, delta)  # trust region
        z = z - delta
    return z * s.to(torch.complex64)


def cubic_real_roots(c3, c2, c1, c0):
    """Real roots of c3 x^3 + c2 x^2 + c1 x + c0 (trigonometric / Cardano).
    Returns (roots (..., 3), valid (..., 3))."""
    c3 = torch.where(torch.abs(c3) > 1e-12, c3, torch.full_like(c3, 1e-12))
    a = c2 / c3
    b = c1 / c3
    c = c0 / c3
    q = (3.0 * b - a * a) / 9.0
    r = (9.0 * a * b - 27.0 * c - 2.0 * a ** 3) / 54.0
    disc = q ** 3 + r ** 2

    theta = torch.arccos(torch.clamp(
        r / torch.sqrt(torch.clamp(-(q ** 3), min=1e-24)), -1.0, 1.0))
    m = 2.0 * torch.sqrt(torch.clamp(-q, min=0.0))
    r1 = m * torch.cos(theta / 3.0) - a / 3.0
    r2 = m * torch.cos((theta + 2.0 * math.pi) / 3.0) - a / 3.0
    r3 = m * torch.cos((theta + 4.0 * math.pi) / 3.0) - a / 3.0

    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    s = _cbrt(r + sq)
    t = _cbrt(r - sq)
    r_single = s + t - a / 3.0

    three = disc <= 0
    roots = torch.stack([torch.where(three, r1, r_single),
                         torch.where(three, r2, r_single),
                         torch.where(three, r3, r_single)], dim=-1)
    valid = torch.stack([torch.ones_like(three), three, three], dim=-1)
    return roots, valid


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)
