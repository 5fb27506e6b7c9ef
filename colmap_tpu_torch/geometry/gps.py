"""GPS / geodetic conversions: WGS84 ellipsoid <-> ECEF <-> ENU.

Port of colmap_tpu/geometry/gps.py (reference: src/colmap/geometry/gps.h:
43-70, GPSTransform), used by spatial pair generation. The functions
compute in the input tensor's dtype and on its device; callers pass
float64, since ECEF coordinates of ~6.4e6 m keep only ~0.5 m in float32.
"""

from __future__ import annotations

import math

import torch

# WGS84 ellipsoid constants
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_B = WGS84_A * (1.0 - WGS84_F)
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)

# GRS80
GRS80_A = 6378137.0
GRS80_F = 1.0 / 298.257222100882711
GRS80_E2 = GRS80_F * (2.0 - GRS80_F)


def ell_to_ecef(lat_lon_alt: torch.Tensor, a: float = WGS84_A,
                e2: float = WGS84_E2) -> torch.Tensor:
    """(lat deg, lon deg, alt m) (..., 3) -> ECEF xyz (..., 3)."""
    lat = torch.deg2rad(lat_lon_alt[..., 0])
    lon = torch.deg2rad(lat_lon_alt[..., 1])
    alt = lat_lon_alt[..., 2]
    sin_lat, cos_lat = torch.sin(lat), torch.cos(lat)
    N = a / torch.sqrt(1.0 - e2 * sin_lat ** 2)
    x = (N + alt) * cos_lat * torch.cos(lon)
    y = (N + alt) * cos_lat * torch.sin(lon)
    z = (N * (1.0 - e2) + alt) * sin_lat
    return torch.stack([x, y, z], dim=-1)


def ecef_to_ell(xyz: torch.Tensor, a: float = WGS84_A,
                e2: float = WGS84_E2) -> torch.Tensor:
    """ECEF (..., 3) -> (lat deg, lon deg, alt m), Bowring iteration (fixed
    10 steps)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = torch.atan2(y, x)
    p = torch.sqrt(x * x + y * y)
    lat = torch.atan2(z, p * (1.0 - e2))
    for _ in range(10):
        sin_lat = torch.sin(lat)
        N = a / torch.sqrt(1.0 - e2 * sin_lat ** 2)
        lat = torch.atan2(z + e2 * N * sin_lat, p)
    sin_lat = torch.sin(lat)
    N = a / torch.sqrt(1.0 - e2 * sin_lat ** 2)
    alt = torch.where(torch.abs(torch.cos(lat)) > 1e-8,
                      p / torch.cos(lat) - N, z / sin_lat - N * (1.0 - e2))
    return torch.stack([torch.rad2deg(lat), torch.rad2deg(lon), alt], dim=-1)


def ecef_to_enu(xyz: torch.Tensor, ref_lat_deg, ref_lon_deg,
                ref_ecef) -> torch.Tensor:
    """ECEF -> local East-North-Up at the given reference origin."""
    lat = math.radians(float(ref_lat_deg))
    lon = math.radians(float(ref_lon_deg))
    sl, cl = math.sin(lat), math.cos(lat)
    so, co = math.sin(lon), math.cos(lon)
    R = torch.tensor([[-so, co, 0.0],
                      [-sl * co, -sl * so, cl],
                      [cl * co, cl * so, sl]], dtype=xyz.dtype,
                     device=xyz.device)
    return (xyz - torch.as_tensor(ref_ecef, dtype=xyz.dtype,
                                  device=xyz.device)) @ R.T


def ell_to_enu(lat_lon_alt: torch.Tensor, ref_lat_deg=None,
               ref_lon_deg=None) -> torch.Tensor:
    """Geodetic (N, 3) or (3,) -> ENU relative to the first point (or to the
    given reference at altitude 0)."""
    ecef = ell_to_ecef(lat_lon_alt)
    if ref_lat_deg is None:
        first = lat_lon_alt[0] if lat_lon_alt.ndim > 1 else lat_lon_alt
        ref_lat_deg, ref_lon_deg = first[0], first[1]
        ref_ecef = ecef[0] if ecef.ndim > 1 else ecef
    else:
        ref_ecef = ell_to_ecef(torch.tensor(
            [float(ref_lat_deg), float(ref_lon_deg), 0.0],
            dtype=lat_lon_alt.dtype, device=lat_lon_alt.device))
    return ecef_to_enu(ecef, ref_lat_deg, ref_lon_deg, ref_ecef)
