"""Textured planar scenes rendered on the device.

A copy of `colmap_tpu_torch/scene/synthetic_images.py`'s orbit
renderer: every face is a textured quad, rendered into each view by its
inverse homography with bilinear texture sampling, the nearest face
winning where faces overlap. The port renders in host numpy, one image
and face at a time (0.67 s a 640x480 frame); this copy renders a batch of
views per face on the device, and draws its textures from a
`torch.Generator`. `texture_from_grids` and `render` take their inputs as
arguments, so a test can hand them the port's numpy draws and poses.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

TEXTURE_CELLS = (4, 8, 16, 32)  # grids of n // 4 ... n // 32 texels


@dataclasses.dataclass(frozen=True)
class Orbit:
    """The port's OrbitDatasetOptions: a textured box in a walled room,
    the camera circling it. `frames` picks frames of the full orbit."""

    num_images: int = 1000
    width: int = 640
    height: int = 480
    focal: float = 560.0
    room_size: float = 4.0
    box_half: float = 0.9
    box_height: float = 2.2
    orbit_radius: float = 2.6
    orbit_turns: float = 1.0
    texture_res: int = 1024


def texture_from_grids(grids: Sequence[torch.Tensor], n: int,
                       weights: Optional[Sequence[float]] = None
                       ) -> torch.Tensor:
    """The port's multi-scale texture from its normal grids ((n // cell)^2
    each), as uint8 (n, n). Grid k has amplitude `weights[k]`; by default
    the port's cell / n * 4, which fades the fine grids."""
    img = torch.zeros((n, n), dtype=torch.float32, device=grids[0].device)
    for k, g in enumerate(grids):
        cell = n // g.shape[0]
        w = cell / n * 4 if weights is None else float(weights[k])
        img += (g.to(torch.float32).repeat_interleave(cell, 0)
                .repeat_interleave(cell, 1) * w)
    img = 0.25 * (img + torch.roll(img, 1, 0) + torch.roll(img, 1, 1)
                  + torch.roll(torch.roll(img, 1, 0), 1, 1))
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return (img * 255).to(torch.uint8)


def draw_textures(num: int, n: int, generator: torch.Generator,
                  cells: Sequence[int] = TEXTURE_CELLS,
                  weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    """`num` textures (num, n, n) uint8 from `generator`, on its device;
    `cells` are the grids' sizes and `weights` their amplitudes (the
    port's four grids and amplitudes by default)."""
    out = []
    for _ in range(num):
        grids = [torch.randn((c, c), generator=generator,
                             device=generator.device) for c in cells]
        out.append(texture_from_grids(grids, n, weights))
    return torch.stack(out)


def look_at(center: np.ndarray, target: np.ndarray,
            up=(0.0, -1.0, 0.0)) -> Tuple[np.ndarray, np.ndarray]:
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return R, -R @ center


def orbit_faces(o: Orbit):
    """The room's four walls, floor and ceiling, then the box's four sides
    and top, as (P0, e1, e2) quads (the port's order)."""
    s, b, h = o.room_size, o.box_half, o.box_height
    ytop = s / 2 - h
    v = np.array
    return [
        (v([-s, -s / 2, s]), v([2 * s, 0, 0]), v([0.0, s, 0])),
        (v([s, -s / 2, -s]), v([-2 * s, 0, 0]), v([0.0, s, 0])),
        (v([s, -s / 2, s]), v([0, 0, -2 * s]), v([0.0, s, 0])),
        (v([-s, -s / 2, -s]), v([0, 0, 2 * s]), v([0.0, s, 0])),
        (v([-s, s / 2, s]), v([2 * s, 0, 0]), v([0, 0, -2 * s])),
        (v([-s, -s / 2, -s]), v([2 * s, 0, 0]), v([0, 0, 2 * s])),
        (v([-b, ytop, b]), v([2 * b, 0, 0]), v([0.0, h, 0])),
        (v([b, ytop, -b]), v([-2 * b, 0, 0]), v([0.0, h, 0])),
        (v([b, ytop, b]), v([0, 0, -2 * b]), v([0.0, h, 0])),
        (v([-b, ytop, -b]), v([0, 0, 2 * b]), v([0.0, h, 0])),
        (v([-b, ytop, -b]), v([2 * b, 0, 0]), v([0, 0, 2 * b])),
    ]


def orbit_poses(o: Orbit, frames: Sequence[int]):
    """(R, t) of the given frames of the port's orbit."""
    s, r = o.room_size, o.orbit_radius
    ytop = s / 2 - o.box_height
    Rs, ts = [], []
    for i in frames:
        th = 2 * np.pi * o.orbit_turns * i / o.num_images
        center = np.array([r * np.sin(th), 0.05 * s * np.sin(5 * th),
                           r * np.cos(th)])
        target = np.array([-0.2 * center[0], (ytop + s / 2) / 2 - 0.2,
                           -0.2 * center[2]])
        R, t = look_at(center, target)
        Rs.append(R)
        ts.append(t)
    return np.stack(Rs), np.stack(ts)


def intrinsics(width: int, height: int, focal: float) -> np.ndarray:
    return np.array([[focal, 0, width / 2.0], [0, focal, height / 2.0],
                     [0, 0, 1.0]])


def face_normals(faces, Rs: np.ndarray) -> np.ndarray:
    """(n, F, 3): each face's unit normal in each view's camera frame."""
    nw = np.stack([np.cross(e1, e2) for _, e1, e2 in faces])
    nw /= np.linalg.norm(nw, axis=1, keepdims=True)
    return np.einsum("nij,fj->nfi", np.asarray(Rs), nw)


def render(textures: torch.Tensor, faces, K: np.ndarray, Rs: np.ndarray,
           ts: np.ndarray, width: int, height: int, rows: int = 256,
           with_face: bool = False):
    """Render views of the textured faces on the textures' device.

    Returns (images (n, H, W) uint8, depth (n, H, W) float32, 0 where no
    face is seen), and with `with_face` also the index of the face seen
    at each pixel (n, H, W) int64, -1 where none. Rows of pixels go in
    bands of `rows`, so memory stays small at any size."""
    dev = textures.device
    n, tn = len(Rs), textures.shape[-1]
    tex = textures.to(torch.float32)
    f64 = dict(dtype=torch.float64, device=dev)
    Kt = torch.as_tensor(K, **f64)
    Rt = torch.as_tensor(np.asarray(Rs), **f64)
    tt = torch.as_tensor(np.asarray(ts), **f64)
    images = torch.zeros((n, height, width), dtype=torch.uint8, device=dev)
    depth = torch.zeros((n, height, width), dtype=torch.float32, device=dev)
    face = torch.full((n, height, width), -1, dtype=torch.int64, device=dev)
    xs = torch.arange(width, **f64)
    for y0 in range(0, height, rows):
        ys = torch.arange(y0, min(y0 + rows, height), **f64)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pix = torch.stack([gx, gy, torch.ones_like(gx)], -1)  # (h, W, 3)
        img = torch.zeros((n,) + gx.shape, dtype=torch.float32, device=dev)
        dep = torch.zeros_like(img)
        fid = torch.full(img.shape, -1, dtype=torch.int64, device=dev)
        for k, (P0, e1, e2) in enumerate(faces):
            P0t, e1t, e2t = (torch.as_tensor(v, **f64) for v in (P0, e1, e2))
            M = Kt @ torch.stack([Rt @ e1t, Rt @ e2t, Rt @ P0t + tt], dim=-1)
            ok = torch.linalg.det(M).abs() > 1e-12
            Minv = torch.linalg.inv(torch.where(
                ok[:, None, None], M, torch.eye(3, **f64)))
            uvw = torch.einsum("hwj,nij->nhwi", pix, Minv)
            wz = uvw[..., 2]
            wz = torch.where(wz.abs() < 1e-12, torch.full_like(wz, 1e-12), wz)
            u, v = uvw[..., 0] / wz, uvw[..., 1] / wz
            P = (P0t + u[..., None] * e1t + v[..., None] * e2t)
            z_cam = (torch.einsum("nhwj,nj->nhw", P, Rt[:, 2, :])
                     + tt[:, None, None, 2])
            valid = ((u >= 0) & (u < 1) & (v >= 0) & (v < 1) & (z_cam > 1e-6)
                     & ok[:, None, None])
            tu = torch.clamp(u * (tn - 1), 0, tn - 1.000001)
            tv = torch.clamp(v * (tn - 1), 0, tn - 1.000001)
            u0, v0 = tu.to(torch.int64), tv.to(torch.int64)
            fu, fv = (tu - u0).to(torch.float32), (tv - v0).to(torch.float32)
            T = tex[k]
            val = ((1 - fv) * ((1 - fu) * T[v0, u0] + fu * T[v0, u0 + 1])
                   + fv * ((1 - fu) * T[v0 + 1, u0] + fu * T[v0 + 1, u0 + 1]))
            z32 = z_cam.to(torch.float32)
            closer = valid & ((dep == 0) | (z32 < dep))
            img = torch.where(closer, val, img)
            dep = torch.where(closer, z32, dep)
            fid = torch.where(closer, k, fid)
        sl = slice(y0, y0 + img.shape[1])
        images[:, sl] = torch.clamp(img, 0, 255).to(torch.uint8)
        depth[:, sl] = dep
        face[:, sl] = fid
    return (images, depth, face) if with_face else (images, depth)
