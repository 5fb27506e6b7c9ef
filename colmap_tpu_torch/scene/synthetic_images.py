"""Pixel-level synthetic dataset: render textured 3D scenes to images.

Complements the feature-level SyntheticDataset (scene/synthetic.py; reference
src/colmap/scene/synthetic.h) with a renderer that produces actual images,
so the FULL pipeline — SIFT extraction, matching, verification, mapping —
can be tested end-to-end against ground-truth poses (the pixel-level analog
of the reference's ETH3D CI gate, scripts/python/benchmark_eth3d.py).

The scene is a textured axis-aligned room (floor + two walls); every face is
planar, so each face renders into each view with one homography — exact,
anti-aliased by bilinear warping, no mesh rasterizer needed. Three mutually
orthogonal planes give well-conditioned non-planar structure for two-view
initialization.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class RoomDatasetOptions:
    num_images: int = 8
    width: int = 384
    height: int = 288
    focal: float = 320.0
    room_size: float = 4.0
    texture_res: int = 512
    texture_type: str = "noise"  # noise | grid (grid = Manhattan line structure)
    seed: int = 3


def _texture(rng, n: int) -> np.ndarray:
    """Multi-scale random texture with strong local structure."""
    img = np.zeros((n, n), np.float32)
    for cell in (n // 4, n // 8, n // 16, n // 32):
        g = rng.normal(0, 1, (n // cell, n // cell)).astype(np.float32)
        gi = np.kron(g, np.ones((cell, cell), np.float32))
        img += gi * cell / n * 4
    # bilinear smooth once to avoid pure blocks
    img = 0.25 * (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)
                  + np.roll(np.roll(img, 1, 0), 1, 1))
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return (img * 255).astype(np.uint8)


def _grid_texture(rng, n: int, spacing: int = 48, thickness: int = 3) -> np.ndarray:
    """Axis-aligned dark grid lines over a noisy background (strong
    Manhattan line structure for coordinate-frame tests)."""
    img = _texture(rng, n).astype(np.float32) * 0.4 + 120
    for k in range(0, n, spacing):
        img[k:k + thickness, :] = 20
        img[:, k:k + thickness] = 20
    return np.clip(img, 0, 255).astype(np.uint8)


def _lookat(center: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)):
    z = target - center
    z = z / np.linalg.norm(z)
    up = np.asarray(up, np.float64)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])  # world->cam rows
    t = -R @ center
    return R, t


def _warp_face(texture: np.ndarray, K, R, t, P0, e1, e2, out_shape):
    """Render one planar face via inverse homography (bilinear sampling).

    The face is P(u, v) = P0 + u*e1 + v*e2, (u, v) in [0, 1]^2; texture
    coords map linearly onto (u, v).
    """
    h, w = out_shape
    tn = texture.shape[0]
    # forward homography: [u, v, 1] -> image pixel
    M = K @ np.stack([R @ e1, R @ e2, R @ P0 + t], axis=1)  # 3x3
    ok = abs(np.linalg.det(M)) > 1e-12
    if not ok:
        return np.zeros(out_shape, np.float32), np.zeros(out_shape, bool)
    Minv = np.linalg.inv(M)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ Minv.T
    wz = pix[..., 2]
    u = pix[..., 0] / np.where(np.abs(wz) < 1e-12, 1e-12, wz)
    v = pix[..., 1] / np.where(np.abs(wz) < 1e-12, 1e-12, wz)
    # depth of the 3D point (camera z) must be positive
    P = (P0[None, None] + u[..., None] * e1[None, None]
         + v[..., None] * e2[None, None])
    z_cam = (P @ R.T + t)[..., 2]
    valid = (u >= 0) & (u < 1) & (v >= 0) & (v < 1) & (z_cam > 1e-6)
    tu = np.clip(u * (tn - 1), 0, tn - 1.000001)
    tv = np.clip(v * (tn - 1), 0, tn - 1.000001)
    u0 = tu.astype(np.int32)
    v0 = tv.astype(np.int32)
    fu = (tu - u0).astype(np.float32)
    fv = (tv - v0).astype(np.float32)
    tex = texture.astype(np.float32)
    val = ((1 - fv) * ((1 - fu) * tex[v0, u0] + fu * tex[v0, u0 + 1])
           + fv * ((1 - fu) * tex[v0 + 1, u0] + fu * tex[v0 + 1, u0 + 1]))
    return (np.where(valid, val, 0.0).astype(np.float32), valid,
            np.where(valid, z_cam, 0.0).astype(np.float32))


def render_room_dataset(options: RoomDatasetOptions = RoomDatasetOptions(),
                        return_depth: bool = False):
    """Render the room from a camera arc.

    Returns (images_u8, K, R_w2c [N,3,3], t_w2c [N,3]) and, when
    return_depth is set, additionally the GT depth maps [N,H,W] f32
    (0 = no surface).
    """
    rng = np.random.default_rng(options.seed)
    s = options.room_size
    w, h = options.width, options.height
    K = np.array([[options.focal, 0, w / 2.0],
                  [0, options.focal, h / 2.0],
                  [0, 0, 1.0]])

    # faces: back wall (z=+s), right wall (x=+s), floor (y=+s/2)
    faces = [
        (np.array([-s, -s / 2, s]), np.array([2 * s, 0, 0]), np.array([0.0, s, 0])),
        (np.array([s, -s / 2, s]), np.array([0, 0, -2 * s]), np.array([0.0, s, 0])),
        (np.array([-s, s / 2, s]), np.array([2 * s, 0, 0]), np.array([0, 0, -2 * s])),
    ]
    if options.texture_type == "grid":
        textures = [_grid_texture(rng, options.texture_res) for _ in faces]
    else:
        textures = [_texture(rng, options.texture_res) for _ in faces]

    images, Rs, ts, depths = [], [], [], []
    n = options.num_images
    for i in range(n):
        a = (i / max(n - 1, 1) - 0.5) * 0.9  # arc parameter
        center = np.array([a * s, -0.1 * s + 0.05 * s * np.sin(3 * a),
                           -s + 0.3 * s * abs(a)])
        target = np.array([0.3 * a * s, 0.0, s])
        R, t = _lookat(center, target)
        img = np.zeros((h, w), np.float32)
        dep = np.zeros((h, w), np.float32)
        for tex, (P0, e1, e2) in zip(textures, faces):
            val, valid, z = _warp_face(tex, K, R, t, P0, e1, e2, (h, w))
            # nearest surface wins where faces overlap
            closer = valid & ((dep == 0) | (z < dep))
            img = np.where(closer, val, img)
            dep = np.where(closer, z, dep)
        images.append(np.clip(img, 0, 255).astype(np.uint8))
        depths.append(dep)
        Rs.append(R)
        ts.append(t)
    if return_depth:
        return images, K, np.stack(Rs), np.stack(ts), np.stack(depths)
    return images, K, np.stack(Rs), np.stack(ts)


@dataclasses.dataclass
class OrbitDatasetOptions:
    """Walk-around capture: the camera circles a textured box standing in
    the middle of a fully-walled room, looking inward. Consecutive frames
    get real baseline (unlike a dense arc), points stay co-visible over
    O(100) frames, and a full orbit closes the loop — the geometry the
    reference's sequential matcher + vocab-tree loop detection is built
    for (reference: feature/pairing.h:60-120)."""

    num_images: int = 1000
    width: int = 640
    height: int = 480
    focal: float = 560.0
    room_size: float = 4.0      # room: [-s, s] x [-s/2, s/2] x [-s, s]
    box_half: float = 0.9       # central box half-extent in x/z
    box_height: float = 2.2     # box rises this far up from the floor
    orbit_radius: float = 2.6
    orbit_turns: float = 1.0    # fraction of full circles walked
    texture_res: int = 1024
    seed: int = 3


def _orbit_faces(options: OrbitDatasetOptions):
    """All planar faces of the orbit scene as (P0, e1, e2) quads."""
    s = options.room_size
    b = options.box_half
    ytop = s / 2 - options.box_height  # up is -y (floor at y=+s/2)
    return [
        # room: 4 walls, floor, ceiling (normals point inward via z-test)
        (np.array([-s, -s / 2, s]), np.array([2 * s, 0, 0]), np.array([0.0, s, 0])),
        (np.array([s, -s / 2, -s]), np.array([-2 * s, 0, 0]), np.array([0.0, s, 0])),
        (np.array([s, -s / 2, s]), np.array([0, 0, -2 * s]), np.array([0.0, s, 0])),
        (np.array([-s, -s / 2, -s]), np.array([0, 0, 2 * s]), np.array([0.0, s, 0])),
        (np.array([-s, s / 2, s]), np.array([2 * s, 0, 0]), np.array([0, 0, -2 * s])),
        (np.array([-s, -s / 2, -s]), np.array([2 * s, 0, 0]), np.array([0, 0, 2 * s])),
        # central box: 4 side faces + top (convex, so nearest-wins z-test
        # composes them correctly against the walls behind)
        (np.array([-b, ytop, b]), np.array([2 * b, 0, 0]),
         np.array([0.0, options.box_height, 0])),
        (np.array([b, ytop, -b]), np.array([-2 * b, 0, 0]),
         np.array([0.0, options.box_height, 0])),
        (np.array([b, ytop, b]), np.array([0, 0, -2 * b]),
         np.array([0.0, options.box_height, 0])),
        (np.array([-b, ytop, -b]), np.array([0, 0, 2 * b]),
         np.array([0.0, options.box_height, 0])),
        (np.array([-b, ytop, -b]), np.array([2 * b, 0, 0]),
         np.array([0, 0, 2 * b])),
    ]


def render_orbit_dataset(options: OrbitDatasetOptions = OrbitDatasetOptions(),
                         return_depth: bool = False):
    """Render the orbit scene. Returns (images_u8, K, R_w2c, t_w2c)
    (+ depths with return_depth), same contract as render_room_dataset."""
    rng = np.random.default_rng(options.seed)
    w, h = options.width, options.height
    s = options.room_size
    K = np.array([[options.focal, 0, w / 2.0],
                  [0, options.focal, h / 2.0],
                  [0, 0, 1.0]])
    faces = _orbit_faces(options)
    textures = [_texture(rng, options.texture_res) for _ in faces]

    images, Rs, ts, depths = [], [], [], []
    n = options.num_images
    r = options.orbit_radius
    ytop = s / 2 - options.box_height
    for i in range(n):
        th = 2 * np.pi * options.orbit_turns * i / n
        center = np.array([r * np.sin(th),
                           0.05 * s * np.sin(5 * th),  # slight height bob
                           r * np.cos(th)])
        # look at the box mid-height, slightly past center so the wall
        # behind the box stays in frame
        target = np.array([-0.2 * center[0], (ytop + s / 2) / 2 - 0.2,
                           -0.2 * center[2]])
        R, t = _lookat(center, target)
        img = np.zeros((h, w), np.float32)
        dep = np.zeros((h, w), np.float32)
        for tex, (P0, e1, e2) in zip(textures, faces):
            val, valid, z = _warp_face(tex, K, R, t, P0, e1, e2, (h, w))
            closer = valid & ((dep == 0) | (z < dep))
            img = np.where(closer, val, img)
            dep = np.where(closer, z, dep)
        images.append(np.clip(img, 0, 255).astype(np.uint8))
        depths.append(dep)
        Rs.append(R)
        ts.append(t)
    if return_depth:
        return images, K, np.stack(Rs), np.stack(ts), np.stack(depths)
    return images, K, np.stack(Rs), np.stack(ts)


def write_dataset(image_dir: str, images: List[np.ndarray]) -> List[str]:
    import os

    from colmap_tpu_torch.sensor import bitmap

    os.makedirs(image_dir, exist_ok=True)
    names = []
    for i, img in enumerate(images):
        name = f"image{i:04d}.png"
        bitmap.write_bitmap(os.path.join(image_dir, name), img)
        names.append(name)
    return names
