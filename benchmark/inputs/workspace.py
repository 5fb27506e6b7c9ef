"""An undistorted dense workspace of rendered keyframes.

The frames come from `render.py`'s orbit scene; the sparse model beside
them is the ground truth: PINHOLE cameras, the true poses, and surface
points sampled on a grid of each frame's true depth map, each observed in
every frame whose own depth map agrees with it within 1%. PatchMatch reads
its depth ranges and source images from those points, as it would from a
mapper's model. The program's own model writer lays the workspace out
(`images/`, `sparse/`, `stereo/`), since that layout is the program's
input format.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image as PILImage

from benchmark.inputs import render

PINHOLE = 1
POINT_STEP = 32  # px between the sampled true surface points


def build(folder: str, orbit: render.Orbit, frames: Sequence[int],
          seed: int, device: str, K: Optional[np.ndarray] = None,
          texture_cells: Sequence[int] = render.TEXTURE_CELLS,
          texture_weights: Optional[Sequence[float]] = None) -> dict:
    """Render the frames into `folder` as a workspace, through the
    calibration `K` (by default the orbit's focal at the image centre);
    returns the ground truth: images (n, H, W) uint8, depth (n, H, W),
    normal (n, H, W, 3) in each camera's frame facing it (0 where no
    surface is seen), image names, K, R, t."""
    from colmap_tpu_torch.scene import reconstruction_io
    from colmap_tpu_torch.scene.reconstruction import (
        Camera, Image, Reconstruction)

    faces = render.orbit_faces(orbit)
    if K is None:
        K = render.intrinsics(orbit.width, orbit.height, orbit.focal)
    R, t = render.orbit_poses(orbit, frames)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    tex = render.draw_textures(len(faces), orbit.texture_res, g,
                               texture_cells, texture_weights)
    images, depth, face = (x.cpu().numpy() for x in render.render(
        tex, faces, K, R, t, orbit.width, orbit.height, with_face=True))
    normal = true_normals(face, render.face_normals(faces, R), K)
    for sub in ("images", "stereo/depth_maps", "stereo/normal_maps",
                "stereo/consistency_graphs"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    names = [f"frame{f:06d}.png" for f in frames]
    for name, im in zip(names, images):
        PILImage.fromarray(im).save(os.path.join(folder, "images", name),
                                    compress_level=1)

    # ground-truth sparse points: a grid of each frame's surface
    n, H, W = depth.shape
    obs = [[] for _ in range(n)]  # per frame: (x, y, point)
    xyz = []
    tracks = []
    for i in range(n):
        ys, xs = np.mgrid[POINT_STEP // 2:H:POINT_STEP,
                          POINT_STEP // 2:W:POINT_STEP]
        d = depth[i, ys, xs]
        ok = d > 0
        xs, ys, d = xs[ok], ys[ok], d[ok].astype(np.float64)
        Xc = np.stack([(xs - K[0, 2]) / K[0, 0] * d,
                       (ys - K[1, 2]) / K[1, 1] * d, d], -1)
        Xw = (Xc - t[i]) @ R[i]  # R^T (Xc - t)
        for X in Xw:
            track = []
            pid = len(xyz)
            for j in range(n):
                Xj = R[j] @ X + t[j]
                if Xj[2] <= 0:
                    continue
                u = K[0, 0] * Xj[0] / Xj[2] + K[0, 2]
                v = K[1, 1] * Xj[1] / Xj[2] + K[1, 2]
                ui, vi = int(round(u)), int(round(v))
                if not (0 <= ui < W and 0 <= vi < H):
                    continue
                dj = depth[j, vi, ui]
                if dj > 0 and abs(dj - Xj[2]) < 0.01 * Xj[2]:
                    track.append((j, len(obs[j])))
                    obs[j].append((u, v, pid))
            xyz.append(X)
            tracks.append(track)

    rec = Reconstruction()
    rec.add_camera(Camera(camera_id=1, model_id=PINHOLE, width=W, height=H,
                          params=np.array([K[0, 0], K[1, 1], K[0, 2],
                                           K[1, 2]])))
    for j in range(n):
        q = render_quat(R[j])
        xys = np.array([(u, v) for u, v, _ in obs[j]],
                       np.float64).reshape(-1, 2)
        rec.add_image(Image(image_id=j + 1, name=names[j], camera_id=1,
                            cam_from_world=np.concatenate([q, t[j]]),
                            xys=xys, point3D_ids=np.full(len(xys), -1,
                                                         np.int64)))
    for X, track in zip(xyz, tracks):
        if len(track) >= 2:
            rec.add_point3D(X, [(j + 1, k) for j, k in track])
    os.makedirs(os.path.join(folder, "sparse"), exist_ok=True)
    reconstruction_io.write_model(rec, os.path.join(folder, "sparse"),
                                  ext=".bin")
    return dict(images=images, depth=depth, normal=normal, names=names,
                K=K, R=R, t=t)


def true_normals(face: np.ndarray, normals: np.ndarray,
                 K: np.ndarray) -> np.ndarray:
    """(n, H, W, 3) float32: the normal of the face seen at each pixel
    (`normals` (n, F, 3) in camera frames), turned to face the camera
    (n . ray < 0); 0 where no face is seen."""
    n, H, W = face.shape
    ys, xs = np.mgrid[0:H, 0:W]
    rays = np.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                     np.ones((H, W))], -1)
    out = np.zeros((n, H, W, 3), np.float32)
    for i in range(n):
        seen = face[i] >= 0
        nc = normals[i][face[i][seen]]
        flip = np.sum(nc * rays[seen], -1) > 0
        out[i][seen] = np.where(flip[:, None], -nc, nc)
    return out


def render_quat(R: np.ndarray) -> np.ndarray:
    """A rotation matrix as a unit quaternion (w, x, y, z), w >= 0."""
    return rotmat_to_quat(torch.as_tensor(R, dtype=torch.float64)).numpy()


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations -> (..., 4) unit quaternions (w, x, y, z),
    w >= 0, from the best-conditioned of Shepperd's four formulas."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    diag = torch.stack([tr, m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], -1)
    k = torch.argmax(diag, dim=-1)
    s_w = torch.sqrt(torch.clamp(1.0 + tr, min=1e-30)) * 2
    s_x = torch.sqrt(torch.clamp(1.0 + m[..., 0, 0] - m[..., 1, 1]
                                 - m[..., 2, 2], min=1e-30)) * 2
    s_y = torch.sqrt(torch.clamp(1.0 - m[..., 0, 0] + m[..., 1, 1]
                                 - m[..., 2, 2], min=1e-30)) * 2
    s_z = torch.sqrt(torch.clamp(1.0 - m[..., 0, 0] - m[..., 1, 1]
                                 + m[..., 2, 2], min=1e-30)) * 2
    cands = torch.stack([
        torch.stack([s_w / 4, (m[..., 2, 1] - m[..., 1, 2]) / s_w,
                     (m[..., 0, 2] - m[..., 2, 0]) / s_w,
                     (m[..., 1, 0] - m[..., 0, 1]) / s_w], -1),
        torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / s_x, s_x / 4,
                     (m[..., 0, 1] + m[..., 1, 0]) / s_x,
                     (m[..., 0, 2] + m[..., 2, 0]) / s_x], -1),
        torch.stack([(m[..., 0, 2] - m[..., 2, 0]) / s_y,
                     (m[..., 0, 1] + m[..., 1, 0]) / s_y, s_y / 4,
                     (m[..., 1, 2] + m[..., 2, 1]) / s_y], -1),
        torch.stack([(m[..., 1, 0] - m[..., 0, 1]) / s_z,
                     (m[..., 0, 2] + m[..., 2, 0]) / s_z,
                     (m[..., 1, 2] + m[..., 2, 1]) / s_z, s_z / 4], -1),
    ], dim=-2)
    out = torch.gather(cands, -2, k[..., None, None].expand(
        k.shape + (1, 4)))[..., 0, :]
    out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return torch.where(out[..., :1] < 0, -out, out)
