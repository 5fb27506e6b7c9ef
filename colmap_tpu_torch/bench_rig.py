"""A synthetic multi-camera rig capture for the rig bundle adjuster and the
generalized pose estimators.

    from colmap_tpu_torch import bench_rig
    scene = bench_rig.build_scene(seed=0)           # the [rig] cell
    rec, config = scene.reconstruction(), scene.rig_config()

The scene is a vehicle or backpack rig of 4 SIMPLE_RADIAL 1024x768 cameras
(focal 400: 104 degrees across, so neighbours overlap by 14 degrees and
tie the extrinsics together) facing front, right, back and left, each
0.3 m from the rig centre, moving
along a gently weaving path (`num_snapshots` positions `spacing` apart).
Every point is planted in front of one camera of one snapshot (a random
pixel at 3-15 m) and observed, with Gaussian pixel noise, by every image of
the `track_snapshots` snapshots around that one that sees it, so 50,000
points give ~300k observations, the size of the JAX bench's BA cell
(bench.py:74-90). Everything comes from one numpy seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.scene.reconstruction import (
    Camera, Image, Reconstruction)
from colmap_tpu_torch.sensor import models as cm

WIDTH, HEIGHT, FOCAL = 1024, 768, 400.0
RADIAL = -0.02
# rig camera rotations (rows: the camera's x, y, z axes in the rig frame;
# the rig frame is the front camera's: x right, y down, z forward)
_FACINGS = {
    "front": [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
    "right": [[0, 0, -1], [0, 1, 0], [1, 0, 0]],
    "back": [[-1, 0, 0], [0, 1, 0], [0, 0, -1]],
    "left": [[0, 0, 1], [0, 1, 0], [-1, 0, 0]],
}


def _quat(R: np.ndarray) -> np.ndarray:
    return rot.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float64)).numpy()


def _yaw(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


@dataclasses.dataclass
class RigScene:
    cam_R: np.ndarray  # (C, 3, 3) cam_from_rig rotations
    cam_t: np.ndarray  # (C, 3)
    rig_R: np.ndarray  # (S, 3, 3) rig_from_world rotations
    rig_t: np.ndarray  # (S, 3)
    points: np.ndarray  # (M, 3)
    obs_image: np.ndarray  # (N,) image index s * C + c
    obs_point: np.ndarray  # (N,)
    obs_xy: np.ndarray  # (N, 2) noisy pixels
    spacing: float

    @property
    def num_cameras(self) -> int:
        return len(self.cam_R)

    @property
    def num_snapshots(self) -> int:
        return len(self.rig_R)

    def cams_from_rig(self) -> np.ndarray:
        """(C, 7) [q, t]."""
        return np.stack([np.concatenate([_quat(R), t])
                         for R, t in zip(self.cam_R, self.cam_t)])

    def rig_poses(self) -> np.ndarray:
        """(S, 7) rig_from_world [q, t]."""
        return np.stack([np.concatenate([_quat(R), t])
                         for R, t in zip(self.rig_R, self.rig_t)])

    def image_poses(self) -> np.ndarray:
        """(S * C, 7) cam_from_world of image s * C + c."""
        out = []
        for Rr, tr in zip(self.rig_R, self.rig_t):
            for Rc, tc in zip(self.cam_R, self.cam_t):
                out.append(np.concatenate([_quat(Rc @ Rr), Rc @ tr + tc]))
        return np.stack(out)

    def image_name(self, k: int) -> str:
        s, c = divmod(k, self.num_cameras)
        return f"cam{c + 1}/frame{s:04d}.png"

    def reconstruction(self) -> Reconstruction:
        """The ground-truth model: camera c + 1 per rig camera, image
        s * C + c + 1 named cam{c+1}/frame{s:04d}.png, every point with its
        noisy observations."""
        rec = Reconstruction()
        C = self.num_cameras
        for c in range(C):
            rec.add_camera(Camera(camera_id=c + 1, model_id=int(
                cm.CameraModelId.SIMPLE_RADIAL), width=WIDTH, height=HEIGHT,
                params=np.array([FOCAL, WIDTH / 2, HEIGHT / 2, RADIAL])))
        order = np.argsort(self.obs_image, kind="stable")
        counts = np.bincount(self.obs_image, minlength=self.num_snapshots * C)
        starts = np.concatenate([[0], np.cumsum(counts)])
        feat = np.empty(len(order), np.int64)
        feat[order] = np.arange(len(order)) - starts[self.obs_image[order]]
        for k, pose in enumerate(self.image_poses()):
            rows = order[starts[k]:starts[k + 1]]
            rec.add_image(Image(
                image_id=k + 1, name=self.image_name(k), camera_id=k % C + 1,
                cam_from_world=pose, xys=self.obs_xy[rows].astype(np.float64),
                point3D_ids=np.full(len(rows), -1, np.int64)))
        tracks = [[] for _ in range(len(self.points))]
        for n, (k, m) in enumerate(zip(self.obs_image, self.obs_point)):
            tracks[m].append((int(k) + 1, int(feat[n])))
        for m, track in enumerate(tracks):
            if len(track) >= 2:
                pid = rec.add_point3D(self.points[m], track)
                for iid, f in track:
                    rec.images[iid].point3D_ids[f] = pid
        return rec

    def rig_config(self) -> list:
        """COLMAP's rig_config.json content, the front camera the
        reference."""
        q = self.cams_from_rig()
        return [{"ref_camera_id": 1, "cameras": [
            {"camera_id": c + 1, "image_prefix": f"cam{c + 1}/",
             "cam_from_rig_rotation": q[c, :4].tolist(),
             "cam_from_rig_translation": q[c, 4:].tolist()}
            for c in range(self.num_cameras)]}]


def project(R, t, X):
    """SIMPLE_RADIAL pixels and depths of world points X (..., 3) in
    cameras (R, t)."""
    pc = np.einsum("...ij,...j->...i", R, X) + t
    z = pc[..., 2]
    uv = pc[..., :2] / np.where(np.abs(z) > 1e-9, z, 1e-9)[..., None]
    uv = uv * (1 + RADIAL * np.sum(uv * uv, -1, keepdims=True))
    return FOCAL * uv + np.array([WIDTH / 2, HEIGHT / 2]), z


def build_scene(num_snapshots: int = 125, num_points: int = 50_000,
                track_snapshots: int = 5, spacing: float = 0.5,
                noise_px: float = 0.5, seed: int = 0) -> RigScene:
    rng = np.random.default_rng(seed)
    names = list(_FACINGS)
    cam_R = np.array([_FACINGS[n] for n in names], np.float64)
    dirs = cam_R[:, 2]  # each camera's viewing direction in the rig frame
    centre = np.array([0.0, 0.0, -0.3])  # the front camera sits at 0
    cam_C = centre + 0.3 * dirs
    cam_t = -np.einsum("cij,cj->ci", cam_R, cam_C)
    S = num_snapshots
    yaw = 0.15 * np.sin(np.arange(S) / 12.0)
    rig_R = np.stack([_yaw(a) for a in yaw])
    # positions: forward along the heading, integrated
    fwd = np.stack([R.T @ np.array([0.0, 0, 1]) for R in rig_R])
    pos = np.concatenate([[np.zeros(3)], np.cumsum(fwd[:-1] * spacing, 0)])
    rig_t = -np.einsum("sij,sj->si", rig_R, pos)

    img_R = np.einsum("cij,sjk->scik", cam_R, rig_R).reshape(-1, 3, 3)
    img_t = (np.einsum("cij,sj->sci", cam_R, rig_t) + cam_t[None]).reshape(
        -1, 3)
    img_C = -np.einsum("kji,kj->ki", img_R, img_t)
    K, C = len(img_R), len(cam_R)
    # plant each point in front of a random image
    anchor = rng.integers(0, K, num_points)
    px = rng.uniform([0, 0], [WIDTH, HEIGHT], (num_points, 2))
    depth = rng.uniform(3.0, 15.0, num_points)
    ray = np.concatenate([(px - [WIDTH / 2, HEIGHT / 2]) / FOCAL,
                          np.ones((num_points, 1))], 1)
    X = (np.einsum("nji,nj->ni", img_R[anchor], ray * depth[:, None]
                   - img_t[anchor]))
    obs_image, obs_point, obs_xy = [], [], []
    for m0 in range(0, num_points, 2000):
        Xc = X[m0:m0 + 2000]
        xy, z = project(img_R[None], img_t[None], Xc[:, None])
        # in the frame, and inside the distortion's monotonic range (a
        # point far outside the view can fold back into the frame)
        pc = np.einsum("kij,nkj->nki", img_R, Xc[:, None] - img_C[None])
        r2 = np.sum((pc[..., :2] / np.maximum(z, 1e-9)[..., None]) ** 2, -1)
        seen = ((z > 0.5) & (z < 30) & (xy[..., 0] >= 0) & (xy[..., 0] < WIDTH)
                & (xy[..., 1] >= 0) & (xy[..., 1] < HEIGHT)
                & (r2 < 1.0 / (3.0 * abs(RADIAL))))
        # the images of the `track_snapshots` snapshots around the anchor's
        # that see the point (both cameras where their views overlap)
        s_a = anchor[m0:m0 + 2000] // C
        lo = np.clip(s_a - track_snapshots // 2, 0, S - track_snapshots)
        s_k = np.arange(K) // C
        seen &= (s_k[None] >= lo[:, None]) & (s_k[None] < lo[:, None]
                                               + track_snapshots)
        m, k = np.nonzero(seen)
        obs_image.append(k)
        obs_point.append(m0 + m)
        obs_xy.append(xy[m, k])
    obs_xy = np.concatenate(obs_xy)
    obs_xy = obs_xy + rng.normal(0, noise_px, obs_xy.shape)
    return RigScene(cam_R=cam_R, cam_t=cam_t, rig_R=rig_R, rig_t=rig_t,
                    points=X, obs_image=np.concatenate(obs_image),
                    obs_point=np.concatenate(obs_point), obs_xy=obs_xy,
                    spacing=spacing)


def perturb(rec: Reconstruction, scene: RigScene, seed: int = 1,
            rot_deg: float = 0.5, rig_shift: float = 0.03,
            cam_shift: float = 0.02, point_shift: float = 0.02):
    """Perturb the model in place as a rig BA start: every rig pose but the
    first turns by `rot_deg` about its centre, which moves by `rig_shift` x
    spacing; every non-reference camera turns by `rot_deg` in the rig and
    moves by `cam_shift` m (the images of a snapshot move together); every
    point moves by `point_shift` m. Returns the perturbed (C, 7)
    cams_from_rig to write into the rig configuration."""
    rng = np.random.default_rng(seed)
    C, S = scene.num_cameras, scene.num_snapshots

    def small_rotation(deg):
        axis = rng.normal(size=3)
        aa = np.radians(deg) * axis / np.linalg.norm(axis)
        q = rot.quat_from_axis_angle(torch.as_tensor(aa)).numpy()
        return rot.quat_to_rotmat(torch.as_tensor(q)).numpy()

    def moved(R, t, deg, shift):
        """(R, t) rotated by `deg` about its own centre, which moves by
        `shift` in a random direction."""
        centre = -R.T @ t
        d = rng.normal(size=3)
        R = small_rotation(deg) @ R
        return R, -R @ (centre + shift * d / np.linalg.norm(d))

    rig_R, rig_t = scene.rig_R.copy(), scene.rig_t.copy()
    for s in range(1, S):
        rig_R[s], rig_t[s] = moved(rig_R[s], rig_t[s], rot_deg,
                                   rig_shift * scene.spacing)
    cam_R, cam_t = scene.cam_R.copy(), scene.cam_t.copy()
    for c in range(1, C):
        cam_R[c], cam_t[c] = moved(cam_R[c], cam_t[c], rot_deg, cam_shift)
    for s in range(S):
        for c in range(C):
            R = cam_R[c] @ rig_R[s]
            rec.images[s * C + c + 1].cam_from_world = np.concatenate(
                [_quat(R), cam_R[c] @ rig_t[s] + cam_t[c]])
    for p in rec.points3D.values():
        d = rng.normal(size=3)
        p.xyz = p.xyz + point_shift * d / np.linalg.norm(d)
    return np.stack([np.concatenate([_quat(R), t])
                     for R, t in zip(cam_R, cam_t)])
