"""The sparse-model container (host side, numpy-backed).

Port of colmap_tpu/scene/reconstruction.py (reference:
scene/reconstruction.h:59): cameras/images/points3D maps, observation
add/delete, registration bookkeeping, normalization, Sim3 transform,
summary statistics. The mapper keeps its working state in flat arrays; this
class is the interchange container used for IO, alignment and evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from colmap_tpu_torch.sensor import models as camera_models

INVALID_POINT3D_ID = np.uint64(0xFFFFFFFFFFFFFFFF)


@dataclasses.dataclass
class Camera:
    camera_id: int
    model_id: int
    width: int
    height: int
    params: np.ndarray  # (num_params,) float64, unpadded

    @property
    def model_name(self) -> str:
        return camera_models.MODEL_NAMES[camera_models.CameraModelId(self.model_id)]

    def padded_params(self, dtype=np.float32) -> np.ndarray:
        return camera_models.pad_params(list(self.params), dtype=dtype)

    def mean_focal_length(self) -> float:
        i_fx, i_fy, _, _ = camera_models._FXFY_CXCY[camera_models.CameraModelId(self.model_id)]
        return 0.5 * (self.params[i_fx] + self.params[i_fy])


@dataclasses.dataclass
class Image:
    image_id: int
    name: str
    camera_id: int
    cam_from_world: Optional[np.ndarray] = None  # (7,) [qw qx qy qz t] or None
    xys: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )  # -1 = not triangulated

    @property
    def registered(self) -> bool:
        return self.cam_from_world is not None

    def num_points3D(self) -> int:
        return int(np.sum(self.point3D_ids >= 0))

    def projection_center(self) -> np.ndarray:
        # pure numpy (host metadata path; no device round-trip)
        q = self.cam_from_world[:4] / np.linalg.norm(self.cam_from_world[:4])
        w, x, y, z = q
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        return -R.T @ self.cam_from_world[4:7]


@dataclasses.dataclass
class Point3D:
    xyz: np.ndarray  # (3,)
    color: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.uint8))
    error: float = -1.0
    track: List[Tuple[int, int]] = dataclasses.field(default_factory=list)  # (image_id, point2D_idx)


class Reconstruction:
    def __init__(self):
        self.cameras: Dict[int, Camera] = {}
        self.images: Dict[int, Image] = {}
        self.points3D: Dict[int, Point3D] = {}
        self._next_point3D_id = 1

    # -- registration/bookkeeping ------------------------------------------------
    def add_camera(self, camera: Camera):
        self.cameras[camera.camera_id] = camera

    def add_image(self, image: Image):
        self.images[image.image_id] = image

    def add_point3D(self, xyz, track, color=None, error=-1.0) -> int:
        pid = self._next_point3D_id
        self._next_point3D_id += 1
        self.points3D[pid] = Point3D(
            xyz=np.asarray(xyz, dtype=np.float64),
            color=np.zeros(3, np.uint8) if color is None else np.asarray(color, np.uint8),
            error=error,
            track=list(track),
        )
        for image_id, p2d_idx in track:
            self.images[image_id].point3D_ids[p2d_idx] = pid
        return pid

    def delete_point3D(self, pid: int):
        pt = self.points3D.pop(pid, None)
        if pt is None:
            return
        for image_id, p2d_idx in pt.track:
            img = self.images.get(image_id)
            if img is not None and img.point3D_ids[p2d_idx] == pid:
                img.point3D_ids[p2d_idx] = -1

    def registered_image_ids(self) -> List[int]:
        return [i for i, im in self.images.items() if im.registered]

    def num_registered_images(self) -> int:
        return len(self.registered_image_ids())

    # -- statistics ---------------------------------------------------------------
    def compute_mean_track_length(self) -> float:
        if not self.points3D:
            return 0.0
        return float(np.mean([len(p.track) for p in self.points3D.values()]))

    def compute_mean_observations_per_reg_image(self) -> float:
        ids = self.registered_image_ids()
        if not ids:
            return 0.0
        return float(np.mean([self.images[i].num_points3D() for i in ids]))

    def compute_mean_reprojection_error(self) -> float:
        errs = [p.error for p in self.points3D.values() if p.error >= 0]
        return float(np.mean(errs)) if errs else 0.0

    def summary(self) -> str:
        return (
            f"Reconstruction:\n"
            f"\tnum_cameras = {len(self.cameras)}\n"
            f"\tnum_images = {len(self.images)}\n"
            f"\tnum_reg_images = {self.num_registered_images()}\n"
            f"\tnum_points3D = {len(self.points3D)}\n"
            f"\tmean_track_length = {self.compute_mean_track_length():.4f}\n"
            f"\tmean_observations_per_image = {self.compute_mean_observations_per_reg_image():.4f}\n"
            f"\tmean_reprojection_error = {self.compute_mean_reprojection_error():.4f}"
        )

    # -- geometry -----------------------------------------------------------------
    def transform(self, new_from_old_sim3: np.ndarray):
        """Apply a Sim3 (8,) to the whole model (points + poses). Host
        bookkeeping: float64 torch on the CPU."""
        import torch

        from colmap_tpu_torch.geometry import sim3

        s = torch.as_tensor(np.asarray(new_from_old_sim3, np.float64))
        for p in self.points3D.values():
            p.xyz = sim3.apply(s, torch.as_tensor(
                np.asarray(p.xyz, np.float64))).numpy()
        for im in self.images.values():
            if im.registered:
                im.cam_from_world = sim3.transform_rigid(
                    s, torch.as_tensor(np.asarray(im.cam_from_world,
                                                  np.float64))).numpy()

    def normalize(self, fixed_scale: bool = False, extent: float = 10.0,
                  min_percentile: float = 0.1, max_percentile: float = 0.9):
        """Center at the proj-center centroid and scale to a fixed extent.

        Reference: Reconstruction::Normalize (scene/reconstruction.cc) — uses
        percentile bounds of camera centers to compute the scale.
        """
        ids = self.registered_image_ids()
        if len(ids) < 2:
            return np.array([1.0, 1, 0, 0, 0, 0, 0, 0])
        centers = np.stack([self.images[i].projection_center() for i in ids])
        sorted_c = np.sort(centers, axis=0)
        n = len(ids)
        i0 = min(n - 1, max(0, int(min_percentile * n)))
        i1 = min(n - 1, max(0, int(max_percentile * n)))
        bbox_min, bbox_max = sorted_c[i0], sorted_c[i1]
        mean_coord = 0.5 * (bbox_min + bbox_max)
        old_extent = float(np.linalg.norm(bbox_max - bbox_min))
        scale = 1.0 if (fixed_scale or old_extent < 1e-6) else extent / old_extent
        tvec = -scale * mean_coord
        sim = np.array([scale, 1.0, 0, 0, 0, *tvec])
        self.transform(sim)
        return sim
