"""In-memory snapshot of the database for the mapper.

Port of colmap_tpu/scene/database_cache.py (reference:
scene/database_cache.h:53): loads cameras, images, keypoints and verified
matches once and builds the correspondence graph. The normalized camera
rays of every keypoint are computed on the device, one cam_from_img call
per camera.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from colmap_tpu_torch.scene.correspondence_graph import CorrespondenceGraph
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.reconstruction import Camera
from colmap_tpu_torch.sensor import models as camera_models


@dataclasses.dataclass
class CachedImage:
    image_id: int
    name: str
    camera_id: int
    xys: np.ndarray  # (F, 2) float32 pixels
    rays: np.ndarray  # (F, 2) float32 normalized camera coords


def _rays(cam_xys, device) -> list:
    """Normalized camera rays of many images: one cam_from_img call on
    `device` per camera over all of its images' keypoints."""
    out: list = [None] * len(cam_xys)
    groups: Dict[int, list] = {}
    for k, (cam, _) in enumerate(cam_xys):
        groups.setdefault(cam.camera_id, []).append(k)
    for idxs in groups.values():
        cam = cam_xys[idxs[0]][0]
        xys = np.concatenate([cam_xys[k][1] for k in idxs]).astype(np.float32)
        rays = camera_models.cam_from_img(
            int(cam.model_id),
            torch.as_tensor(cam.padded_params(), device=device),
            torch.as_tensor(xys, device=device)).cpu().numpy()
        off = 0
        for k in idxs:
            n = len(cam_xys[k][1])
            out[k] = rays[off: off + n]
            off += n
    return out


class DatabaseCache:
    def __init__(self):
        self.cameras: Dict[int, Camera] = {}
        self.images: Dict[int, CachedImage] = {}
        self.pose_priors: Dict[int, dict] = {}
        self.graph = CorrespondenceGraph()

    @classmethod
    def create(cls, database: Database, min_num_matches: int = 15,
               image_names: Optional[set] = None,
               device="cuda") -> "DatabaseCache":
        cache = cls()
        for cid, cam in database.read_cameras().items():
            cache.cameras[cid] = Camera(
                camera_id=cid,
                model_id=cam["model_id"],
                width=cam["width"],
                height=cam["height"],
                params=cam["params"],
            )

        pending = []  # (iid, im, xys): rays computed in one batched pass
        for iid, im in database.read_images().items():
            if image_names is not None and im["name"] not in image_names:
                continue
            kp = database.read_keypoints(iid)
            if kp is None:
                continue
            pending.append((iid, im, kp[:, :2].astype(np.float32)))

        all_rays = _rays(
            [(cache.cameras[im["camera_id"]], xys) for _, im, xys in pending],
            device)
        for (iid, im, xys), rays in zip(pending, all_rays):
            cache.images[iid] = CachedImage(
                image_id=iid,
                name=im["name"],
                camera_id=im["camera_id"],
                xys=xys,
                rays=rays,
            )
            cache.graph.add_image(iid, len(xys))

        cache.pose_priors = database.read_pose_priors()

        for (i1, i2), tvg in database.read_all_two_view_geometries().items():
            if i1 not in cache.images or i2 not in cache.images:
                continue
            m = tvg["inlier_matches"]
            if len(m) >= min_num_matches:
                cache.graph.add_correspondences(i1, i2, m)
        cache.graph.finalize()
        return cache
