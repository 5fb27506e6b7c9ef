"""Multi-camera rigs.

Port of colmap_tpu/scene/camera_rig.py (reference: scene/camera_rig.h:46):
a rig is a set of cameras with fixed relative poses (cam_from_rig); a
snapshot is the set of images captured at one rig position. The rig bundle
adjuster (estimators/rig_bundle_adjustment.py) uses it. Host bookkeeping:
the poses compose in float32 on the CPU, as the JAX package composes them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from colmap_tpu_torch.geometry import rigid3


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def _mean_pose(poses: np.ndarray) -> np.ndarray:
    """Quaternion average (same hemisphere as the first) and mean
    translation of (K, 7) poses."""
    q = poses[:, :4]
    q = np.where((q @ q[0])[:, None] < 0, -q, q)
    q_mean = q.mean(0)
    q_mean /= np.linalg.norm(q_mean)
    return np.concatenate([q_mean, poses[:, 4:].mean(0)])


@dataclasses.dataclass
class CameraRig:
    # camera_id -> cam_from_rig (7,) [qw qx qy qz t]
    cams_from_rig: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)
    ref_camera_id: Optional[int] = None
    # each snapshot: list of image ids captured simultaneously
    snapshots: List[List[int]] = dataclasses.field(default_factory=list)

    def add_camera(self, camera_id: int, cam_from_rig: np.ndarray):
        self.cams_from_rig[camera_id] = np.asarray(cam_from_rig, np.float64)
        if self.ref_camera_id is None:
            self.ref_camera_id = camera_id

    def add_snapshot(self, image_ids: List[int]):
        self.snapshots.append(list(image_ids))

    @property
    def num_cameras(self) -> int:
        return len(self.cams_from_rig)

    def check(self, rec) -> bool:
        for snap in self.snapshots:
            cams = [rec.images[i].camera_id for i in snap]
            if len(set(cams)) != len(cams):
                return False
            if any(c not in self.cams_from_rig for c in cams):
                return False
        return True

    def compute_rig_from_world(self, snapshot_idx: int, rec) -> np.ndarray:
        """Average rig pose over a snapshot's registered images
        (reference: CameraRig::ComputeRigFromWorld)."""
        poses = []
        for iid in self.snapshots[snapshot_idx]:
            im = rec.images[iid]
            if not im.registered:
                continue
            rig_from_cam = rigid3.inverse(
                _f32(self.cams_from_rig[im.camera_id]))
            poses.append(rigid3.compose(rig_from_cam,
                                        _f32(im.cam_from_world)).numpy())
        if not poses:
            raise ValueError("no registered images in snapshot")
        return _mean_pose(np.stack(poses))

    def compute_cams_from_rigs(self, rec):
        """Calibrate cam_from_rig from the registered reconstruction
        (reference: ComputeCamsFromRigs): the pose of each camera relative
        to the reference camera, averaged over the snapshots."""
        ref = self.ref_camera_id
        rel: Dict[int, List[np.ndarray]] = {c: [] for c in self.cams_from_rig}
        for snap in self.snapshots:
            by_cam = {rec.images[i].camera_id: i for i in snap
                      if rec.images[i].registered}
            if ref not in by_cam:
                continue
            world_from_ref = rigid3.inverse(
                _f32(rec.images[by_cam[ref]].cam_from_world))
            for cid, iid in by_cam.items():
                rel[cid].append(rigid3.compose(
                    _f32(rec.images[iid].cam_from_world),
                    world_from_ref).numpy())
        for cid, poses in rel.items():
            if poses:
                self.cams_from_rig[cid] = _mean_pose(
                    np.stack(poses)).astype(np.float64)
