"""MVS workspace model: per-image pinhole calibration, depth ranges,
source-image selection.

Port of colmap_tpu/mvs/model.py (reference: src/colmap/mvs/model.h:48,
Model::Read, ComputeDepthRanges, GetMaxOverlappingImages), host numpy over
the port's undistorted (PINHOLE) Reconstruction. Rotations come from
`geometry.rotation.quat_to_rotmat` in float64, as the JAX module's own
float64 formula gives them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from colmap_tpu_torch.geometry import rotation
from colmap_tpu_torch.scene.reconstruction import Reconstruction


@dataclasses.dataclass
class MVSImage:
    image_id: int
    name: str
    K: np.ndarray  # (3, 3)
    R: np.ndarray  # (3, 3) world->cam
    t: np.ndarray  # (3,)
    width: int
    height: int

    @property
    def P(self) -> np.ndarray:
        return self.K @ np.concatenate([self.R, self.t[:, None]], axis=1)

    def center(self) -> np.ndarray:
        return -self.R.T @ self.t


@dataclasses.dataclass
class MVSModel:
    images: Dict[int, MVSImage]
    depth_ranges: Dict[int, Tuple[float, float]]
    overlap_scores: Dict[int, List[Tuple[int, float]]]  # ref -> [(src, score)]

    def src_images(self, ref_id: int, max_num: int = 20) -> List[int]:
        """Best source images by shared-point score (reference:
        PatchMatchController src selection '__auto__', patch_match.cc).

        Images with no shared sparse points (late registrations) fall back
        to the nearest cameras by projection center, so every reference
        image still gets stereo sources.
        """
        srcs = [i for i, _ in self.overlap_scores.get(ref_id, [])[:max_num]]
        if srcs or ref_id not in self.images:
            return srcs
        c = self.images[ref_id].center()
        others = sorted(
            (iid for iid in self.images if iid != ref_id),
            key=lambda iid: float(np.linalg.norm(self.images[iid].center() - c)))
        return others[:max_num]


def build_model(rec: Reconstruction, max_triangulation_angle_deg: float = 90.0
                ) -> MVSModel:
    """Build the MVS model from an undistorted reconstruction.

    Depth ranges from the sparse points (robust percentiles with the
    reference's stretch margins); pairwise overlap scores from shared
    3D points weighted by triangulation angle (reference:
    Model::ComputeDepthRanges / GetMaxOverlappingImages, model.cc).
    """
    images: Dict[int, MVSImage] = {}
    for iid, img in rec.images.items():
        if not img.registered:
            continue
        cam = rec.cameras[img.camera_id]
        fx, fy, cx, cy = cam.params[:4]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        pose = torch.as_tensor(np.asarray(img.cam_from_world, np.float64))
        R = rotation.quat_to_rotmat(
            pose[:4] / torch.linalg.vector_norm(pose[:4])).numpy()
        images[iid] = MVSImage(image_id=iid, name=img.name, K=K, R=R,
                               t=pose[4:7].numpy().copy(), width=cam.width,
                               height=cam.height)
    centers = {iid: im.center() for iid, im in images.items()}

    # per-image depths of visible sparse points
    depths: Dict[int, List[float]] = {iid: [] for iid in images}
    shared: Dict[Tuple[int, int], List[float]] = {}
    for pt in rec.points3D.values():
        track_imgs = [iid for iid, _ in pt.track if iid in images]
        for iid in track_imgs:
            im = images[iid]
            z = float(im.R[2] @ pt.xyz + im.t[2])
            if z > 0:
                depths[iid].append(z)
        # pairwise triangulation angles
        for a_i in range(len(track_imgs)):
            for b_i in range(a_i + 1, len(track_imgs)):
                a, b = track_imgs[a_i], track_imgs[b_i]
                va = pt.xyz - centers[a]
                vb = pt.xyz - centers[b]
                cosang = np.dot(va, vb) / max(
                    np.linalg.norm(va) * np.linalg.norm(vb), 1e-12)
                ang = float(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
                shared.setdefault((min(a, b), max(a, b)), []).append(ang)

    # reference: Model::ComputeDepthRanges (model.cc:174-215) -
    # 1st/99th percentiles stretched by kStretchRatio = 0.25
    depth_ranges = {}
    for iid, ds in depths.items():
        if not ds:
            continue
        arr = np.asarray(ds)
        lo = float(np.percentile(arr, 1)) * 0.75
        hi = float(np.percentile(arr, 99)) * 1.25
        depth_ranges[iid] = (max(lo, 1e-4), hi)
    # images with no visible sparse points search the union of all ranges
    if depth_ranges:
        glo = min(r[0] for r in depth_ranges.values())
        ghi = max(r[1] for r in depth_ranges.values())
    else:
        glo, ghi = 0.1, 100.0
    for iid in depths:
        if iid not in depth_ranges:
            depth_ranges[iid] = (glo, ghi)

    # overlap score: shared points with a usable triangulation angle,
    # weighted to prefer ~10 deg baselines
    overlap: Dict[int, List[Tuple[int, float]]] = {iid: [] for iid in images}
    for (a, b), angs in shared.items():
        angs = np.asarray(angs)
        usable = angs[(angs > 1.0) & (angs < max_triangulation_angle_deg)]
        if len(usable) == 0:
            continue
        score = float(np.sum(np.minimum(usable / 10.0, 1.0)))
        overlap[a].append((b, score))
        overlap[b].append((a, score))
    for iid in overlap:
        overlap[iid].sort(key=lambda kv: -kv[1])

    return MVSModel(images=images, depth_ranges=depth_ranges,
                    overlap_scores=overlap)
