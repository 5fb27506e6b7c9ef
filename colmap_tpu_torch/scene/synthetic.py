"""Synthetic scene generator: a ground-truth model and its match database.

Port of colmap_tpu/scene/synthetic.py (reference: scene/synthetic.h:38-68,
synthetic.cc): points uniform in a unit cube, cameras on a circle of radius
3 looking at the origin, projected keypoints with optional noise, clutter,
outlier matches and pose priors, exhaustive or chained matches stored as
verified two-view geometries. It draws from `np.random.default_rng(seed)`
in the JAX package's order, and does the JAX package's float32 geometry
(rotation to quaternion, the rigid transform, the camera model) in float32
torch on the CPU, so on the same options both packages write the same
database up to the last bits of a keypoint.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from colmap_tpu_torch.geometry import rigid3, rotation as rot
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.reconstruction import Camera, Image, Reconstruction
from colmap_tpu_torch.sensor import models as camera_models


class MatchConfig(enum.IntEnum):
    EXHAUSTIVE = 1
    CHAINED = 2


@dataclasses.dataclass
class SyntheticDatasetOptions:
    num_rigs: int = 1  # kept for API parity
    num_cameras: int = 2
    num_images: int = 10
    num_points3D: int = 100
    camera_width: int = 1024
    camera_height: int = 768
    camera_model_id: int = int(camera_models.CameraModelId.SIMPLE_RADIAL)
    camera_params: Optional[list] = None
    num_points2D_without_point3D: int = 10
    point2D_stddev: float = 0.0
    inlier_match_ratio: float = 1.0
    match_config: MatchConfig = MatchConfig.EXHAUSTIVE
    # CHAINED: match (i, i + k) for k <= match_overlap
    match_overlap: int = 1
    # 0: every point visible from every camera. > 0: each point is anchored
    # to a camera-circle position and seen only by the nearest
    # `point_visibility_images` cameras (local co-visibility, as in a
    # walk-around capture)
    point_visibility_images: int = 0
    use_prior_position: bool = False
    prior_position_stddev: float = 1.5
    seed: int = 42


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def synthesize_dataset(options: SyntheticDatasetOptions,
                       database: Optional[Database] = None) -> Reconstruction:
    """Generate the ground-truth model (and fill `database` if given)."""
    rng = np.random.default_rng(options.seed)
    rec = Reconstruction()

    if options.camera_params is None:
        focal = 1.2 * max(options.camera_width, options.camera_height)
        params = camera_models.default_params(
            options.camera_model_id, focal, options.camera_width,
            options.camera_height)
        n = camera_models.NUM_PARAMS[
            camera_models.CameraModelId(options.camera_model_id)]
        params = np.asarray(params[:n], dtype=np.float64)
    else:
        params = np.asarray(options.camera_params, dtype=np.float64)

    camera_ids = []
    for i in range(options.num_cameras):
        cid = i + 1
        rec.add_camera(Camera(camera_id=cid, model_id=options.camera_model_id,
                              width=options.camera_width,
                              height=options.camera_height,
                              params=params.copy()))
        if database is not None:
            db_cid = database.write_camera(
                options.camera_model_id, options.camera_width,
                options.camera_height, params, prior_focal_length=True,
                camera_id=cid)
            assert db_cid == cid
        camera_ids.append(cid)

    points3D = rng.uniform(-0.5, 0.5, size=(options.num_points3D, 3))

    poses = []
    for i in range(options.num_images):
        angle = 2.0 * np.pi * i / options.num_images
        center = np.array([3.0 * np.cos(angle), 0.3 * rng.standard_normal(),
                           3.0 * np.sin(angle)])
        # look-at rotation: z axis towards the origin
        z = -center / np.linalg.norm(center)
        x = np.cross(np.array([0.0, -1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_cam_from_world = np.stack([x, y, z], axis=1).T
        t = -R_cam_from_world @ center
        q = rot.rotmat_to_quat(_f32(R_cam_from_world)).numpy()
        poses.append(np.concatenate([q, t]))

    all_tracks = {j: [] for j in range(options.num_points3D)}
    image_obs = {}
    if options.point_visibility_images > 0:
        # drawn only when the option is on, so the default stream is the
        # JAX package's default stream
        point_anchor = rng.integers(0, options.num_images,
                                    size=options.num_points3D)
    points_f32 = _f32(points3D)
    for i in range(options.num_images):
        iid = i + 1
        cid = camera_ids[i % len(camera_ids)]
        cam = rec.cameras[cid]
        p_cam = rigid3.apply(_f32(poses[i]), points_f32).numpy()
        in_front = p_cam[:, 2] > 0.1
        uv = p_cam[:, :2] / p_cam[:, 2:]
        xy = camera_models.img_from_cam(
            cam.model_id, _f32(cam.padded_params()),
            _f32(uv)).numpy().astype(np.float64)
        if options.point2D_stddev > 0:
            xy = xy + rng.normal(0, options.point2D_stddev, size=xy.shape)
        in_img = (in_front & (xy[:, 0] >= 0) & (xy[:, 0] < cam.width)
                  & (xy[:, 1] >= 0) & (xy[:, 1] < cam.height))
        if options.point_visibility_images > 0:
            d = np.abs(point_anchor - i)
            d = np.minimum(d, options.num_images - d)  # circular distance
            in_img &= d <= options.point_visibility_images // 2
        vis_idx = np.nonzero(in_img)[0]
        # keypoints: the visible points, then random clutter, shuffled
        clutter = rng.uniform([0, 0], [cam.width, cam.height],
                              size=(options.num_points2D_without_point3D, 2))
        xys = np.concatenate([xy[vis_idx], clutter], axis=0)
        perm = rng.permutation(len(xys))
        inv_perm = np.argsort(perm)
        xys = xys[perm]
        p3d_ids = np.full(len(xys), -1, dtype=np.int64)
        for k, j in enumerate(vis_idx):
            p2d_idx = int(inv_perm[k])
            p3d_ids[p2d_idx] = j  # the ground-truth point index
            all_tracks[j].append((iid, p2d_idx))
        image_obs[iid] = (xys, p3d_ids)
        name = f"image{iid:06d}.png"
        rec.add_image(Image(image_id=iid, name=name, camera_id=cid,
                            cam_from_world=poses[i].astype(np.float64),
                            xys=xys,
                            point3D_ids=np.full(len(xys), -1, dtype=np.int64)))
        if database is not None:
            db_iid = database.write_image(name, cid, image_id=iid)
            assert db_iid == iid
            database.write_keypoints(iid, xys.astype(np.float32))
            # random descriptors (geometry never reads them)
            desc = rng.integers(0, 256, size=(len(xys), 128), dtype=np.uint8)
            database.write_descriptors(iid, desc)
            if options.use_prior_position:
                center = rigid3.projection_center(
                    _f32(poses[i])).numpy().astype(np.float64)
                noisy = center + rng.normal(0, options.prior_position_stddev,
                                            3)
                database.write_pose_prior(iid, noisy, coordinate_system=1)

    for j in range(options.num_points3D):
        if len(all_tracks[j]) >= 2:
            rec.add_point3D(points3D[j], all_tracks[j],
                            color=rng.integers(0, 256, 3))

    # matches: feature index pairs of co-visible ground-truth points
    if database is not None:
        num_img = options.num_images
        if options.match_config == MatchConfig.EXHAUSTIVE:
            pairs = [(a + 1, b + 1) for a in range(num_img)
                     for b in range(a + 1, num_img)]
        else:
            pairs = [(i + 1, i + 1 + k)
                     for k in range(1, options.match_overlap + 1)
                     for i in range(num_img - k)]
        for iid1, iid2 in pairs:
            _, ids1 = image_obs[iid1]
            xys2, ids2 = image_obs[iid2]
            idx1_by_pt = {int(p): k for k, p in enumerate(ids1) if p >= 0}
            matches = [(idx1_by_pt[int(p)], k2) for k2, p in enumerate(ids2)
                       if p >= 0 and int(p) in idx1_by_pt]
            matches = np.array(matches, dtype=np.uint32).reshape(-1, 2)
            # corrupt a fraction into outliers
            n_out = int(round((1.0 - options.inlier_match_ratio)
                              * len(matches)))
            if n_out > 0:
                which = rng.choice(len(matches), size=n_out, replace=False)
                matches[which, 1] = rng.integers(0, len(xys2), size=n_out)
            database.write_matches(iid1, iid2, matches)
            # stored as verified (CALIBRATED) geometries: the mapper's
            # cache reads only verified pairs
            database.write_two_view_geometry(iid1, iid2, matches, config=2)
        database.commit()

    return rec
