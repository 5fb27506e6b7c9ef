"""Rig bundle adjustment over a reconstruction and a rig_config.json.

Port of colmap_tpu/tools/rig_tools.py (reference: RunRigBundleAdjuster,
exe/sfm.cc): reads COLMAP's rig configuration, groups the images into
snapshots by the name that follows each camera's prefix, and runs the
rig-constrained BA (estimators/rig_bundle_adjustment.py) on `device`.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional

import numpy as np

from colmap_tpu_torch.estimators import rig_bundle_adjustment as rba
from colmap_tpu_torch.geometry import rigid3
from colmap_tpu_torch.scene.camera_rig import CameraRig
from colmap_tpu_torch.scene.reconstruction import Reconstruction

logger = logging.getLogger("colmap_tpu_torch")


def load_rig_config(path: str, rec: Reconstruction) -> List[CameraRig]:
    """Parse COLMAP's rig_config.json into CameraRigs with snapshots
    grouped by the image-name suffix after each camera's prefix."""
    with open(path) as fp:
        config = json.load(fp)
    rigs = []
    for rig_cfg in config:
        rig = CameraRig()
        prefixes: Dict[int, str] = {}
        for cam_cfg in rig_cfg["cameras"]:
            cid = int(cam_cfg["camera_id"])
            q = np.asarray(cam_cfg.get("cam_from_rig_rotation", [1, 0, 0, 0]),
                           float)
            t = np.asarray(cam_cfg.get("cam_from_rig_translation", [0, 0, 0]),
                           float)
            rig.add_camera(cid, np.concatenate([q, t]))
            prefixes[cid] = cam_cfg.get("image_prefix", "")
        rig.ref_camera_id = int(rig_cfg.get("ref_camera_id",
                                            rig.ref_camera_id))
        # snapshots: images grouped by the name remainder after the prefix
        groups: Dict[str, List[int]] = {}
        for iid, im in rec.images.items():
            if im.camera_id not in prefixes:
                continue
            prefix = prefixes[im.camera_id]
            if prefix and not im.name.startswith(prefix):
                continue
            groups.setdefault(im.name[len(prefix):], []).append(iid)
        for suffix in sorted(groups):
            rig.add_snapshot(groups[suffix])
        rigs.append(rig)
    return rigs


def run_rig_bundle_adjustment(rec: Reconstruction, rig_config_path: str,
                              refine_relative_poses: bool = True,
                              max_iterations: int = 30, device="cuda",
                              stats: Optional[dict] = None) -> Reconstruction:
    """Rig BA of every rig in the configuration, in place on `rec`. A dict
    `stats` receives the last solve's LM iterations, CG steps and host
    syncs."""
    for rig in load_rig_config(rig_config_path, rec):
        _adjust_one_rig(rec, rig, refine_relative_poses, max_iterations,
                        device, stats)
    return rec


def _adjust_one_rig(rec: Reconstruction, rig: CameraRig,
                    refine_relative_poses: bool, max_iterations: int,
                    device, stats: Optional[dict]):
    cam_ids = sorted(rig.cams_from_rig.keys())
    # the reference camera first: its extrinsics are the gauge
    cam_ids.remove(rig.ref_camera_id)
    cam_ids.insert(0, rig.ref_camera_id)
    cam_pos = {cid: k for k, cid in enumerate(cam_ids)}

    snapshots = [s for s in rig.snapshots
                 if any(rec.images[i].registered for i in s)]
    if not snapshots:
        logger.warning("rig has no registered snapshots")
        return
    rig_poses = np.stack([
        rig.compute_rig_from_world(rig.snapshots.index(s), rec)
        for s in snapshots]).astype(np.float32)
    cams_from_rig = np.stack([rig.cams_from_rig[c]
                              for c in cam_ids]).astype(np.float32)

    # the observations of the points that the rig's images see
    img_to_snap = {iid: si for si, s in enumerate(snapshots) for iid in s}
    pids = sorted({int(pid) for iid in img_to_snap
                   for pid in rec.images[iid].point3D_ids if pid >= 0})
    if not pids:
        return
    pid_pos = {pid: k for k, pid in enumerate(pids)}
    obs_s, obs_c, obs_p, obs_xy = [], [], [], []
    for pid in pids:
        for (iid, f) in rec.points3D[pid].track:
            if iid not in img_to_snap:
                continue
            obs_s.append(img_to_snap[iid])
            obs_c.append(cam_pos[rec.images[iid].camera_id])
            obs_p.append(pid_pos[pid])
            obs_xy.append(rec.images[iid].xys[f])
    points = np.stack([rec.points3D[p].xyz for p in pids]).astype(np.float32)
    cam_params = np.stack([rec.cameras[c].padded_params() for c in cam_ids])
    model_id = rec.cameras[cam_ids[0]].model_id

    problem = rba.make_rig_problem(
        rig_poses, cams_from_rig, cam_params.astype(np.float32), points,
        np.array(obs_s), np.array(obs_c), np.array(obs_p),
        np.stack(obs_xy).astype(np.float32), device=device)
    opts = rba.RigBAOptions(max_iterations=max_iterations,
                            camera_model_id=int(model_id),
                            refine_relative_poses=refine_relative_poses)
    solved, cost = rba.solve_rig(problem, opts, stats=stats)
    logger.info("rig BA final cost %.3f", float(cost))

    # write back: image poses = cam_from_rig o rig_from_world, composed in
    # float32 as the JAX package composes them
    new_rig = solved.rig_poses.cpu()
    new_cams = solved.cams_from_rig.cpu()
    for k, cid in enumerate(cam_ids):
        rig.cams_from_rig[cid] = new_cams[k].numpy().astype(np.float64)
    for si, s in enumerate(snapshots):
        for iid in s:
            cid = rec.images[iid].camera_id
            pose = rigid3.compose(new_cams[cam_pos[cid]], new_rig[si])
            rec.images[iid].cam_from_world = pose.numpy().astype(np.float64)
    new_points = solved.points.cpu().numpy().astype(np.float64)
    for pid, k in pid_pos.items():
        rec.points3D[pid].xyz = new_points[k]
