"""SfM tools: known-pose triangulation, image registration into an
existing model, point filtering, colour extraction, pose-prior mapping.

Port of colmap_tpu/tools/sfm_tools.py (reference: RunPointTriangulator,
RunImageRegistrator, RunPointFiltering, RunColorExtractor,
RunPosePriorMapper in exe/sfm.cc; IncrementalPipeline::
TriangulateReconstruction, controllers/incremental_mapper.cc:559), built
on the port's IncrementalMapper on `device`. Two departures from the JAX
package: WGS84 priors (coordinate_system 1) convert to ENU in float64, and
the points-only BA after triangulation projects with the model's own
camera model.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from colmap_tpu_torch.estimators import bundle_adjustment as ba
from colmap_tpu_torch.geometry import rigid3
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.database_cache import DatabaseCache
from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.sensor import models as cm
from colmap_tpu_torch.sfm.incremental_mapper import (
    IncrementalMapper,
    IncrementalMapperOptions,
)

logger = logging.getLogger("colmap_tpu_torch")

# elements of one chunk's (points, track, track) angle table
_ANGLE_ELEMS = 1 << 24


def _mapper_with_poses(database: Database, rec: Reconstruction,
                       options: IncrementalMapperOptions, seed: int,
                       device, min_num_matches: int = 15
                       ) -> IncrementalMapper:
    """A mapper whose state mirrors an existing reconstruction."""
    cache = DatabaseCache.create(database, min_num_matches=min_num_matches,
                                 device=device)
    mapper = IncrementalMapper(cache, options, seed=seed, device=device)
    mapper.seed_from_model(rec)
    return mapper


def triangulate_points(database: Database, rec: Reconstruction,
                       refine: bool = True,
                       options: IncrementalMapperOptions = IncrementalMapperOptions(),
                       seed: int = 0, device="cuda") -> Reconstruction:
    """Triangulate all matches against KNOWN poses (reference:
    RunPointTriangulator / TriangulateReconstruction)."""
    mapper = _mapper_with_poses(database, rec, options, seed, device)
    n = mapper.triangulate_images(list(mapper.registered))
    logger.info("triangulated %d images: +%d observations",
                len(mapper.registered), n)
    if refine and mapper.num_points3D():
        # points-only global BA: every pose frozen
        problem, all_imgs, pids, cams = mapper._build_ba_problem(
            list(mapper.registered), fix_extra_images=True)
        if problem is not None:
            problem = problem._replace(
                pose_mask=torch.zeros_like(problem.pose_mask))
            model_id = mapper.rec.cameras[cams[0]].model_id
            state = ba.solve(problem, ba.BAOptions(
                max_iterations=10, camera_model_id=int(model_id)))
            mapper._apply_ba_result(state, all_imgs, pids, cams)
    mapper.filter_points()
    return mapper.finalize()


def register_images(database: Database, rec: Reconstruction,
                    options: IncrementalMapperOptions = IncrementalMapperOptions(),
                    seed: int = 0, device="cuda") -> Reconstruction:
    """Register the model's unregistered images against it WITHOUT
    changing the model (reference: RunImageRegistrator)."""
    mapper = _mapper_with_poses(database, rec, options, seed, device)
    todo = [iid for iid in sorted(mapper.rec.images)
            if not mapper.rec.images[iid].registered]
    if todo:
        accepted = mapper.register_next_images(todo)
        logger.info("registered %d of %d images", len(accepted), len(todo))
    return mapper.finalize()


def filter_points(rec: Reconstruction, max_reproj_error: float = 4.0,
                  min_tri_angle_deg: float = 1.5, device="cuda") -> int:
    """Standalone point filtering (reference: RunPointFiltering): a point
    goes when one of its registered observations lies behind the camera,
    when none is registered, when its largest reprojection error exceeds
    `max_reproj_error`, or when the largest angle between two of its
    viewing rays is below `min_tri_angle_deg`. All observations are tested
    at once on `device` (reprojection in float32, angles in float64).
    Returns the number of points deleted."""
    pids = list(rec.points3D)
    obs = [(k, iid, p2d) for k, pid in enumerate(pids)
           for (iid, p2d) in rec.points3D[pid].track
           if rec.images[iid].registered]
    P = len(pids)
    dead = np.zeros(P, bool)
    if obs:
        k_of, iids, p2ds = (np.array(c) for c in zip(*obs))
        cams = [rec.images[i].camera_id for i in iids]
        xyz = np.stack([rec.points3D[pid].xyz for pid in pids])

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        k_d = dev(k_of, torch.int64)
        poses = np.stack([rec.images[i].cam_from_world for i in iids])
        Xc = rigid3.apply(dev(poses), dev(xyz)[k_d])
        z = Xc[:, 2]
        xy = dev(np.stack([rec.images[i].xys[f]
                           for i, f in zip(iids, p2ds)]), torch.float64)
        err = torch.zeros(len(obs), dtype=torch.float64, device=device)
        models = np.array([rec.cameras[c].model_id for c in cams])
        for mid in np.unique(models):
            sel = dev(np.nonzero(models == mid)[0], torch.int64)
            params = dev(np.stack([rec.cameras[cams[i]].padded_params()
                                   for i in np.nonzero(models == mid)[0]]))
            proj = cm.img_from_cam(int(mid), params,
                                   Xc[sel, :2] / z[sel, None])
            err[sel] = torch.linalg.norm(proj.double() - xy[sel], dim=-1)
        zeros = torch.zeros(P, dtype=torch.float64, device=device)
        behind = zeros.index_add(0, k_d, (z <= 0).double()) > 0
        max_err = zeros.scatter_reduce(0, k_d, err, "amax",
                                       include_self=False)
        count = torch.bincount(k_d, minlength=P)
        bad = behind | (count == 0) | (max_err > max_reproj_error)

        # the largest pairwise angle between the viewing rays
        centers = np.stack([rec.images[i].projection_center() for i in iids])
        v = dev(centers, torch.float64) - dev(xyz, torch.float64)[k_d]
        # obs run in point order: an observation's slot in its track
        slot = torch.arange(len(obs), device=device) - torch.cumsum(
            torch.cat([count.new_zeros(1), count[:-1]]), 0)[k_d]
        T = int(count.max())
        rays = torch.zeros((P, T, 3), dtype=torch.float64, device=device)
        rays[k_d, slot] = v
        norms = torch.linalg.norm(rays, dim=-1)
        max_ang = torch.zeros(P, dtype=torch.float64, device=device)
        step = max(1, _ANGLE_ELEMS // max(1, T * T))
        pair = torch.triu(torch.ones(T, T, dtype=torch.bool, device=device),
                          1)
        live = torch.arange(T, device=device) < count[:, None]
        for a in range(0, P, step):
            r, n = rays[a:a + step], norms[a:a + step]
            cos = (r @ r.transpose(1, 2)) / torch.clamp(
                n[:, :, None] * n[:, None, :], min=1e-12)
            ang = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))
            lv = live[a:a + step]
            valid = pair & lv[:, :, None] & lv[:, None, :]
            ang = torch.where(valid, ang, torch.zeros_like(ang))
            max_ang[a:a + step] = ang.flatten(1).amax(1)
        narrow = (count >= 2) & (max_ang < min_tri_angle_deg)
        dead = (bad | narrow).cpu().numpy()
    else:
        dead[:] = True
    for k in np.nonzero(dead)[0]:
        rec.delete_point3D(pids[k])
    return int(dead.sum())


def extract_colors(rec: Reconstruction, image_dir: str) -> int:
    """Mean track colour per 3D point (reference: RunColorExtractor /
    Reconstruction::ExtractColorsForImage). Host code."""
    from colmap_tpu_torch.sensor import bitmap as bitmap_mod

    sums: Dict[int, np.ndarray] = {pid: np.zeros(3) for pid in rec.points3D}
    counts: Dict[int, int] = {pid: 0 for pid in rec.points3D}
    for iid, im in rec.images.items():
        if not im.registered:
            continue
        path = os.path.join(image_dir, im.name)
        if not os.path.exists(path):
            continue
        bmp = bitmap_mod.read_bitmap(path, as_rgb=True)
        h, w = bmp.data.shape[:2]
        for p2d, pid in enumerate(im.point3D_ids):
            if pid < 0:
                continue
            x, y = im.xys[p2d]
            xi = int(np.clip(round(x - 0.5), 0, w - 1))
            yi = int(np.clip(round(y - 0.5), 0, h - 1))
            sums[int(pid)] += bmp.data[yi, xi][:3]
            counts[int(pid)] += 1
    n = 0
    for pid, pt in rec.points3D.items():
        if counts[pid] > 0:
            pt.color = np.clip(sums[pid] / counts[pid], 0, 255).astype(
                np.uint8)
            n += 1
    return n


def prior_positions(database: Database) -> Dict[str, np.ndarray]:
    """Image name -> prior position in a Cartesian frame. Cartesian priors
    (coordinate_system 0) pass through; when any prior is WGS84
    (coordinate_system 1: latitude, longitude, altitude), every prior is
    converted to ENU about the first one, in float64."""
    from colmap_tpu_torch.geometry import gps

    priors = database.read_pose_priors()
    names = {iid: im["name"] for iid, im in database.read_images().items()}
    if any(pr.get("coordinate_system", 0) == 1 for pr in priors.values()):
        ids = sorted(priors)
        lla = np.stack([np.asarray(priors[i]["position"], np.float64)
                        for i in ids])
        enu = gps.ell_to_enu(torch.as_tensor(lla)).numpy()
        return {names[i]: enu[k] for k, i in enumerate(ids)}
    return {names[iid]: np.asarray(pr["position"], float)
            for iid, pr in priors.items()}


def run_pose_prior_mapper(database: Database, options=None, seed: int = 0,
                          device="cuda", stats: Optional[dict] = None
                          ) -> Optional[Reconstruction]:
    """Incremental mapping, then alignment to the position priors and a
    prior-constrained BA (reference: RunPosePriorMapper +
    PosePriorBundleAdjuster, exe/sfm.cc), on `device`. A dict `stats`
    receives the prior BA's LM iterations, CG steps and host syncs."""
    from colmap_tpu_torch.controllers.incremental_pipeline import (
        IncrementalPipeline, IncrementalPipelineOptions)
    from colmap_tpu_torch.estimators.pose_prior_ba import (
        PriorBAOptions, refine_with_priors)
    from colmap_tpu_torch.tools.model_tools import align_model_to_positions

    pipeline = IncrementalPipeline(
        database, options or IncrementalPipelineOptions(), device=device)
    rec = pipeline.run(seed=seed)
    if rec is None:
        return None
    positions = prior_positions(database)
    if positions:
        # the priors' spread sets the alignment tolerance
        spread = np.std(np.stack(list(positions.values())),
                        axis=0).mean() or 1.0
        aligned = align_model_to_positions(
            rec, positions, max_error=max(0.05 * spread, 1e-3),
            device=device)
        if aligned is not None:
            rec = aligned
            # the prior-constrained BA keeps the model in the prior frame
            name_to_id = {im.name: iid for iid, im in rec.images.items()}
            id_priors = {name_to_id[n]: p for n, p in positions.items()
                         if n in name_to_id}
            model_id = rec.cameras[sorted(rec.cameras)[0]].model_id
            refine_with_priors(
                rec, id_priors, sigma=max(0.02 * spread, 1e-3),
                options=PriorBAOptions(camera_model_id=int(model_id)),
                device=device, stats=stats)
    return rec
