"""pycolmap-parity Python API.

Port of colmap_tpu/api.py (reference: src/pycolmap/main.cc:44-52 and the
pipeline bindings — extract_features, match_exhaustive / match_sequential /
match_spatial / match_vocabtree, verify_matches (pipeline/sfm.cc),
incremental_mapping (:116), triangulate_points (:103), bundle_adjustment
(:129), patch_match_stereo (pipeline/mvs.cc:173), stereo_fusion (:235),
poisson_meshing / delaunay_meshing (pipeline/meshing.cc:119-146),
import_images / undistort_images (pipeline/images.cc:228-243)).

Every function has the JAX package's name and arguments, and those that
run device work take `device` (the card unless the caller asks for
another). The estimator bindings take numpy and return numpy, and draw
from a torch.Generator seeded from `seed`:

    import colmap_tpu_torch.api as pycolmap
    pycolmap.extract_features(database_path, image_path)
    pycolmap.match_exhaustive(database_path)
    maps = pycolmap.incremental_mapping(database_path, image_path, output_path)
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.reconstruction import Reconstruction


def extract_features(database_path: str, image_path: str,
                     image_names: Optional[List[str]] = None,
                     camera_model: str = "SIMPLE_RADIAL",
                     camera_params: str = "",
                     single_camera: bool = False,
                     sift_options=None, device="cuda") -> None:
    """reference: pycolmap.extract_features."""
    from colmap_tpu_torch.controllers import feature_extraction as fe
    from colmap_tpu_torch.features.sift import SiftExtractionOptions

    with Database(database_path) as db:
        fe.run_feature_extraction(
            db, image_path,
            fe.ImageReaderOptions(camera_model=camera_model,
                                  camera_params=camera_params,
                                  single_camera=single_camera),
            sift_options or SiftExtractionOptions(),
            image_names=image_names, device=device)


def import_images(database_path: str, image_path: str,
                  camera_model: str = "SIMPLE_RADIAL",
                  image_names: Optional[List[str]] = None) -> None:
    """Register image + camera rows without features (host only;
    reference: pycolmap.import_images)."""
    from colmap_tpu_torch.controllers.feature_extraction import (
        ImageReaderOptions, _infer_camera)
    from colmap_tpu_torch.sensor import bitmap as bitmap_mod
    from colmap_tpu_torch.sensor import models as camera_models

    reader = ImageReaderOptions(camera_model=camera_model)
    with Database(database_path) as db:
        existing = {im["name"] for im in db.read_images().values()}
        for name in image_names or bitmap_mod.list_image_files(image_path):
            if name in existing:
                continue
            bmp = bitmap_mod.read_bitmap(os.path.join(image_path, name))
            params, _ = _infer_camera(reader, bmp)
            model_id = camera_models.MODEL_IDS_BY_NAME[camera_model]
            cid = db.write_camera(int(model_id), bmp.width, bmp.height,
                                  np.asarray(params))
            db.write_image(name, cid)
        db.commit()


def _match(database_path: str, strategy: str, device, **kw):
    from colmap_tpu_torch.controllers import feature_matching as fm

    with Database(database_path) as db:
        opts = kw.pop("options", None) or fm.FeatureMatchingOptions()
        if strategy == "exhaustive":
            return fm.match_exhaustive(db, opts, device=device)
        if strategy == "sequential":
            return fm.match_sequential(db, opts, device=device)
        if strategy == "spatial":
            return fm.match_spatial(db, opts, device=device)
        if strategy == "vocabtree":
            return fm.match_vocab_tree(db, opts, device=device, **kw)
        raise ValueError(strategy)


def match_exhaustive(database_path: str, options=None, device="cuda"):
    return _match(database_path, "exhaustive", device, options=options)


def match_sequential(database_path: str, options=None, device="cuda"):
    return _match(database_path, "sequential", device, options=options)


def match_spatial(database_path: str, options=None, device="cuda"):
    return _match(database_path, "spatial", device, options=options)


def match_vocabtree(database_path: str, vocab_tree_path: Optional[str] = None,
                    options=None, device="cuda"):
    return _match(database_path, "vocabtree", device, options=options,
                  vocab_tree_path=vocab_tree_path)


def verify_matches(database_path: str, pairs_path: Optional[str] = None,
                   options=None, device="cuda"):
    """Re-verify the pairs that have raw matches in the database
    (reference: pycolmap.verify_matches)."""
    from colmap_tpu_torch.controllers import feature_matching as fm
    from colmap_tpu_torch.scene.database import pair_id_to_image_pair

    with Database(database_path) as db:
        pairs = [pair_id_to_image_pair(pid) for (pid,) in
                 db.conn.execute("SELECT pair_id FROM matches")]
        return fm.match_and_verify_blocks(
            db, fm._chunk(pairs, 32), options or fm.FeatureMatchingOptions(),
            device=device)


def incremental_mapping(database_path: str, image_path: str,
                        output_path: Optional[str] = None,
                        options=None, seed: int = 0, device="cuda"
                        ) -> Dict[int, Reconstruction]:
    """reference: pycolmap.incremental_mapping (pipeline/sfm.cc:116)."""
    from colmap_tpu_torch.controllers.incremental_pipeline import (
        IncrementalPipeline, IncrementalPipelineOptions)
    from colmap_tpu_torch.scene import reconstruction_io

    with Database(database_path) as db:
        rec = IncrementalPipeline(
            db, options or IncrementalPipelineOptions(),
            device=device).run(seed=seed)
    maps: Dict[int, Reconstruction] = {}
    if rec is not None:
        maps[0] = rec
        if output_path:
            out = os.path.join(output_path, "0")
            os.makedirs(out, exist_ok=True)
            reconstruction_io.write_model(rec, out, ext=".bin")
    return maps


def triangulate_points(reconstruction: Reconstruction, database_path: str,
                       image_path: str = "",
                       output_path: Optional[str] = None,
                       refine_intrinsics: bool = False,
                       device="cuda") -> Reconstruction:
    """reference: pycolmap.triangulate_points (pipeline/sfm.cc:103)."""
    from colmap_tpu_torch.scene import reconstruction_io
    from colmap_tpu_torch.tools import sfm_tools

    with Database(database_path) as db:
        rec = sfm_tools.triangulate_points(db, reconstruction, device=device)
    if output_path:
        os.makedirs(output_path, exist_ok=True)
        reconstruction_io.write_model(rec, output_path, ext=".bin")
    return rec


def bundle_adjustment(reconstruction: Reconstruction, options=None,
                      device="cuda") -> Reconstruction:
    """Standalone global BA of a reconstruction on its own tracks, no
    database needed (reference: pycolmap.bundle_adjustment,
    pipeline/sfm.cc:129). Poses and points are refined in place; the
    default options project with the first camera's model (the JAX
    package's default projects SIMPLE_RADIAL whatever the model)."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba

    rec = reconstruction
    reg = rec.registered_image_ids()
    if len(reg) < 2 or not rec.points3D:
        return rec
    img_index = {iid: k for k, iid in enumerate(reg)}
    pids = sorted(rec.points3D.keys())
    pid_index = {pid: k for k, pid in enumerate(pids)}
    cams = sorted(rec.cameras.keys())
    cam_index = {cid: k for k, cid in enumerate(cams)}
    obs_pose, obs_cam, obs_pt, obs_xy = [], [], [], []
    for pid in pids:
        for (iid, f) in rec.points3D[pid].track:
            if iid not in img_index:
                continue
            obs_pose.append(img_index[iid])
            obs_cam.append(cam_index[rec.images[iid].camera_id])
            obs_pt.append(pid_index[pid])
            obs_xy.append(rec.images[iid].xys[f])
    poses = np.stack([rec.images[i].cam_from_world for i in reg])
    points = np.stack([rec.points3D[p].xyz for p in pids])
    cam_params = np.stack([rec.cameras[c].padded_params() for c in cams])
    problem = ba.make_problem(
        poses.astype(np.float32), cam_params.astype(np.float32),
        points.astype(np.float32), np.array(obs_pose, np.int64),
        np.array(obs_cam, np.int64), np.array(obs_pt, np.int64),
        np.stack(obs_xy).astype(np.float32), device=device)
    options = options or ba.BAOptions(
        max_iterations=20, camera_model_id=int(rec.cameras[cams[0]].model_id))
    state = ba.solve(problem, options)
    new_poses = state.problem.poses.cpu().numpy().astype(np.float64)
    new_points = state.problem.points.cpu().numpy().astype(np.float64)
    for iid, k in img_index.items():
        rec.images[iid].cam_from_world = new_poses[k]
    for pid, k in pid_index.items():
        rec.points3D[pid].xyz = new_points[k]
    return rec


def undistort_images(output_path: str, input_path: str, image_path: str,
                     options=None, device="cuda") -> None:
    """reference: pycolmap.undistort_images (pipeline/images.cc:243)."""
    from colmap_tpu_torch.image import undistortion as und
    from colmap_tpu_torch.scene import reconstruction_io

    rec = reconstruction_io.read_model(input_path)
    und.run_undistorter(rec, image_path, output_path,
                        options or und.UndistortCameraOptions(),
                        device=device)


def patch_match_stereo(workspace_path: str, options=None,
                       device="cuda") -> None:
    """reference: pycolmap.patch_match_stereo (pipeline/mvs.cc:173)."""
    from colmap_tpu_torch.controllers import dense_reconstruction as dense

    dense.run_patch_match_stereo(
        workspace_path, options or dense.PatchMatchStereoOptions(),
        device=device)


def stereo_fusion(output_path: str, workspace_path: str, options=None,
                  device="cuda"):
    """reference: pycolmap.stereo_fusion (pipeline/mvs.cc:235)."""
    from colmap_tpu_torch.controllers import dense_reconstruction as dense
    from colmap_tpu_torch.mvs.fusion import StereoFusionOptions

    return dense.run_stereo_fusion(workspace_path,
                                   options or StereoFusionOptions(),
                                   output_path=output_path, device=device)


def poisson_meshing(input_path: str, output_path: str, options=None,
                    device="cuda"):
    """reference: pycolmap.poisson_meshing (pipeline/meshing.cc:119)."""
    from colmap_tpu_torch.controllers import dense_reconstruction as dense
    from colmap_tpu_torch.mvs.meshing import PoissonMeshingOptions

    return dense.run_poisson_mesher(input_path, output_path,
                                    options or PoissonMeshingOptions(),
                                    device=device)


def delaunay_meshing(workspace_path: str, output_path: str):
    """Host only (reference: pycolmap.delaunay_meshing,
    pipeline/meshing.cc:146)."""
    from colmap_tpu_torch.controllers import dense_reconstruction as dense

    return dense.run_delaunay_mesher(workspace_path, output_path)


# ---------------------------------------------------------------------------
# Estimator bindings (reference: pycolmap estimators/*.cc)
# ---------------------------------------------------------------------------


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _rays(camera, xy: np.ndarray, device) -> torch.Tensor:
    from colmap_tpu_torch.sensor import models as cm

    return cm.cam_from_img(
        camera.model_id,
        torch.as_tensor(camera.padded_params(), device=device),
        torch.as_tensor(np.asarray(xy, np.float32), device=device))


def absolute_pose_estimation(points2D, points3D, camera,
                             max_error_px: float = 12.0, seed: int = 0,
                             device="cuda"):
    """P3P LO-RANSAC with GN refits (reference:
    pycolmap.absolute_pose_estimation).

    points2D: (N, 2) pixels; camera: scene.reconstruction.Camera.
    Returns dict(success, cam_from_world (7,), num_inliers, inlier_mask).
    """
    from colmap_tpu_torch.estimators import absolute_pose as ap
    from colmap_tpu_torch.optim.ransac import RansacOptions, ransac

    X = torch.as_tensor(np.asarray(points3D, np.float32), device=device)
    rays = _rays(camera, points2D, device)
    err = max_error_px / camera.mean_focal_length()
    scale = 1.0 / max(err, 1e-12) ** 2

    def scaled(model, data):
        return ap.reprojection_residuals(model, data) * scale

    res = ransac(_generator(seed, device), ap.solve_p3p, scaled, ap.refit,
                 (X[None], rays[None]),
                 torch.ones((1, len(X)), dtype=torch.bool, device=device), 3,
                 RansacOptions(num_samples=1024, lo_iterations=2,
                               max_error=1.0))
    return dict(success=bool(res.success[0]),
                cam_from_world=res.model[0].cpu().numpy().astype(np.float64),
                num_inliers=int(res.num_inliers[0]),
                inlier_mask=res.inlier_mask[0].cpu().numpy())


def essential_matrix_estimation(points1, points2, camera1, camera2,
                                max_error_px: float = 4.0, seed: int = 0,
                                device="cuda"):
    """reference: pycolmap.essential_matrix_estimation."""
    return _two_view(points1, points2, camera1, camera2, max_error_px, seed,
                     "E", device)


def fundamental_matrix_estimation(points1, points2, max_error_px: float = 4.0,
                                  seed: int = 0, device="cuda"):
    """reference: pycolmap.fundamental_matrix_estimation."""
    return _two_view(points1, points2, None, None, max_error_px, seed, "F",
                     device)


def homography_matrix_estimation(points1, points2, max_error_px: float = 4.0,
                                 seed: int = 0, device="cuda"):
    """reference: pycolmap.homography_matrix_estimation."""
    return _two_view(points1, points2, None, None, max_error_px, seed, "H",
                     device)


def _two_view(points1, points2, camera1, camera2, max_error_px, seed, want,
              device):
    from colmap_tpu_torch.estimators import two_view_geometry as tvg

    p1 = torch.as_tensor(np.asarray(points1, np.float32), device=device)
    p2 = torch.as_tensor(np.asarray(points2, np.float32), device=device)
    if camera1 is not None:
        r1 = _rays(camera1, points1, device)
        r2 = _rays(camera2, points2, device)
        focal = np.sqrt(camera1.mean_focal_length()
                        * camera2.mean_focal_length())
    else:
        r1, r2 = p1, p2
        focal = 1.0
    opts = tvg.TwoViewGeometryOptions(max_error_px=max_error_px,
                                      compute_relative_pose=(want == "E"))
    g = tvg.estimate_two_view_geometry(
        _generator(seed, device), r1[None], r2[None], p1[None], p2[None],
        torch.ones((1, len(p1)), dtype=torch.bool, device=device),
        torch.tensor([focal], dtype=torch.float32, device=device), opts)
    g = tvg.TwoViewGeometry(*(x[0].cpu().numpy() for x in g))
    out = dict(success=int(g.num_inliers) >= opts.min_num_inliers,
               num_inliers=int(g.num_inliers),
               inlier_mask=g.inlier_mask,
               config=int(g.config))
    out["E"] = g.E.astype(np.float64)
    out["F"] = g.F.astype(np.float64)
    out["H"] = g.H.astype(np.float64)
    if want == "E":
        out["cam2_from_cam1"] = g.cam2_from_cam1.astype(np.float64)
    return out


def rig_absolute_pose_estimation(points2D, points3D, cam_idx, cams_from_rig,
                                 cameras, max_error_px: float = 12.0,
                                 seed: int = 0, device="cuda"):
    """Generalized (rig) absolute pose (reference:
    pycolmap.rig_absolute_pose_estimation). Each observation's rays come
    from its own camera's model; the cameras' rows are grouped by camera."""
    from colmap_tpu_torch.estimators import generalized_pose as gp
    from colmap_tpu_torch.optim.ransac import RansacOptions

    xy = np.asarray(points2D, np.float32)
    cam_idx = np.asarray(cam_idx, np.int64)
    rays = torch.zeros((len(xy), 2), dtype=torch.float32, device=device)
    f_mean = np.mean([c.mean_focal_length() for c in cameras])
    for k, cam in enumerate(cameras):
        m = np.nonzero(cam_idx == k)[0]
        if len(m):
            rays[torch.as_tensor(m, device=device)] = _rays(cam, xy[m],
                                                            device)
    res = gp.estimate_generalized_absolute_pose(
        _generator(seed, device),
        torch.as_tensor(np.asarray(points3D, np.float32), device=device),
        rays, torch.as_tensor(cam_idx, device=device),
        torch.as_tensor(np.asarray(cams_from_rig, np.float32), device=device),
        torch.ones(len(xy), dtype=torch.bool, device=device),
        options=RansacOptions(num_samples=2048, lo_iterations=2,
                              max_error=max_error_px / f_mean))
    return dict(success=bool(res.success),
                rig_from_world=res.rig_from_world.cpu().numpy().astype(
                    np.float64),
                num_inliers=int(res.num_inliers),
                inlier_mask=res.inlier_mask.cpu().numpy())


def align_reconstructions(src: Reconstruction, dst: Reconstruction,
                          max_error: float = 0.1, device="cuda"):
    """Robust Sim3 aligning src to dst via common images (falling back to
    common 3D points). Returns the (8,) Sim3 or None.

    Reference: pycolmap align_reconstructions / estimators/alignment.h.
    """
    from colmap_tpu_torch.estimators.alignment import (
        align_reconstructions_robust)

    return align_reconstructions_robust(src, dst, max_error=max_error,
                                        device=device)


def merge_reconstructions(dst: Reconstruction, src: Reconstruction,
                          max_proj_center_error: float = 0.1,
                          device="cuda") -> bool:
    """Merge src into dst in place (reference: MergeReconstructions)."""
    from colmap_tpu_torch.estimators.alignment import (
        merge_reconstructions as _merge)

    return _merge(dst, src, max_proj_center_error=max_proj_center_error,
                  device=device)


def optimize_sim3_pose_graph(initial, edges, measurements, weights=None,
                             num_iters: int = 20, device="cuda"):
    """Joint Sim3 pose-graph refinement (loop closure for cluster merging;
    see estimators/pose_graph.py)."""
    from colmap_tpu_torch.estimators.pose_graph import (
        optimize_sim3_pose_graph as _opt)

    return _opt(initial, edges, measurements, weights, num_iters=num_iters,
                device=device)
