"""Image + reconstruction undistortion.

Port of colmap_tpu/image/undistortion.py (reference:
src/colmap/image/undistortion.h:40-119, UndistortCameraOptions,
UndistortCamera, UndistortImage, COLMAPUndistorter, and the PMVS / CMP-MVS
exporters). Produces the pinhole workspace consumed by MVS: undistorted
images + a transformed reconstruction whose cameras are PINHOLE. The
camera-model projections and the image warps run as torch ops on `device`;
the file layouts are the JAX module's.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from colmap_tpu_torch.geometry import rotation
from colmap_tpu_torch.image import warp as warp_mod
from colmap_tpu_torch.scene import reconstruction_io
from colmap_tpu_torch.scene.reconstruction import Camera, Reconstruction
from colmap_tpu_torch.sensor import bitmap as bitmap_mod
from colmap_tpu_torch.sensor import models as cm


@dataclasses.dataclass
class UndistortCameraOptions:
    """Reference: UndistortCameraOptions (image/undistortion.h:40)."""

    blank_pixels: float = 0.0  # 0 => no blank pixels (crop), 1 => keep all
    min_scale: float = 0.2
    max_scale: float = 2.0
    max_image_size: int = -1
    roi_min_x: float = 0.0
    roi_min_y: float = 0.0
    roi_max_x: float = 1.0
    roi_max_y: float = 1.0


def _params(camera: Camera, device) -> torch.Tensor:
    return torch.as_tensor(camera.padded_params(), device=device)


def undistort_camera(options: UndistortCameraOptions, camera: Camera,
                     device="cuda") -> Camera:
    """Compute the undistorted PINHOLE camera.

    Reference: UndistortCamera (undistortion.cc): scales the pinhole frame
    so the blank-pixel policy holds along the image borders, found by
    unprojecting 50 points on each border through the distorted model.
    """
    mid = camera.model_id
    i_fx, i_fy, _, _ = cm._FXFY_CXCY[cm.CameraModelId(mid)]
    fx = float(camera.params[i_fx])
    fy = float(camera.params[i_fy])
    w, h = camera.width, camera.height
    ucam = Camera(camera_id=camera.camera_id,
                  model_id=int(cm.CameraModelId.PINHOLE),
                  width=w, height=h,
                  params=np.array([fx, fy, w / 2.0, h / 2.0], np.float64))

    nb = 50
    xs = np.linspace(0.5, w - 0.5, nb)
    ys = np.linspace(0.5, h - 0.5, nb)
    border = np.concatenate([
        np.stack([xs, np.full(nb, 0.5)], -1),
        np.stack([xs, np.full(nb, h - 0.5)], -1),
        np.stack([np.full(nb, 0.5), ys], -1),
        np.stack([np.full(nb, w - 0.5), ys], -1),
    ]).astype(np.float32)
    uv = cm.cam_from_img(mid, _params(camera, device),
                         torch.as_tensor(border, device=device)).cpu().numpy()

    cx, cy = w / 2.0, h / 2.0
    # scale factors that map undistorted rays back inside the image
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = np.abs((border[:, 0] - cx) / (fx * uv[:, 0]))
        sy = np.abs((border[:, 1] - cy) / (fy * uv[:, 1]))
    s = np.concatenate([sx[np.isfinite(sx)], sy[np.isfinite(sy)]])
    if len(s) == 0:
        return ucam
    # blank_pixels=0 -> shrink to min scale (no blank), 1 -> grow to max
    smin, smax = float(np.min(s)), float(np.max(s))
    scale = smin + options.blank_pixels * (smax - smin)
    scale = float(np.clip(scale, options.min_scale, options.max_scale))
    new_params = np.array([fx * scale, fy * scale, cx, cy], np.float64)

    if options.max_image_size > 0 and max(w, h) > options.max_image_size:
        r = options.max_image_size / max(w, h)
        ucam.width = int(round(w * r))
        ucam.height = int(round(h * r))
        new_params[:2] *= r
        new_params[2] = ucam.width / 2.0
        new_params[3] = ucam.height / 2.0
    ucam.params = new_params
    return ucam


def undistort_image(options: UndistortCameraOptions, image: np.ndarray,
                    camera: Camera, ucam: Optional[Camera] = None,
                    device="cuda") -> Tuple[np.ndarray, Camera]:
    """Undistort one image; returns (undistorted image, pinhole camera)."""
    if ucam is None:
        ucam = undistort_camera(options, camera, device=device)
    out = warp_mod.warp_between_cameras(
        torch.as_tensor(np.asarray(image, np.float32), device=device),
        camera.model_id, _params(camera, device),
        ucam.model_id, _params(ucam, device), (ucam.height, ucam.width))
    return out.cpu().numpy(), ucam


def undistort_reconstruction(options: UndistortCameraOptions,
                             rec: Reconstruction,
                             device="cuda") -> Reconstruction:
    """Transform a reconstruction to undistorted PINHOLE cameras.

    Reference: COLMAPUndistorter rewriting sparse/ (undistortion.cc). The
    2D observations are re-projected into the undistorted frame.
    """
    out = copy.deepcopy(rec)
    ucams = {}
    for cid, cam in rec.cameras.items():
        ucams[cid] = undistort_camera(options, cam, device=device)
        out.cameras[cid] = ucams[cid]
    for img in out.images.values():
        if len(img.xys) == 0:
            continue
        cam = rec.cameras[img.camera_id]
        ucam = ucams[img.camera_id]
        uv = cm.cam_from_img(
            cam.model_id, _params(cam, device),
            torch.as_tensor(np.asarray(img.xys, np.float32), device=device))
        xy_u = cm.img_from_cam(ucam.model_id, _params(ucam, device), uv)
        img.xys = xy_u.cpu().numpy().astype(np.float64)
    return out


def run_undistorter(rec: Reconstruction, image_dir: str, output_path: str,
                    options: UndistortCameraOptions = UndistortCameraOptions(),
                    device="cuda") -> Reconstruction:
    """COLMAP-layout undistortion workspace: images/ + sparse/ + stereo/.

    Reference: COLMAPUndistorter::Run (undistortion.cc) and the workspace
    layout in doc/format.rst:160-188.
    """
    os.makedirs(os.path.join(output_path, "images"), exist_ok=True)
    os.makedirs(os.path.join(output_path, "sparse"), exist_ok=True)
    for sub in ("depth_maps", "normal_maps"):
        os.makedirs(os.path.join(output_path, "stereo", sub), exist_ok=True)

    urec = undistort_reconstruction(options, rec, device=device)
    for img in rec.images.values():
        if not img.registered:
            continue
        bmp = bitmap_mod.read_bitmap(os.path.join(image_dir, img.name))
        und, _ = undistort_image(options, bmp.data, rec.cameras[img.camera_id],
                                 urec.cameras[img.camera_id], device=device)
        dst = os.path.join(output_path, "images", img.name)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        bitmap_mod.write_bitmap(dst, und)
    reconstruction_io.write_model(urec, os.path.join(output_path, "sparse"),
                                  ext=".bin")
    return urec


def _projection_matrix(ucam: Camera, cam_from_world: np.ndarray) -> np.ndarray:
    fx, fy, cx, cy = ucam.params[:4]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    q = torch.as_tensor(np.asarray(cam_from_world[:4], np.float64))
    R = rotation.quat_to_rotmat(q / torch.linalg.vector_norm(q)).numpy()
    return K @ np.concatenate([R, cam_from_world[4:7][:, None]], axis=1)


def _write_projection(path: str, P: np.ndarray):
    with open(path, "w") as fp:
        fp.write("CONTOUR\n")
        for row in P:
            fp.write(f"{row[0]} {row[1]} {row[2]} {row[3]}\n")


def _undistorted_registered(rec, image_dir, options, device):
    """Yield (index, image, undistorted pixels, pinhole camera) for the
    registered images in id order."""
    reg = [iid for iid in sorted(rec.images) if rec.images[iid].registered]
    ucams = {cid: undistort_camera(options, cam, device=device)
             for cid, cam in rec.cameras.items()}
    for k, iid in enumerate(reg):
        img = rec.images[iid]
        bmp = bitmap_mod.read_bitmap(os.path.join(image_dir, img.name))
        und, ucam = undistort_image(options, bmp.data,
                                    rec.cameras[img.camera_id],
                                    ucams[img.camera_id], device=device)
        yield k, img, und, ucam


def run_pmvs_undistorter(rec: Reconstruction, image_dir: str,
                         output_path: str,
                         options: UndistortCameraOptions = UndistortCameraOptions(),
                         device="cuda"):
    """CMVS/PMVS workspace export (reference: PMVSUndistorter,
    image/undistortion.h:94): pmvs/visualize/%08d.jpg undistorted images,
    pmvs/txt/%08d.txt P-matrix files ("CONTOUR" header), vis.dat from the
    covisibility of the sparse model, and a default option file."""
    base = os.path.join(output_path, "pmvs")
    for sub in ("visualize", "txt", "models"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    idx_of = {}
    for k, img, und, ucam in _undistorted_registered(rec, image_dir, options,
                                                     device):
        idx_of[img.image_id] = k
        bitmap_mod.write_bitmap(
            os.path.join(base, "visualize", f"{k:08d}.jpg"), und)
        _write_projection(os.path.join(base, "txt", f"{k:08d}.txt"),
                          _projection_matrix(ucam, img.cam_from_world))

    # vis.dat: covisibility via shared 3D points
    shared = {}
    for pt in rec.points3D.values():
        track = [idx_of[iid] for iid, _ in pt.track if iid in idx_of]
        for a in track:
            for b in track:
                if a != b:
                    shared.setdefault(a, set()).add(b)
    with open(os.path.join(base, "vis.dat"), "w") as fp:
        fp.write("VISDATA\n")
        fp.write(f"{len(idx_of)}\n")
        for k in range(len(idx_of)):
            vis = sorted(shared.get(k, ()))
            fp.write(f"{k} {len(vis)} " + " ".join(map(str, vis)) + "\n")

    with open(os.path.join(base, "option-all"), "w") as fp:
        fp.write("level 1\ncsize 2\nthreshold 0.7\nwsize 7\n"
                 "minImageNum 3\nCPU 4\nsetEdge 0\nuseBound 0\n"
                 "useVisData 1\nsequence -1\n"
                 f"timages -1 0 {len(idx_of)}\noimages 0\n")


def run_cmp_mvs_undistorter(rec: Reconstruction, image_dir: str,
                            output_path: str,
                            options: UndistortCameraOptions = UndistortCameraOptions(),
                            device="cuda"):
    """CMP-MVS workspace export (reference: CMPMVSUndistorter):
    %05d.jpg undistorted images + %05d_P.txt P matrices."""
    os.makedirs(output_path, exist_ok=True)
    for k, img, und, ucam in _undistorted_registered(rec, image_dir, options,
                                                     device):
        bitmap_mod.write_bitmap(os.path.join(output_path, f"{k + 1:05d}.jpg"),
                                und)
        _write_projection(os.path.join(output_path, f"{k + 1:05d}_P.txt"),
                          _projection_matrix(ucam, img.cam_from_world))
