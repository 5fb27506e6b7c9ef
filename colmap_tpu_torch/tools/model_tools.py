"""Model tools: convert / crop / split / transform / align / analyze /
compare / merge.

Port of colmap_tpu/tools/model_tools.py (reference: src/colmap/exe/model.cc:
RunModelConverter :583 (BIN / TXT / PLY / NVM / Bundler / VRML / HTML),
RunModelCropper, RunModelSplitter, RunModelTransformer,
RunModelOrientationAligner, RunModelAnalyzer, RunModelComparer :472,
RunModelAligner :267, RunModelMerger :710). Host code whose writers give
the JAX package's bytes; the aligner's 256 Sim3 trials take the JAX
package's numpy draws and run as one batched Umeyama on the device.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from colmap_tpu_torch.scene import reconstruction_io as rio
from colmap_tpu_torch.scene.reconstruction import Reconstruction


# ---------------------------------------------------------------------------
# Converter
# ---------------------------------------------------------------------------


def convert_model(rec: Reconstruction, output_path: str, output_type: str):
    """output_type: BIN | TXT | PLY | NVM | Bundler | VRML | R3D | CAM
    (reference: RunModelConverter, exe/model.cc:583)."""
    ot = output_type.upper()
    if ot == "BIN":
        os.makedirs(output_path, exist_ok=True)
        rio.write_model(rec, output_path, ext=".bin")
    elif ot == "TXT":
        os.makedirs(output_path, exist_ok=True)
        rio.write_model(rec, output_path, ext=".txt")
    elif ot == "PLY":
        rio.write_ply(rec, output_path)
    elif ot == "NVM":
        write_nvm(rec, output_path)
    elif ot == "BUNDLER":
        write_bundler(rec, output_path)
    elif ot == "VRML":
        write_vrml(rec, output_path)
    elif ot == "HTML":
        # a headless replacement for the reference's Qt/OpenGL viewer
        # (ui/model_viewer_widget.h:50): a self-contained WebGL page
        from colmap_tpu_torch.tools.html_viewer import write_html

        write_html(rec, output_path)
    else:
        raise ValueError(f"unknown output type {output_type}")


def _quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def write_nvm(rec: Reconstruction, path: str, skip_distortion: bool = False):
    """VisualSFM NVM_V3 export (reference: WriteNVM, scene/reconstruction_io).

    NVM stores <f cx cy> with the camera center convention and rotation as a
    quaternion, camera center (not translation).
    """
    lines = ["NVM_V3", ""]
    reg = rec.registered_image_ids()
    lines.append(str(len(reg)))
    pidx_of_image = {iid: k for k, iid in enumerate(reg)}
    for iid in reg:
        im = rec.images[iid]
        cam = rec.cameras[im.camera_id]
        f = cam.mean_focal_length()
        q = im.cam_from_world[:4]
        c = im.projection_center()
        k = 0.0
        lines.append(f"{im.name} {f} {q[0]} {q[1]} {q[2]} {q[3]} "
                     f"{c[0]} {c[1]} {c[2]} {k} 0")
    lines.append("")
    lines.append(str(len(rec.points3D)))
    for pid, pt in rec.points3D.items():
        obs = [o for o in pt.track if rec.images[o[0]].registered]
        parts = [f"{pt.xyz[0]} {pt.xyz[1]} {pt.xyz[2]}",
                 f"{pt.color[0]} {pt.color[1]} {pt.color[2]}", str(len(obs))]
        for (iid, p2d) in obs:
            xy = rec.images[iid].xys[p2d]
            cam = rec.cameras[rec.images[iid].camera_id]
            cx = cam.params[2] if len(cam.params) > 2 else 0.0
            cy = cam.params[3] if len(cam.params) > 3 else 0.0
            parts.append(f"{pidx_of_image[iid]} {p2d} {xy[0] - cx} {xy[1] - cy}")
        lines.append(" ".join(parts))
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")


def write_bundler(rec: Reconstruction, path: str):
    """Bundler v0.3 export (reference: ExportBundler). Writes `path` (.out)
    and `path.list.txt`."""
    reg = rec.registered_image_ids()
    lines = ["# Bundle file v0.3", f"{len(reg)} {len(rec.points3D)}"]
    idx_of = {iid: i for i, iid in enumerate(reg)}
    for iid in reg:
        im = rec.images[iid]
        cam = rec.cameras[im.camera_id]
        f = cam.mean_focal_length()
        R = _quat_to_rotmat(im.cam_from_world[:4])
        t = im.cam_from_world[4:7]
        # bundler uses a y-up, z-back camera: flip rows 2,3
        F = np.diag([1.0, -1.0, -1.0])
        Rb = F @ R
        tb = F @ t
        lines.append(f"{f} 0 0")
        for r in Rb:
            lines.append(f"{r[0]} {r[1]} {r[2]}")
        lines.append(f"{tb[0]} {tb[1]} {tb[2]}")
    for pid, pt in rec.points3D.items():
        lines.append(f"{pt.xyz[0]} {pt.xyz[1]} {pt.xyz[2]}")
        lines.append(f"{pt.color[0]} {pt.color[1]} {pt.color[2]}")
        obs = [o for o in pt.track if o[0] in idx_of]
        parts = [str(len(obs))]
        for (iid, p2d) in obs:
            im = rec.images[iid]
            cam = rec.cameras[im.camera_id]
            cx = cam.params[2] if len(cam.params) > 2 else 0.0
            cy = cam.params[3] if len(cam.params) > 3 else 0.0
            xy = im.xys[p2d]
            parts.append(f"{idx_of[iid]} {p2d} {xy[0] - cx} {cy - xy[1]}")
        lines.append(" ".join(parts))
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")
    with open(path + ".list.txt", "w") as fp:
        for iid in reg:
            fp.write(rec.images[iid].name + "\n")


def write_vrml(rec: Reconstruction, path: str):
    """Minimal VRML 2.0 point cloud + camera cones (reference:
    Reconstruction::ExportVRML)."""
    with open(path, "w") as fp:
        fp.write("#VRML V2.0 utf8\n")
        fp.write("Shape { geometry PointSet {\n coord Coordinate { point [\n")
        for pt in rec.points3D.values():
            fp.write(f"{pt.xyz[0]} {pt.xyz[1]} {pt.xyz[2]},\n")
        fp.write("] }\n color Color { color [\n")
        for pt in rec.points3D.values():
            c = pt.color / 255.0
            fp.write(f"{c[0]} {c[1]} {c[2]},\n")
        fp.write("] } } }\n")


# ---------------------------------------------------------------------------
# Cropper / splitter / transformer
# ---------------------------------------------------------------------------


def crop_model(rec: Reconstruction, box_min, box_max) -> Reconstruction:
    """Keep points inside the axis-aligned box; deregister images with no
    remaining observations (reference: RunModelCropper / Reconstruction::Crop)."""
    out = copy.deepcopy(rec)
    box_min = np.asarray(box_min, float)
    box_max = np.asarray(box_max, float)
    dead = [pid for pid, pt in out.points3D.items()
            if np.any(pt.xyz < box_min) or np.any(pt.xyz > box_max)]
    for pid in dead:
        out.delete_point3D(pid)
    for iid, im in out.images.items():
        if im.registered and im.num_points3D() == 0:
            im.cam_from_world = None
    return out


def split_model(rec: Reconstruction, parts_per_axis: Tuple[int, int, int],
                overlap_ratio: float = 0.0) -> List[Reconstruction]:
    """Grid split into sub-models (reference: RunModelSplitter)."""
    if not rec.points3D:
        return []
    xyz = np.stack([p.xyz for p in rec.points3D.values()])
    lo = xyz.min(0)
    hi = xyz.max(0) + 1e-9
    ext = (hi - lo) / np.asarray(parts_per_axis, float)
    pad = ext * overlap_ratio
    out = []
    for ix in range(parts_per_axis[0]):
        for iy in range(parts_per_axis[1]):
            for iz in range(parts_per_axis[2]):
                cell_lo = lo + ext * np.array([ix, iy, iz]) - pad
                cell_hi = lo + ext * np.array([ix + 1, iy + 1, iz + 1]) + pad
                sub = crop_model(rec, cell_lo, cell_hi)
                if len(sub.points3D) > 0:
                    out.append(sub)
    return out


def transform_model(rec: Reconstruction, sim3_vec: np.ndarray) -> Reconstruction:
    """Apply a Sim3 [scale qw qx qy qz tx ty tz] (reference:
    RunModelTransformer)."""
    out = copy.deepcopy(rec)
    out.transform(np.asarray(sim3_vec, np.float64))
    return out


def align_model_orientation(rec: Reconstruction) -> Reconstruction:
    """Gravity/Manhattan alignment from the up-vectors of the registered
    cameras (reference: RunModelOrientationAligner + coordinate_frame.cc —
    the image-based line-detection variant is future work; the camera-based
    estimate covers the common use)."""
    reg = rec.registered_image_ids()
    if not reg:
        return copy.deepcopy(rec)
    # camera "down" in world = R^T [0 1 0]
    downs = []
    for iid in reg:
        R = _quat_to_rotmat(rec.images[iid].cam_from_world[:4])
        downs.append(R.T @ np.array([0.0, 1.0, 0.0]))
    down = np.mean(downs, 0)
    down /= np.linalg.norm(down)
    # rotation taking `down` to +y
    target = np.array([0.0, 1.0, 0.0])
    v = np.cross(down, target)
    c = float(np.dot(down, target))
    if np.linalg.norm(v) < 1e-9:
        Rw = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        Rw = np.eye(3) + vx + vx @ vx / (1 + c)
    from colmap_tpu_torch.geometry import rotation as rot

    q = rot.rotmat_to_quat(torch.as_tensor(Rw, dtype=torch.float32)).numpy()
    q = q.astype(np.float64)
    t = np.concatenate([[1.0], q, [0.0, 0.0, 0.0]])
    return transform_model(rec, t)


# ---------------------------------------------------------------------------
# Aligner / analyzer / comparer / merger
# ---------------------------------------------------------------------------


def align_model_to_positions(rec: Reconstruction,
                             image_positions: Dict[str, np.ndarray],
                             max_error: float = 0.1,
                             min_common_images: int = 3,
                             device="cuda") -> Optional[Reconstruction]:
    """Align to per-image-name reference locations (GPS / ENU or custom).

    Reference: RunModelAligner (exe/model.cc:267). The 256 robust trials
    draw their triples from np.random.default_rng(0) in the JAX package's
    order; all are fitted in one batched estimate_sim3 and scored in one
    batched transform on `device`; the first best wins."""
    from colmap_tpu_torch.estimators.similarity_transform import (
        estimate_sim3)
    from colmap_tpu_torch.geometry import sim3 as sim3_mod

    names = {im.name: iid for iid, im in rec.images.items() if im.registered}
    common = [n for n in image_positions if n in names]
    if len(common) < min_common_images:
        return None
    src = np.stack([rec.images[names[n]].projection_center() for n in common])
    dst = np.stack([np.asarray(image_positions[n], float) for n in common])
    rng = np.random.default_rng(0)
    sel = np.stack([rng.choice(len(common), 3, replace=False)
                    for _ in range(256)])
    src_d = torch.as_tensor(src, dtype=torch.float32, device=device)
    dst_d = torch.as_tensor(dst, dtype=torch.float64, device=device)
    sel_d = torch.as_tensor(sel, device=device)
    trials = estimate_sim3(src_d[sel_d], dst_d.float()[sel_d])  # (256, 8)

    def inliers(t):
        pred = sim3_mod.apply(t[..., None, :], src_d).double()
        return torch.linalg.norm(pred - dst_d, dim=-1) < max_error

    counts = inliers(trials).sum(-1)
    k = int(torch.argmax(counts))  # the first of the best
    if int(counts[k]) < min_common_images:
        return None
    best = trials[k]
    mask = inliers(best)
    if int(mask.sum()) >= 3:
        best = estimate_sim3(src_d[mask], dst_d.float()[mask])
    return transform_model(rec, best.cpu().numpy().astype(np.float64))


def analyze_model(rec: Reconstruction) -> Dict[str, float]:
    """Model statistics (reference: RunModelAnalyzer, exe/model.cc)."""
    errors = [pt.error for pt in rec.points3D.values() if pt.error >= 0]
    return {
        "num_cameras": len(rec.cameras),
        "num_images": len(rec.images),
        "num_registered_images": rec.num_registered_images(),
        "num_points3D": len(rec.points3D),
        "num_observations": int(sum(len(p.track) for p in rec.points3D.values())),
        "mean_track_length": rec.compute_mean_track_length(),
        "mean_observations_per_image": rec.compute_mean_observations_per_reg_image(),
        "mean_reprojection_error": float(np.mean(errors)) if errors else -1.0,
    }


def compare_models(rec1: Reconstruction, rec2: Reconstruction,
                   device="cuda") -> Optional[dict]:
    """reference: RunModelComparer (exe/model.cc:472)."""
    from colmap_tpu_torch.estimators.similarity_transform import (
        compare_reconstructions)

    return compare_reconstructions(rec1, rec2, device=device)


def merge_models(rec1: Reconstruction, rec2: Reconstruction,
                 max_reproj_error: float = 64.0,
                 device="cuda") -> Optional[Reconstruction]:
    """reference: RunModelMerger (exe/model.cc:710)."""
    from colmap_tpu_torch.estimators.alignment import merge_reconstructions

    out = copy.deepcopy(rec1)
    if merge_reconstructions(out, rec2, max_reproj_error=max_reproj_error,
                             device=device):
        return out
    return None
