"""Read/write the COLMAP sparse-model formats (bin + txt + PLY export).

Copy of colmap_tpu/scene/reconstruction_io.py. Byte-compatible with the
reference formats (scene/reconstruction_io.h:40-146, doc/format.rst:39-150),
so a model written by either package reads back in the other. All values
little-endian.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

from colmap_tpu_torch.scene.reconstruction import Camera, Image, Point3D, Reconstruction
from colmap_tpu_torch.sensor import models as camera_models

_INVALID_P3D = 0xFFFFFFFFFFFFFFFF


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack("<" + fmt, f.read(size))


def _write(f, fmt, *vals):
    f.write(struct.pack("<" + fmt, *vals))


# ---------------------------------------------------------------- binary IO


def write_cameras_binary(rec: Reconstruction, path):
    with open(path, "wb") as f:
        _write(f, "Q", len(rec.cameras))
        for cam in rec.cameras.values():
            _write(f, "iiQQ", cam.camera_id, cam.model_id, cam.width, cam.height)
            n = camera_models.NUM_PARAMS[camera_models.CameraModelId(cam.model_id)]
            params = np.asarray(cam.params, dtype=np.float64)[:n]
            f.write(params.tobytes())


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "Q")
        for _ in range(num):
            cid, mid, w, h = _read(f, "iiQQ")
            n = camera_models.NUM_PARAMS[camera_models.CameraModelId(mid)]
            params = np.frombuffer(f.read(8 * n), dtype=np.float64).copy()
            cameras[cid] = Camera(camera_id=cid, model_id=mid, width=w, height=h, params=params)
    return cameras


def write_images_binary(rec: Reconstruction, path):
    reg = [im for im in rec.images.values() if im.registered]
    with open(path, "wb") as f:
        _write(f, "Q", len(reg))
        for im in reg:
            q = im.cam_from_world[:4]
            t = im.cam_from_world[4:7]
            _write(f, "i", im.image_id)
            f.write(np.asarray(q, np.float64).tobytes())
            f.write(np.asarray(t, np.float64).tobytes())
            _write(f, "i", im.camera_id)
            f.write(im.name.encode() + b"\x00")
            n = len(im.xys)
            _write(f, "Q", n)
            if n:
                pids = im.point3D_ids.astype(np.int64)
                u = np.where(pids < 0, np.uint64(_INVALID_P3D), pids.astype(np.uint64))
                # interleaved rows: x (f64), y (f64), point3D_id (u64)
                raw = np.empty(n, dtype=[("x", "<f8"), ("y", "<f8"), ("pid", "<u8")])
                raw["x"] = im.xys[:, 0]
                raw["y"] = im.xys[:, 1]
                raw["pid"] = u
                f.write(raw.tobytes())


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "Q")
        for _ in range(num):
            (iid,) = _read(f, "i")
            pose = np.frombuffer(f.read(8 * 7), dtype=np.float64).copy()
            (cid,) = _read(f, "i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00" or c == b"":
                    break
                name += c
            (n,) = _read(f, "Q")
            raw = np.frombuffer(
                f.read(n * 24), dtype=[("x", "<f8"), ("y", "<f8"), ("pid", "<u8")]
            )
            xys = np.stack([raw["x"], raw["y"]], axis=-1) if n else np.zeros((0, 2))
            pids = raw["pid"].astype(np.int64)
            pids[raw["pid"] == _INVALID_P3D] = -1
            images[iid] = Image(
                image_id=iid,
                name=name.decode(),
                camera_id=cid,
                cam_from_world=pose,
                xys=xys,
                point3D_ids=pids,
            )
    return images


def write_points3D_binary(rec: Reconstruction, path):
    with open(path, "wb") as f:
        _write(f, "Q", len(rec.points3D))
        for pid, pt in rec.points3D.items():
            _write(f, "Q", pid)
            f.write(np.asarray(pt.xyz, np.float64).tobytes())
            f.write(np.asarray(pt.color, np.uint8).tobytes())
            _write(f, "d", float(pt.error))
            _write(f, "Q", len(pt.track))
            for image_id, p2d_idx in pt.track:
                _write(f, "ii", image_id, p2d_idx)


def read_points3D_binary(path):
    points = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "Q")
        for _ in range(num):
            (pid,) = _read(f, "Q")
            xyz = np.frombuffer(f.read(24), dtype=np.float64).copy()
            color = np.frombuffer(f.read(3), dtype=np.uint8).copy()
            (error,) = _read(f, "d")
            (tlen,) = _read(f, "Q")
            raw = np.frombuffer(f.read(8 * tlen), dtype=np.int32).reshape(-1, 2)
            track = [(int(a), int(b)) for a, b in raw]
            points[int(pid)] = Point3D(xyz=xyz, color=color, error=error, track=track)
    return points


# ------------------------------------------------------------------ text IO


def write_cameras_text(rec: Reconstruction, path):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(f"# Number of cameras: {len(rec.cameras)}\n")
        for cam in rec.cameras.values():
            n = camera_models.NUM_PARAMS[camera_models.CameraModelId(cam.model_id)]
            params = " ".join(repr(float(p)) for p in np.asarray(cam.params)[:n])
            f.write(f"{cam.camera_id} {cam.model_name} {cam.width} {cam.height} {params}\n")


def read_cameras_text(path):
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            mid = int(camera_models.MODEL_IDS_BY_NAME[parts[1]])
            w, h = int(parts[2]), int(parts[3])
            params = np.array([float(x) for x in parts[4:]], dtype=np.float64)
            cameras[cid] = Camera(camera_id=cid, model_id=mid, width=w, height=h, params=params)
    return cameras


def write_images_text(rec: Reconstruction, path):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in rec.images.values():
            if not im.registered:
                continue
            pose = " ".join(repr(float(v)) for v in im.cam_from_world)
            f.write(f"{im.image_id} {pose} {im.camera_id} {im.name}\n")
            obs = []
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                obs.append(f"{float(x)!r} {float(y)!r} {int(pid) if pid >= 0 else -1}")
            f.write(" ".join(obs) + "\n")


def read_images_text(path):
    images = {}
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f if not l.startswith("#")]
    i = 0
    while i + 1 < len(lines) or (i < len(lines) and lines[i].strip()):
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        parts = line.split()
        iid = int(parts[0])
        pose = np.array([float(x) for x in parts[1:8]])
        cid = int(parts[8])
        name = parts[9]
        i += 1
        xys = np.zeros((0, 2))
        pids = np.zeros(0, dtype=np.int64)
        if i < len(lines):
            obs = lines[i].split()
            if obs:
                arr = np.array(obs, dtype=np.float64).reshape(-1, 3)
                xys = arr[:, :2]
                pids = arr[:, 2].astype(np.int64)
            i += 1
        images[iid] = Image(
            image_id=iid, name=name, camera_id=cid, cam_from_world=pose, xys=xys, point3D_ids=pids
        )
    return images


def write_points3D_text(rec: Reconstruction, path):
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pid, pt in rec.points3D.items():
            xyz = " ".join(repr(float(v)) for v in pt.xyz)
            rgb = " ".join(str(int(v)) for v in pt.color)
            track = " ".join(f"{a} {b}" for a, b in pt.track)
            f.write(f"{pid} {xyz} {rgb} {float(pt.error)!r} {track}\n")


def read_points3D_text(path):
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pid = int(parts[0])
            xyz = np.array(parts[1:4], dtype=np.float64)
            color = np.array(parts[4:7], dtype=np.uint8)
            error = float(parts[7])
            rest = np.array(parts[8:], dtype=np.int64).reshape(-1, 2)
            track = [(int(a), int(b)) for a, b in rest]
            points[pid] = Point3D(xyz=xyz, color=color, error=error, track=track)
    return points


# ----------------------------------------------------------------- frontends


def write_model(rec: Reconstruction, path, ext=".bin"):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(rec, path / "cameras.bin")
        write_images_binary(rec, path / "images.bin")
        write_points3D_binary(rec, path / "points3D.bin")
    elif ext == ".txt":
        write_cameras_text(rec, path / "cameras.txt")
        write_images_text(rec, path / "images.txt")
        write_points3D_text(rec, path / "points3D.txt")
    else:
        raise ValueError(f"unknown model extension {ext}")


def read_model(path) -> Reconstruction:
    path = Path(path)
    rec = Reconstruction()
    if (path / "cameras.bin").exists():
        rec.cameras = read_cameras_binary(path / "cameras.bin")
        rec.images = read_images_binary(path / "images.bin")
        rec.points3D = read_points3D_binary(path / "points3D.bin")
    elif (path / "cameras.txt").exists():
        rec.cameras = read_cameras_text(path / "cameras.txt")
        rec.images = read_images_text(path / "images.txt")
        rec.points3D = read_points3D_text(path / "points3D.txt")
    else:
        raise FileNotFoundError(f"no model found at {path}")
    if rec.points3D:
        rec._next_point3D_id = max(rec.points3D) + 1
    return rec


def write_ply(rec: Reconstruction, path):
    """Export the point cloud as binary PLY (reference: ExportPLY)."""
    pts = list(rec.points3D.values())
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        f.write(header.encode())
        raw = np.empty(len(pts), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
        for i, p in enumerate(pts):
            raw["xyz"][i] = p.xyz
            raw["rgb"][i] = p.color
        f.write(raw.tobytes())
