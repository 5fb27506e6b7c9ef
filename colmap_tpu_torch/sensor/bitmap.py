"""Image IO, grayscale conversion, EXIF focal-length extraction.

Re-design of the reference Bitmap/FreeImage wrapper
(reference: src/colmap/sensor/bitmap.h:69, ExifFocalLength :146) on top of
PIL — host-side only; pixel data is handed to the TPU extractor as f32
arrays. The camera-spec sensor-width table of the reference
(src/colmap/sensor/specs.cc, ~3k entries) is replaced by a compact table of
common sensor formats plus the EXIF FocalPlaneResolution path, with the same
fallback chain as the reference ImageReader
(src/colmap/controllers/image_reader.cc): EXIF focal -> sensor-width DB ->
default_focal_length_factor * max(width, height).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

try:
    from PIL import Image, ExifTags
    _HAS_PIL = True
except Exception:  # pragma: no cover
    _HAS_PIL = False


# Sensor-width lookup: the full ~3.7k-entry make/model table
# (sensor/camera_specs.csv + camera_database.py, reference
# src/colmap/sensor/specs.cc + database.cc QuerySensorWidth).
from colmap_tpu_torch.sensor.camera_database import query_sensor_width

_EXIF_TAGS = {v: k for k, v in ExifTags.TAGS.items()} if _HAS_PIL else {}


@dataclasses.dataclass
class Bitmap:
    """In-memory image + metadata (reference: sensor/bitmap.h)."""

    data: np.ndarray  # [H, W] gray f32 in [0,1] or [H, W, 3] uint8
    exif_focal_px: Optional[float] = None
    make: str = ""
    model: str = ""
    gps: Optional[np.ndarray] = None  # (lat deg, lon deg, alt m)

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]


def _rational(v):
    try:
        return float(v)
    except Exception:
        try:
            return v[0] / v[1]
        except Exception:
            return None


def exif_focal_length_px(pil_img, width: int) -> Tuple[Optional[float], str, str]:
    """EXIF focal in pixels (reference: Bitmap::ExifFocalLength, bitmap.cc).

    Chain: FocalLengthIn35mmFilm -> FocalLength + FocalPlaneXResolution ->
    FocalLength + sensor-width database.
    """
    make = model = ""
    try:
        exif = pil_img.getexif()
    except Exception:
        return None, make, model
    if not exif:
        return None, make, model

    def tag(name):
        tid = _EXIF_TAGS.get(name)
        if tid is None:
            return None
        v = exif.get(tid)
        if v is None:
            try:
                v = exif.get_ifd(0x8769).get(tid)  # EXIF sub-IFD
            except Exception:
                v = None
        return v

    make = str(tag("Make") or "").strip()
    model = str(tag("Model") or "").strip()

    f35 = _rational(tag("FocalLengthIn35mmFilm") or 0)
    if f35 and f35 > 0:
        return width * f35 / 36.0, make, model

    focal_mm = _rational(tag("FocalLength") or 0)
    if focal_mm and focal_mm > 0:
        fpx = _rational(tag("FocalPlaneXResolution") or 0)
        unit = tag("FocalPlaneResolutionUnit") or 2
        pix_w = _rational(tag("ExifImageWidth") or 0) or width
        if fpx and fpx > 0:
            unit_mm = {2: 25.4, 3: 10.0, 4: 1.0, 5: 0.001}.get(int(unit), 25.4)
            sensor_w_mm = pix_w / fpx * unit_mm
            if sensor_w_mm > 0:
                return width * focal_mm / sensor_w_mm, make, model
        sw = query_sensor_width(make, model)
        if sw:
            return width * focal_mm / sw, make, model
    return None, make, model


def read_bitmap(path: str, as_rgb: bool = False) -> Bitmap:
    """Read an image file; grayscale f32 in [0,1] by default."""
    if not _HAS_PIL:  # pragma: no cover
        raise RuntimeError("PIL is required for image IO")
    with Image.open(path) as im:
        focal, make, model = exif_focal_length_px(im, im.width)
        gps = exif_gps_position(im)
        if as_rgb:
            data = np.asarray(im.convert("RGB"), np.uint8)
        else:
            data = np.asarray(im.convert("L"), np.float32) / 255.0
    return Bitmap(data=data, exif_focal_px=focal, make=make, model=model,
                  gps=gps)


def write_bitmap(path: str, data: np.ndarray):
    if not _HAS_PIL:  # pragma: no cover
        raise RuntimeError("PIL is required for image IO")
    arr = np.asarray(data)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def rescale(data: np.ndarray, max_size: int) -> Tuple[np.ndarray, float]:
    """Downscale so max(H, W) <= max_size; returns (image, scale)."""
    h, w = data.shape[:2]
    if max(h, w) <= max_size:
        return data, 1.0
    scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    im = Image.fromarray(
        (data * 255).astype(np.uint8) if data.dtype != np.uint8 else data)
    out = np.asarray(im.resize((nw, nh), Image.BILINEAR))
    if data.dtype != np.uint8:
        out = out.astype(np.float32) / 255.0
    return out, scale


def default_focal_length(width: int, height: int, factor: float = 1.2) -> float:
    """Reference: ImageReaderOptions.default_focal_length_factor
    (controllers/image_reader.h)."""
    return factor * max(width, height)


def list_image_files(image_dir: str) -> list:
    exts = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".ppm", ".pgm"}
    files = []
    for root, _, names in os.walk(image_dir):
        for n in sorted(names):
            if os.path.splitext(n)[1].lower() in exts:
                files.append(os.path.relpath(os.path.join(root, n), image_dir))
    return sorted(files)


def exif_gps_position(pil_img):
    """EXIF GPS (lat deg, lon deg, alt m) or None
    (reference: Bitmap::ExifLatitude/Longitude/Altitude, bitmap.cc)."""
    try:
        exif = pil_img.getexif()
        gps = exif.get_ifd(0x8825)  # GPSInfo IFD
    except Exception:
        return None
    if not gps:
        return None

    def dms(v, ref, neg):
        try:
            d = float(v[0]) + float(v[1]) / 60.0 + float(v[2]) / 3600.0
            return -d if ref in neg else d
        except Exception:
            return None

    lat = dms(gps.get(2), str(gps.get(1, "N")), ("S",))
    lon = dms(gps.get(4), str(gps.get(3, "E")), ("W",))
    if lat is None or lon is None:
        return None
    alt = 0.0
    try:
        alt = float(gps.get(6, 0.0))
        if int(gps.get(5, 0)) == 1:
            alt = -alt
    except Exception:
        pass
    return np.array([lat, lon, alt], np.float64)
