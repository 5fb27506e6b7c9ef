"""Depth / normal map containers + COLMAP binary IO.

Copy of colmap_tpu/mvs/depth_map.py (host numpy; files byte-equal).
Reference: src/colmap/mvs/mat.h:39, depth_map.h:40, normal_map.h — the
on-disk format is an ASCII "width&height&channels&" header followed by
row-major little-endian float32 data (doc/format.rst:160-188). Keeping the
exact format preserves interop with reference COLMAP workspaces.
"""

from __future__ import annotations

import numpy as np


def write_mat(path: str, data: np.ndarray):
    """data: [H, W] or [H, W, C] float32."""
    arr = np.asarray(data, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode())
        # reference stores channel-major planes? No: Mat<T> is row-major with
        # interleaved channels via Get(row, col, slice) over data_[slice*w*h]
        # — channels are stored as planes (mat.h: data_[slice * width_ *
        # height_ + row * width_ + col]).
        planes = np.ascontiguousarray(np.moveaxis(arr, -1, 0))
        f.write(planes.astype("<f4").tobytes())


def read_mat(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = b""
        while header.count(b"&") < 3:
            ch = f.read(1)
            if not ch:
                raise ValueError(f"bad mat header in {path}")
            header += ch
        w, h, c = (int(v) for v in header.decode().split("&")[:3])
        data = np.frombuffer(f.read(), dtype="<f4")
    planes = data.reshape(c, h, w)
    out = np.moveaxis(planes, 0, -1)
    return out[..., 0] if c == 1 else out


class DepthMap:
    """Reference: mvs/depth_map.h:40."""

    def __init__(self, data: np.ndarray, depth_min: float = -1.0,
                 depth_max: float = -1.0):
        self.data = np.asarray(data, np.float32)
        self.depth_min = depth_min
        self.depth_max = depth_max

    def write(self, path: str):
        write_mat(path, self.data)

    @classmethod
    def read(cls, path: str) -> "DepthMap":
        return cls(read_mat(path))

    def to_rgb(self) -> np.ndarray:
        """Jet-style colormap visualization (reference: ToBitmap)."""
        d = self.data
        ok = d > 0
        lo = np.percentile(d[ok], 2) if ok.any() else 0.0
        hi = np.percentile(d[ok], 98) if ok.any() else 1.0
        t = np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1)
        r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
        rgb = (np.stack([r, g, b], -1) * 255).astype(np.uint8)
        rgb[~ok] = 0
        return rgb


class NormalMap:
    """Reference: mvs/normal_map.h."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, np.float32)  # [H, W, 3]

    def write(self, path: str):
        write_mat(path, self.data)

    @classmethod
    def read(cls, path: str) -> "NormalMap":
        return cls(read_mat(path))

    def to_rgb(self) -> np.ndarray:
        n = self.data
        rgb = ((1.0 - n) * 127.5).clip(0, 255).astype(np.uint8)
        rgb[np.all(n == 0, axis=-1)] = 0
        return rgb
