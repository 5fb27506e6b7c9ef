"""Per-pixel consistent-source-image lists (MVS fusion byproduct).

Copy of colmap_tpu/mvs/consistency_graph.py (host numpy; files
byte-equal). Reference: src/colmap/mvs/consistency_graph.h:52 / consistency_graph.cc —
records of [col, row, num_images, image_idx...] after an ASCII
"width&height&1&" header, int32 little-endian. Format-compatible IO.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class ConsistencyGraph:
    NO_CONSISTENT = -1

    def __init__(self, width: int = 0, height: int = 0,
                 data: Optional[np.ndarray] = None):
        self.width = width
        self.height = height
        self.data = np.asarray(data if data is not None else [], np.int32)
        self._map = None
        if width and height:
            self._initialize_map()

    def _initialize_map(self):
        m = np.full((self.height, self.width), self.NO_CONSISTENT, np.int64)
        i = 0
        d = self.data
        while i < len(d):
            num = int(d[i + 2])
            if num > 0:
                col, row = int(d[i]), int(d[i + 1])
                m[row, col] = i + 2
            i += 3 + num
        self._map = m

    def image_idxs(self, row: int, col: int) -> np.ndarray:
        idx = self._map[row, col]
        if idx == self.NO_CONSISTENT:
            return np.zeros(0, np.int32)
        num = int(self.data[idx])
        return self.data[idx + 1: idx + 1 + num]

    @property
    def num_bytes(self) -> int:
        return (self.data.size + (self._map.size if self._map is not None else 0)) * 4

    # -- construction from fusion masks ---------------------------------------

    @classmethod
    def from_masks(cls, consistent: np.ndarray,
                   src_image_idxs: Sequence[int]) -> "ConsistencyGraph":
        """consistent: (S, H, W) bool — per source image, per pixel."""
        s, h, w = consistent.shape
        idxs = np.asarray(src_image_idxs, np.int32)
        counts = consistent.sum(0)
        rows, cols = np.nonzero(counts > 0)
        chunks: List[np.ndarray] = []
        for r, c in zip(rows, cols):
            imgs = idxs[consistent[:, r, c]]
            chunks.append(np.concatenate([[c, r, len(imgs)], imgs]).astype(np.int32))
        data = np.concatenate(chunks) if chunks else np.zeros(0, np.int32)
        return cls(width=w, height=h, data=data)

    # -- COLMAP binary IO -------------------------------------------------------

    def write(self, path: str):
        with open(path, "wb") as f:
            f.write(f"{self.width}&{self.height}&1&".encode())
            f.write(self.data.astype("<i4").tobytes())

    @classmethod
    def read(cls, path: str) -> "ConsistencyGraph":
        with open(path, "rb") as f:
            header = b""
            while header.count(b"&") < 3:
                ch = f.read(1)
                if not ch:
                    raise ValueError(f"bad consistency graph header in {path}")
                header += ch
            w, h, _ = (int(v) for v in header.decode().split("&")[:3])
            data = np.frombuffer(f.read(), dtype="<i4")
        return cls(width=w, height=h, data=data.copy())
