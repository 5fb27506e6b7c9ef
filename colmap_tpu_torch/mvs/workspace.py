"""Memory-constrained MVS workspace cache.

Copy of colmap_tpu/mvs/workspace.py (host numpy). Reference:
src/colmap/mvs/workspace.h:44,104 (Workspace / CachedWorkspace)
— bitmaps and depth/normal maps of large scenes don't fit in RAM, so they
load through a byte-capped LRU (util/cache.py MemoryConstrainedLRUCache).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from colmap_tpu_torch.mvs import depth_map as dm
from colmap_tpu_torch.sensor import bitmap as bitmap_mod
from colmap_tpu_torch.util.cache import MemoryConstrainedLRUCache


@dataclasses.dataclass
class WorkspaceOptions:
    workspace_path: str = ""
    max_cache_bytes: int = 8 << 30  # reference default: 32 GB; host-tunable
    input_type: str = "geometric"  # or photometric


class Workspace:
    """Cached access to images / depth maps / normal maps of a workspace."""

    def __init__(self, options: WorkspaceOptions, image_names: dict):
        """image_names: image_id -> relative image name."""
        self.options = options
        self.image_names = dict(image_names)
        third = max(options.max_cache_bytes // 3, 1)
        self._bitmaps = MemoryConstrainedLRUCache(third, self._load_bitmap)
        self._depths = MemoryConstrainedLRUCache(third, self._load_depth)
        self._normals = MemoryConstrainedLRUCache(third, self._load_normal)

    # -- loaders ---------------------------------------------------------------

    def _stereo_path(self, kind: str, image_id: int) -> str:
        name = self.image_names[image_id]
        p = os.path.join(self.options.workspace_path, "stereo", kind,
                         f"{name}.{self.options.input_type}.bin")
        if not os.path.exists(p):
            p = os.path.join(self.options.workspace_path, "stereo", kind,
                             f"{name}.photometric.bin")
        return p

    def _load_bitmap(self, image_id: int) -> np.ndarray:
        path = os.path.join(self.options.workspace_path, "images",
                            self.image_names[image_id])
        return bitmap_mod.read_bitmap(path).data

    def _load_depth(self, image_id: int) -> np.ndarray:
        return dm.DepthMap.read(self._stereo_path("depth_maps", image_id)).data

    def _load_normal(self, image_id: int) -> np.ndarray:
        return dm.NormalMap.read(self._stereo_path("normal_maps", image_id)).data

    # -- accessors -------------------------------------------------------------

    def has_depth_map(self, image_id: int) -> bool:
        return os.path.exists(self._stereo_path("depth_maps", image_id))

    def bitmap(self, image_id: int) -> np.ndarray:
        return self._bitmaps.get(image_id)

    def depth_map(self, image_id: int) -> np.ndarray:
        return self._depths.get(image_id)

    def normal_map(self, image_id: int) -> np.ndarray:
        return self._normals.get(image_id)

    @property
    def num_bytes_cached(self) -> int:
        return (self._bitmaps.num_bytes + self._depths.num_bytes
                + self._normals.num_bytes)
