"""Container for multiple sub-models with sparse/0,1,... disk layout.

Copy of colmap_tpu/scene/reconstruction_manager.py (reference:
scene/reconstruction_manager.h:40).
"""

from __future__ import annotations

import os
from typing import Iterator, List

from colmap_tpu_torch.scene import reconstruction_io as rio
from colmap_tpu_torch.scene.reconstruction import Reconstruction


class ReconstructionManager:
    def __init__(self):
        self._models: List[Reconstruction] = []

    def __len__(self) -> int:
        return len(self._models)

    def __getitem__(self, i: int) -> Reconstruction:
        return self._models[i]

    def __iter__(self) -> Iterator[Reconstruction]:
        return iter(self._models)

    def add(self, rec: Reconstruction) -> int:
        self._models.append(rec)
        return len(self._models) - 1

    def delete(self, i: int):
        del self._models[i]

    def clear(self):
        self._models.clear()

    def largest(self) -> Reconstruction:
        return max(self._models, key=lambda r: r.num_registered_images())

    def write(self, path: str, ext: str = ".bin"):
        """Write models to path/0, path/1, ... (reference: Write)."""
        os.makedirs(path, exist_ok=True)
        for i, rec in enumerate(self._models):
            sub = os.path.join(path, str(i))
            os.makedirs(sub, exist_ok=True)
            rio.write_model(rec, sub, ext=ext)

    @classmethod
    def read(cls, path: str) -> "ReconstructionManager":
        mgr = cls()
        i = 0
        while os.path.isdir(os.path.join(path, str(i))):
            mgr.add(rio.read_model(os.path.join(path, str(i))))
            i += 1
        if i == 0 and os.path.isdir(path):
            try:
                mgr.add(rio.read_model(path))
            except FileNotFoundError:
                pass  # no model directly under `path` either
        return mgr
