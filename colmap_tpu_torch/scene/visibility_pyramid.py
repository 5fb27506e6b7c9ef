"""Multi-resolution visibility pyramid for next-image ranking.

Host numpy copy of colmap_tpu/scene/visibility_pyramid.py (reference:
src/colmap/scene/visibility_pyramid.h:51): a stack of 2^l x 2^l grids over
the image; adding a point marks cells at every level, and the score favors
spatially well-distributed triangulated observations
(ObservationManager::Point3DVisibilityScore).
"""

from __future__ import annotations

import numpy as np


class VisibilityPyramid:
    def __init__(self, num_levels: int, width: int, height: int):
        self.num_levels = num_levels
        self.width = max(width, 1)
        self.height = max(height, 1)
        # counts per cell per level
        self._grids = [np.zeros((1 << l, 1 << l), np.int32)
                       for l in range(1, num_levels + 1)]
        self.score = 0
        # max score contribution per level grows with resolution
        self._max_score = sum((1 << (l + 1)) ** 2 for l in range(num_levels))

    def _cell(self, level: int, x: float, y: float):
        g = 1 << (level + 1)
        cx = min(int(x / self.width * g), g - 1)
        cy = min(int(y / self.height * g), g - 1)
        return cy, cx

    def add_point(self, x: float, y: float):
        for l in range(self.num_levels):
            cy, cx = self._cell(l, x, y)
            grid = self._grids[l]
            if grid[cy, cx] == 0:
                # first point in this cell: score weight = cells at level
                self.score += (1 << (l + 1))
            grid[cy, cx] += 1

    def remove_point(self, x: float, y: float):
        for l in range(self.num_levels):
            cy, cx = self._cell(l, x, y)
            grid = self._grids[l]
            if grid[cy, cx] > 0:
                grid[cy, cx] -= 1
                if grid[cy, cx] == 0:
                    self.score -= (1 << (l + 1))

    def reset(self):
        for g in self._grids:
            g[:] = 0
        self.score = 0
