"""Plain reference judge of depth and normal maps against the true surface.

For each pass (photometric, geometric) it compares the program's maps
with the rendered scene's true depth and normals on the pixels where the
reference frame has texture: the standard deviation of its intensities
over the matching window is above `texture_sd` (in [0, 1] units), where
the photometric cost is defined. Every pixel of a frame that sees a
surface is judged; a frame without a map judges all its pixels as
infinite errors.

Per pass it gives, pooled over every frame's judged pixels:

- `<pass>_depth_err_p50`: the median relative depth error
  |d - d_true| / d_true, a pixel without an estimate counting as an
  infinite error;
- `<pass>_normal_err_p50_deg`: the median angle, in degrees, between the
  program's normal and the true one (both in the camera's frame), a pixel
  without an estimate counting as 180;
- `<pass>_normal_within10_share`: the share of pixels whose normal lies
  within 10 degrees of the true one.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def textured(images: np.ndarray, radius: int, sd: float) -> np.ndarray:
    """(n, H, W) bool: the window's intensity deviation above `sd`."""
    x = torch.as_tensor(np.asarray(images), dtype=torch.float64)[:, None]
    x = x / 255.0
    k = torch.ones((1, 1, 2 * radius + 1, 2 * radius + 1),
                   dtype=torch.float64) / (2 * radius + 1) ** 2
    m = torch.nn.functional.conv2d(x, k, padding=radius)
    m2 = torch.nn.functional.conv2d(x * x, k, padding=radius)
    dev = torch.sqrt(torch.clamp(m2 - m * m, min=0.0))[:, 0]
    return (dev > sd).numpy()


def errors(maps: Dict[str, Tuple[np.ndarray, np.ndarray]], truth: dict,
           mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Relative depth errors and normal angles (degrees) of every judged
    pixel."""
    dep, ang = [], []
    for k, name in enumerate(truth["names"]):
        gt = truth["depth"][k]
        seen = (gt > 0) & mask[k]
        if name not in maps:
            dep.append(np.full(int(seen.sum()), np.inf))
            ang.append(np.full(int(seen.sum()), 180.0))
            continue
        depth, normal = maps[name]
        d = np.asarray(depth, np.float64)[seen]
        g = gt[seen].astype(np.float64)
        est = d > 0
        dep.append(np.where(est, np.abs(d - g) / np.where(est, g, 1.0),
                            np.inf))
        n = np.asarray(normal, np.float64)[seen]
        nt = truth["normal"][k][seen].astype(np.float64)
        norm = np.linalg.norm(n, axis=-1)
        cos = np.sum(n * nt, -1) / np.maximum(norm, 1e-12)
        a = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
        ang.append(np.where(est & (norm > 0), a, 180.0))
    return np.concatenate(dep), np.concatenate(ang)


def judge(maps: Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]],
          truth: dict, window_radius: int, texture_sd: float) -> dict:
    """`maps`: {pass: {frame name: (depth (H, W), normal (H, W, 3))}};
    `truth`: images (n, H, W) uint8, depth (n, H, W), normal
    (n, H, W, 3), names."""
    mask = textured(truth["images"], window_radius, texture_sd)
    out = {}
    for kind, m in maps.items():
        dep, ang = errors(m, truth, mask)
        out[f"{kind}_depth_err_p50"] = float(np.median(dep))
        out[f"{kind}_normal_err_p50_deg"] = float(np.median(ang))
        out[f"{kind}_normal_within10_share"] = float(np.mean(ang < 10.0))
    return out
