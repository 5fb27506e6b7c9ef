"""Plain reference judge of the four-card dense cell: the plain judge's
pooled readings and, per pass, the worst frame's.

It takes `textured` and `errors` from `reference/dense.py` unchanged and
judges the same pixels (`textured` a band of rows at a time, the same
bits): every pixel of a frame that sees a surface and has
texture in its matching window, a frame without a map counting all its
pixels as infinite errors. Pooled over every frame's pixels it gives
`dense.py`'s readings; per frame it takes the median relative depth error
and reads

- `<pass>_depth_err_p50_worst_frame`: the highest of those medians over
  the frames.

A pooled median hides a few bad frames: with one card of four lost, a
quarter of the judged pixels are infinite and the median of the rest
still passes. The worst frame's median does not: a frame whose map is
missing, zeroed or another frame's reads infinite or far off.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.reference.dense import errors, textured

BAND = 40  # rows of a frame whose mask one `textured` call computes


def mask(image: np.ndarray, radius: int, sd: float) -> np.ndarray:
    """(H, W) bool: `textured` of one frame, computed in bands of `BAND`
    rows, each given the `radius` rows around it, so a band's windows see
    what the whole frame's do. The same bits as one call on the frame, in
    half the time: a band's unfolded windows stay in the cache."""
    H = image.shape[0]
    out = []
    for y in range(0, H, BAND):
        lo, hi = max(y - radius, 0), min(y + BAND + radius, H)
        m = textured(image[None, lo:hi], radius, sd)[0]
        out.append(m[y - lo:y - lo + min(BAND, H - y)])
    return np.concatenate(out)


def judge(maps: Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]],
          truth: dict, window_radius: int, texture_sd: float) -> dict:
    """`maps`: {pass: {frame name: (depth (H, W), normal (H, W, 3))}};
    `truth`: images (n, H, W) uint8, depth (n, H, W), normal
    (n, H, W, 3), names."""
    n = len(truth["names"])

    def frame_mask(k):
        return mask(truth["images"][k], window_radius, texture_sd)[None]

    def frame(m, k):
        one = {"names": [truth["names"][k]], "depth": truth["depth"][k:k + 1],
               "normal": truth["normal"][k:k + 1]}
        return errors(m, one, masks[k])

    # a frame a thread (torch's convolution and numpy's loops let go of
    # the interpreter), each convolution on its own thread alone: torch's
    # own threads on top of the pool's would contend for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(min(n, os.cpu_count() or 1)) as pool:
            masks = list(pool.map(frame_mask, range(n)))
            per_pass = {kind: list(pool.map(lambda k, m=m: frame(m, k),
                                            range(n)))
                        for kind, m in maps.items()}
    finally:
        torch.set_num_threads(threads)
    out = {}
    for kind, per in per_pass.items():
        dep = np.concatenate([d for d, _ in per])
        ang = np.concatenate([a for _, a in per])
        out[f"{kind}_depth_err_p50"] = float(np.median(dep))
        out[f"{kind}_normal_err_p50_deg"] = float(np.median(ang))
        out[f"{kind}_normal_within10_share"] = float(np.mean(ang < 10.0))
        # a frame with no judged pixel is not judged well
        out[f"{kind}_depth_err_p50_worst_frame"] = max(
            float(np.median(d)) if d.size else np.inf for d, _ in per)
    return out
