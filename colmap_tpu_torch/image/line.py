"""Line segment detection.

Port of colmap_tpu/image/line.py (reference: src/colmap/image/line.cc:34-69,
a wrapper over the vendored LSD detector), used by the Manhattan-world
coordinate-frame estimation. Host code: OpenCV's line segment detector,
with a Canny + HoughLinesP fallback, in the JAX package's calls and order,
so both give the same segments. Without OpenCV the JAX package returns no
segments, which its callers read as "too few line segments"; the port
raises ImportError instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LineSegment:
    start: np.ndarray  # (2,)
    end: np.ndarray  # (2,)

    @property
    def direction(self) -> np.ndarray:
        d = self.end - self.start
        n = np.linalg.norm(d)
        return d / n if n > 0 else d

    @property
    def length(self) -> float:
        return float(np.linalg.norm(self.end - self.start))


def detect_line_segments(image: np.ndarray, min_length: float = 20.0):
    """Detect 2D line segments in a grayscale image (uint8 or [0,1] f32).

    Returns a list of LineSegment (reference: DetectLineSegments). Raises
    ImportError when OpenCV (`cv2`) is not installed."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    try:
        import cv2
    except ImportError as e:
        raise ImportError("detect_line_segments needs OpenCV (cv2)") from e

    segments = []
    try:
        lsd = cv2.createLineSegmentDetector()
    except Exception:  # builds without the LSD detector
        lsd = None
    if lsd is not None:
        try:
            lines = lsd.detect(img)[0]
        except Exception:
            lines = None
        if lines is not None:
            for line in lines.reshape(-1, 4):
                seg = LineSegment(start=np.array(line[:2], float),
                                  end=np.array(line[2:], float))
                if seg.length >= min_length:
                    segments.append(seg)
            return segments

    edges = cv2.Canny(img, 50, 150)
    lines = cv2.HoughLinesP(edges, 1, np.pi / 180, threshold=50,
                            minLineLength=int(min_length), maxLineGap=4)
    if lines is not None:
        for line in lines.reshape(-1, 4):
            segments.append(LineSegment(start=np.array(line[:2], float),
                                        end=np.array(line[2:], float)))
    return segments
