"""MVS workspace model: per-image pinhole calibration, depth ranges,
source-image selection.

Port of colmap_tpu/mvs/model.py (reference: src/colmap/mvs/model.h:48,
Model::Read, ComputeDepthRanges, GetMaxOverlappingImages), host numpy over
the port's undistorted (PINHOLE) Reconstruction. Rotations come from
`geometry.rotation.quat_to_rotmat` in float64, as the JAX module's own
float64 formula gives them.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Tuple

import numpy as np
import torch

from colmap_tpu_torch.geometry import rotation
from colmap_tpu_torch.scene.reconstruction import Reconstruction


@dataclasses.dataclass
class MVSImage:
    image_id: int
    name: str
    K: np.ndarray  # (3, 3)
    R: np.ndarray  # (3, 3) world->cam
    t: np.ndarray  # (3,)
    width: int
    height: int

    @property
    def P(self) -> np.ndarray:
        return self.K @ np.concatenate([self.R, self.t[:, None]], axis=1)

    def center(self) -> np.ndarray:
        return -self.R.T @ self.t


@dataclasses.dataclass
class MVSModel:
    images: Dict[int, MVSImage]
    depth_ranges: Dict[int, Tuple[float, float]]
    overlap_scores: Dict[int, List[Tuple[int, float]]]  # ref -> [(src, score)]

    def src_images(self, ref_id: int, max_num: int = 20) -> List[int]:
        """Best source images by shared-point score (reference:
        PatchMatchController src selection '__auto__', patch_match.cc).

        Images with no shared sparse points (late registrations) fall back
        to the nearest cameras by projection center, so every reference
        image still gets stereo sources.
        """
        srcs = [i for i, _ in self.overlap_scores.get(ref_id, [])[:max_num]]
        if srcs or ref_id not in self.images:
            return srcs
        c = self.images[ref_id].center()
        others = sorted(
            (iid for iid in self.images if iid != ref_id),
            key=lambda iid: float(np.linalg.norm(self.images[iid].center() - c)))
        return others[:max_num]


# pairs of one track length handled at once (bounds the temporaries)
_PAIR_CHUNK = 1 << 18


def _observations(rec: Reconstruction, ids: List[int]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The tracks flattened, in point order and then in track order, with
    only the observations in images of `ids`: each one's image (its index
    in `ids`) and point (its index in `rec.points3D`'s order), and the
    points' coordinates (P, 3) in float64."""
    points = list(rec.points3D.values())
    length = np.fromiter((len(p.track) for p in points), np.int64,
                         len(points))
    flat = np.fromiter(itertools.chain.from_iterable(
        itertools.chain.from_iterable(p.track for p in points)), np.int64,
        2 * int(length.sum()))
    image_id = flat[0::2]
    point = np.repeat(np.arange(len(points)), length)
    xyz = np.array([p.xyz for p in points], np.float64).reshape(-1, 3)
    if not ids:
        return point[:0], point[:0], xyz
    known = np.asarray(ids, np.int64)
    by_id = np.argsort(known)
    at = by_id[np.minimum(np.searchsorted(known, image_id, sorter=by_id),
                          len(ids) - 1)]
    keep = known[at] == image_id
    return at[keep], point[keep], xyz


def _pair_scores(obs_img: np.ndarray, obs_pt: np.ndarray, xyz: np.ndarray,
                 centers: np.ndarray, num_images: int,
                 max_triangulation_angle_deg: float
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Overlap scores of the image pairs that share a point seen at a
    usable triangulation angle: (pair, score, first). A pair is the key
    min * num_images + max of its two image indices; its score sums
    min(angle / 10, 1) over its usable angles, in track order; `first` is
    the position of the pair's first angle, usable or not, in the stream
    of every track's pairs (points in order, each track's pairs as
    triu_indices gives them)."""
    length = np.bincount(obs_pt, minlength=len(xyz))
    start = np.cumsum(length) - length
    num_pairs = length * (length - 1) // 2
    offset = np.cumsum(num_pairs) - num_pairs
    total = int(num_pairs.sum())
    # the smallest unsigned type that holds the keys: their stable sort is
    # then a radix sort
    key = np.empty(total, np.min_scalar_type(max(num_images ** 2 - 1, 0)))
    weight = np.empty(total)
    usable = np.empty(total, bool)
    ray = xyz[obs_pt] - centers[obs_img]
    ray_norm = np.sqrt(_dot_rows(ray, ray))
    for L in np.unique(length[length > 1]).tolist():
        points = np.flatnonzero(length == L)
        ia, ib = np.triu_indices(L, 1)
        step = max(_PAIR_CHUNK // len(ia), 1)
        for c in range(0, len(points), step):
            p = points[c:c + step]
            oa = (start[p, None] + ia).ravel()
            ob = (start[p, None] + ib).ravel()
            at = (offset[p, None] + np.arange(len(ia))).ravel()
            cosang = _dot_rows(ray[oa], ray[ob]) / np.maximum(
                ray_norm[oa] * ray_norm[ob], 1e-12)
            ang = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
            a, b = obs_img[oa], obs_img[ob]
            key[at] = np.minimum(a, b) * num_images + np.maximum(a, b)
            usable[at] = (ang > 1.0) & (ang < max_triangulation_angle_deg)
            weight[at] = np.minimum(ang / 10.0, 1.0)
    # grouped by pair, each group in stream order
    order = np.argsort(key, kind="stable")
    key, usable = key[order], usable[order]
    head = _group_heads(key)
    ukey = key[usable]
    at = _group_heads(ukey)
    pair = ukey[at]
    # np.sum over each pair's weights, as a sum over that pair alone adds
    # them (add.reduceat adds in another order)
    weight = weight[order][usable]
    score = np.array([np.sum(weight[s:e]) for s, e in
                      zip(at.tolist(), at[1:].tolist() + [len(weight)])])
    return (pair.astype(np.int64), score,
            order[head][np.searchsorted(key[head], pair)])


def _dot_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The dot product of each row of `a` with the same row of `b`,
    through the routine a 1-D `np.dot` calls, so each is the same bits as
    a 1-D dot of the two rows."""
    return np.matmul(a[:, None, :], b[:, :, None])[:, 0, 0]


def _group_heads(keys: np.ndarray) -> np.ndarray:
    """Where each run of equal values of sorted `keys` starts."""
    return np.flatnonzero(np.concatenate([[len(keys) > 0],
                                          keys[1:] != keys[:-1]]))


def build_model(rec: Reconstruction, max_triangulation_angle_deg: float = 90.0
                ) -> MVSModel:
    """Build the MVS model from an undistorted reconstruction.

    Depth ranges from the sparse points (robust percentiles with the
    reference's stretch margins); pairwise overlap scores from shared
    3D points weighted by triangulation angle (reference:
    Model::ComputeDepthRanges / GetMaxOverlappingImages, model.cc), over
    all tracks at once.
    """
    images: Dict[int, MVSImage] = {}
    for iid, img in rec.images.items():
        if not img.registered:
            continue
        cam = rec.cameras[img.camera_id]
        fx, fy, cx, cy = cam.params[:4]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        pose = torch.as_tensor(np.asarray(img.cam_from_world, np.float64))
        R = rotation.quat_to_rotmat(
            pose[:4] / torch.linalg.vector_norm(pose[:4])).numpy()
        images[iid] = MVSImage(image_id=iid, name=img.name, K=K, R=R,
                               t=pose[4:7].numpy().copy(), width=cam.width,
                               height=cam.height)
    ids = list(images)
    n = len(ids)
    obs_img, obs_pt, xyz = _observations(rec, ids)
    R = np.array([images[iid].R for iid in ids]).reshape(-1, 3, 3)
    t = np.array([images[iid].t for iid in ids]).reshape(-1, 3)
    centers = np.array([images[iid].center() for iid in ids]).reshape(-1, 3)

    # reference: Model::ComputeDepthRanges (model.cc:174-215) -
    # 1st/99th percentiles of the depths of the points in front of each
    # image, stretched by kStretchRatio = 0.25
    z = _dot_rows(R[obs_img, 2], xyz[obs_pt]) + t[obs_img, 2]
    front = z > 0
    depths = z[front][np.argsort(obs_img[front], kind="stable")]
    ends = np.cumsum(np.bincount(obs_img[front], minlength=n))
    depth_ranges = {}
    for k, iid in enumerate(ids):
        ds = depths[ends[k - 1] if k else 0:ends[k]]
        if len(ds):
            lo = float(np.percentile(ds, 1)) * 0.75
            hi = float(np.percentile(ds, 99)) * 1.25
            depth_ranges[iid] = (max(lo, 1e-4), hi)
    # images with no visible sparse points search the union of all ranges
    if depth_ranges:
        glo = min(r[0] for r in depth_ranges.values())
        ghi = max(r[1] for r in depth_ranges.values())
    else:
        glo, ghi = 0.1, 100.0
    for iid in ids:
        if iid not in depth_ranges:
            depth_ranges[iid] = (glo, ghi)

    # overlap score: shared points with a usable triangulation angle,
    # weighted to prefer ~10 deg baselines; each image's sources by score,
    # ties in the order their pairs first appear in the tracks
    pair, score, first = _pair_scores(obs_img, obs_pt, xyz, centers, n,
                                      max_triangulation_angle_deg)
    a, b = np.divmod(pair, max(n, 1))
    ref, src = np.concatenate([a, b]), np.concatenate([b, a])
    score, first = np.tile(score, 2), np.tile(first, 2)
    rank = np.lexsort((first, -score, ref))
    cut = np.searchsorted(ref[rank], np.arange(n + 1))
    overlap: Dict[int, List[Tuple[int, float]]] = {}
    for k, iid in enumerate(ids):
        mine = rank[cut[k]:cut[k + 1]]
        overlap[iid] = [(ids[s], float(v))
                        for s, v in zip(src[mine].tolist(), score[mine])]

    return MVSModel(images=images, depth_ranges=depth_ranges,
                    overlap_scores=overlap)
