"""Image-pair generation strategies.

Port of colmap_tpu/features/pairing.py (reference:
src/colmap/feature/pairing.h:177-362: Exhaustive, Sequential, Spatial,
Transitive, Imported; VocabTree is retrieval/visual_index.py). Pair
generation is host logic that feeds fixed-size pair blocks to the batched
matcher; loop detection trains and queries a vocab tree whose k-means and
quantiser run on the given device, and spatial pairing converts GPS priors
in float64.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from colmap_tpu_torch.geometry import gps
from colmap_tpu_torch.retrieval import visual_index as vi_mod

logger = logging.getLogger("colmap_tpu_torch")


@dataclasses.dataclass
class ExhaustivePairingOptions:
    block_size: int = 50  # reference default (feature/pairing.h:42)


def exhaustive_pairs(image_ids: Sequence[int],
                     options: ExhaustivePairingOptions = ExhaustivePairingOptions()
                     ) -> Iterator[List[Tuple[int, int]]]:
    """Yield lower-triangle pair blocks (reference: ExhaustivePairGenerator)."""
    ids = list(image_ids)
    n = len(ids)
    bs = options.block_size
    for start1 in range(0, n, bs):
        end1 = min(start1 + bs, n)
        for start2 in range(0, end1, bs):
            end2 = min(start2 + bs, n)
            block = []
            for i in range(start1, end1):
                for j in range(start2, min(end2, i)):
                    block.append((ids[j], ids[i]))
            if block:
                yield block


@dataclasses.dataclass
class SequentialPairingOptions:
    """Reference: SequentialMatchingOptions (feature/pairing.h:60-120)."""

    overlap: int = 10
    quadratic_overlap: bool = True
    # vocab-tree loop detection: every `loop_detection_period` images the
    # visual index is queried for `loop_detection_num_images` similar
    # images and those pairs are appended (video sequences revisiting a
    # place get loop-closure matches the temporal window misses)
    loop_detection: bool = False
    loop_detection_period: int = 10
    loop_detection_num_images: int = 50
    loop_detection_max_num_features: int = -1
    vocab_tree_path: str = ""


def sequential_pairs(image_ids_in_name_order: Sequence[int],
                     options: SequentialPairingOptions = SequentialPairingOptions()
                     ) -> List[Tuple[int, int]]:
    """Temporal neighbors: i matched to i+1..i+overlap (+ quadratic jumps).

    Reference: SequentialPairGenerator (feature/pairing.cc).
    """
    ids = list(image_ids_in_name_order)
    pairs = []
    n = len(ids)
    for i in range(n):
        for k in range(1, options.overlap + 1):
            if i + k < n:
                pairs.append((ids[i], ids[i + k]))
            if options.quadratic_overlap:
                j = i + (1 << k)
                if j < n and (1 << k) > options.overlap:
                    pairs.append((ids[i], ids[j]))
    return sorted(set(tuple(sorted(p)) for p in pairs))


def sequential_loop_detection_pairs(
        database, image_ids_in_name_order: Sequence[int],
        options: SequentialPairingOptions, seed: int = 0, device="cuda"
) -> List[Tuple[int, int]]:
    """Loop-detection pairs for a sequential sequence.

    Reference: SequentialPairGenerator with loop_detection
    (feature/pairing.h:89-110, pairing.cc): index every image in the
    vocab tree (loaded from `options.vocab_tree_path`, else trained on the
    database's descriptors on `device`), then query it for every
    `loop_detection_period`-th image and emit (query, retrieved) pairs.
    Returns ONLY the retrieval pairs; the temporal ones come from
    `sequential_pairs`.
    """
    ids = list(image_ids_in_name_order)
    t0 = time.perf_counter()
    if options.vocab_tree_path:
        vi = vi_mod.VisualIndex.load(options.vocab_tree_path, device=device)
    else:
        vi = vi_mod.build_vocab_tree_from_database(
            database, vi_mod.VisualIndexOptions(), seed=seed, device=device)
    t1 = time.perf_counter()

    cap = options.loop_detection_max_num_features

    def _desc(iid):
        d = database.read_descriptors(iid)
        if d is not None and cap > 0 and len(d) > cap:
            d = d[:cap]
        return d

    for iid in ids:
        d = _desc(iid)
        if d is not None and len(d):
            vi.add_image(iid, d)
    t2 = time.perf_counter()
    pairs = set()
    num_queries = 0
    for pos, iid in enumerate(ids):
        if (pos + 1) % max(options.loop_detection_period, 1) != 0:
            continue
        d = _desc(iid)
        if d is None or len(d) == 0:
            continue
        num_queries += 1
        for other, _ in vi.query(d, options.loop_detection_num_images,
                                 exclude=iid):
            pairs.add(tuple(sorted((iid, other))))
    logger.info("loop detection: vocab tree %s in %.3f s, %d images indexed "
                "in %.3f s, %d queries in %.3f s, %d pairs",
                "loaded" if options.vocab_tree_path else "built", t1 - t0,
                vi.num_images, t2 - t1, num_queries,
                time.perf_counter() - t2, len(pairs))
    return sorted(pairs)


@dataclasses.dataclass
class SpatialPairingOptions:
    max_num_neighbors: int = 50
    max_distance: float = 100.0
    ignore_z: bool = True


def spatial_pairs(image_ids: Sequence[int], positions: np.ndarray,
                  options: SpatialPairingOptions = SpatialPairingOptions()
                  ) -> List[Tuple[int, int]]:
    """kNN pairs by position (GPS/ENU or prior positions).

    Reference: SpatialPairGenerator (feature/pairing.cc, FLANN kNN) — here a
    dense distance matrix + argpartition (the image count is host-scale).
    """
    ids = list(image_ids)
    pos = np.asarray(positions, np.float64).copy()
    if options.ignore_z and pos.shape[1] >= 3:
        pos[:, 2] = 0.0
    n = len(ids)
    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    k = min(options.max_num_neighbors, n - 1)
    pairs = set()
    for i in range(n):
        nbrs = np.argpartition(d2[i], k - 1)[:k] if k > 0 else []
        for j in nbrs:
            if d2[i, j] <= options.max_distance**2:
                pairs.add(tuple(sorted((ids[i], int(ids[j])))))
    return sorted(pairs)


def transitive_pairs(existing_pairs: Sequence[Tuple[int, int]],
                     batch_size: int = 1000) -> List[Tuple[int, int]]:
    """2-hop closure of the current match graph.

    Reference: TransitivePairGenerator (feature/pairing.cc).
    """
    adj: Dict[int, set] = {}
    existing = set(tuple(sorted(p)) for p in existing_pairs)
    for a, b in existing:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    new_pairs = set()
    for a, nbrs in adj.items():
        for b in nbrs:
            for c in adj.get(b, ()):
                if c != a:
                    p = tuple(sorted((a, c)))
                    if p not in existing:
                        new_pairs.add(p)
                        if len(new_pairs) >= batch_size:
                            return sorted(new_pairs)
    return sorted(new_pairs)


def imported_pairs(path: str, name_to_id: Dict[str, int]) -> List[Tuple[int, int]]:
    """Pair list file: two image names per line (reference: ImportedPairGenerator)."""
    pairs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            a, b = name_to_id.get(parts[0]), name_to_id.get(parts[1])
            if a is not None and b is not None and a != b:
                pairs.append(tuple(sorted((a, b))))
    return sorted(set(pairs))


def spatial_pairs_from_database(database,
                                options: SpatialPairingOptions = SpatialPairingOptions(),
                                device="cuda") -> List[Tuple[int, int]]:
    """Spatial pairs from pose priors stored in the database.

    Reference: SpatialPairGenerator reading pose_priors / GPS
    (feature/pairing.cc). WGS84 coordinates are converted to a local ENU
    frame first (geometry/gps.py), in float64 on `device`.
    """
    priors = database.read_pose_priors()
    ids = sorted(priors.keys())
    if len(ids) < 2:
        return []
    pos = np.stack([np.asarray(priors[i]["position"], np.float64) for i in ids])
    system = priors[ids[0]].get("coordinate_system", 0)
    if system == 1:  # WGS84 lat/lon/alt
        pos = gps.ell_to_enu(torch.as_tensor(pos, device=device)).cpu().numpy()
    return spatial_pairs(ids, pos, options)
