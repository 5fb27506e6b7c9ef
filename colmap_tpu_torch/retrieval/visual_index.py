"""Vocab-tree visual index: build / index / query with Hamming embedding.

Port of colmap_tpu/retrieval/visual_index.py (reference:
src/colmap/retrieval/visual_index.h:46-118). The vocabulary's hierarchical
k-means and the quantiser run on the index's device (retrieval/kmeans.py);
the Hamming-embedding projection, the per-word median thresholds, the
inverted files and the TF-IDF x Hamming scoring stay host numpy, as in the
JAX package. `save` / `load` use the JAX package's .npz layout, so an index
written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from colmap_tpu_torch.retrieval import kmeans as km

_HE_BITS = 64
_HE_WORDS = _HE_BITS // 32  # packed uint32 lanes

_POPCNT16 = np.array([bin(i).count("1") for i in range(1 << 16)], np.uint8)


def _popcount_u32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    return (_POPCNT16[x & 0xFFFF].astype(np.int64)
            + _POPCNT16[x >> 16].astype(np.int64))


@dataclasses.dataclass
class VisualIndexOptions:
    branching: int = 16
    depth: int = 3  # vocabulary size = branching**depth
    num_checks: int = 1  # tree descent paths (1 = greedy, like FLANN default)
    hamming_max_distance: int = 24  # HE acceptance radius (bits)
    hamming_sigma: float = 16.0  # Gaussian weighting of hamming distances


class VisualIndex:
    """Build once from training descriptors, then index images and query.
    Quantisation runs on `device`."""

    def __init__(self, options: VisualIndexOptions = VisualIndexOptions(),
                 device="cuda"):
        self.options = options
        self.device = device
        self.levels: Optional[List[np.ndarray]] = None
        self.proj: Optional[np.ndarray] = None  # [64, 128] HE projection
        self.thresholds: Optional[np.ndarray] = None  # [num_words, 64]
        self.num_words = options.branching ** options.depth
        # inverted files: word -> (image ids, packed [2] u32 signatures)
        self._entries_img: Dict[int, List[int]] = {}
        self._entries_sig: Dict[int, List[np.ndarray]] = {}
        self._image_num_features: Dict[int, int] = {}
        self._word_df = np.zeros(self.num_words, np.int64)  # document freq
        self._tables: Optional[List[torch.Tensor]] = None  # levels on device

    # -- build ---------------------------------------------------------------

    def build(self, descriptors: np.ndarray, seed: int = 0):
        """Train the vocabulary (reference: VisualIndex::Build)."""
        rng = np.random.default_rng(seed)
        desc = self._prep(descriptors)
        self.levels = km.hierarchical_kmeans(
            rng, desc, self.options.branching, self.options.depth,
            device=self.device)
        self._tables = None
        # Hamming embedding: random orthogonal projection + per-word medians
        A = rng.normal(size=(128, 128)).astype(np.float32)
        q, _ = np.linalg.qr(A)
        self.proj = q[:_HE_BITS].astype(np.float32)
        words = self._quantize(desc)
        proj_desc = desc @ self.proj.T  # [N, 64]
        self.thresholds = np.zeros((self.num_words, _HE_BITS), np.float32)
        global_med = np.median(proj_desc, axis=0)
        for wid in range(self.num_words):
            m = words == wid
            if m.sum() >= 4:
                self.thresholds[wid] = np.median(proj_desc[m], axis=0)
            else:
                self.thresholds[wid] = global_med

    @staticmethod
    def _prep(descriptors: np.ndarray) -> np.ndarray:
        d = np.asarray(descriptors, np.float32)
        if descriptors.dtype == np.uint8:
            d = d / 512.0
        return d

    def _quantize(self, desc: np.ndarray) -> np.ndarray:
        if self._tables is None:
            self._tables = [torch.as_tensor(t, device=self.device)
                            for t in self.levels]
        return km.quantize(self._tables, desc, device=self.device)

    def _signatures(self, desc: np.ndarray, words: np.ndarray) -> np.ndarray:
        """Packed [N, 2] uint32 Hamming signatures."""
        proj = desc @ self.proj.T  # [N, 64]
        bits = (proj > self.thresholds[words]).astype(np.uint32)
        packed = np.zeros((len(desc), _HE_WORDS), np.uint32)
        for i in range(_HE_BITS):
            packed[:, i // 32] |= bits[:, i] << np.uint32(i % 32)
        return packed

    # -- index / query ---------------------------------------------------------

    def add_image(self, image_id: int, descriptors: np.ndarray):
        desc = self._prep(descriptors)
        words = self._quantize(desc)
        sigs = self._signatures(desc, words)
        self._image_num_features[image_id] = len(desc)
        seen = set()
        for w, s in zip(words, sigs):
            w = int(w)
            self._entries_img.setdefault(w, []).append(image_id)
            self._entries_sig.setdefault(w, []).append(s)
            if w not in seen:
                self._word_df[w] += 1
                seen.add(w)

    @property
    def num_images(self) -> int:
        return len(self._image_num_features)

    def query(self, descriptors: np.ndarray, num_neighbors: int = 10,
              exclude: Optional[int] = None) -> List[Tuple[int, float]]:
        """TF-IDF + Hamming-weighted scoring (reference: VisualIndex::Query)."""
        if self.num_images == 0:
            return []
        desc = self._prep(descriptors)
        words = self._quantize(desc)
        sigs = self._signatures(desc, words)
        n_img = max(self.num_images, 1)
        scores: Dict[int, float] = {}
        sigma2 = self.options.hamming_sigma ** 2
        for w, s in zip(words, sigs):
            w = int(w)
            imgs = self._entries_img.get(w)
            if not imgs:
                continue
            df = max(int(self._word_df[w]), 1)
            idf = np.log(n_img / df)
            entry_sigs = np.stack(self._entries_sig[w])  # [m, 2] u32
            x = entry_sigs ^ s[None, :]
            dist = np.zeros(len(imgs), np.int64)
            for lane in range(_HE_WORDS):
                dist += _popcount_u32(x[:, lane])
            wgt = np.where(dist <= self.options.hamming_max_distance,
                           np.exp(-dist.astype(np.float64) ** 2 / sigma2), 0.0)
            for img, g in zip(imgs, wgt):
                if g > 0 and img != exclude:
                    scores[img] = scores.get(img, 0.0) + idf * idf * float(g)
        # normalize by sqrt of self-score proxies (feature counts)
        out = []
        nq = max(len(desc), 1)
        for img, sc in scores.items():
            norm = np.sqrt(nq * max(self._image_num_features.get(img, 1), 1))
            out.append((img, sc / norm))
        out.sort(key=lambda kv: -kv[1])
        return out[:num_neighbors]

    # -- persistence -----------------------------------------------------------

    def save(self, path: str):
        flat = {f"level{i}": lvl for i, lvl in enumerate(self.levels)}
        np.savez_compressed(
            path, proj=self.proj, thresholds=self.thresholds,
            num_levels=len(self.levels),
            branching=self.options.branching, depth=self.options.depth,
            **flat)

    @classmethod
    def load(cls, path: str, device="cuda") -> "VisualIndex":
        z = np.load(path)
        opts = VisualIndexOptions(branching=int(z["branching"]),
                                  depth=int(z["depth"]))
        vi = cls(opts, device=device)
        vi.levels = [z[f"level{i}"] for i in range(int(z["num_levels"]))]
        vi.proj = z["proj"]
        vi.thresholds = z["thresholds"]
        return vi


def build_vocab_tree_from_database(database, options: VisualIndexOptions,
                                   max_descriptors: int = 100_000,
                                   seed: int = 0,
                                   device="cuda") -> VisualIndex:
    """reference: RunVocabTreeBuilder (exe/vocab_tree.cc:119) — random
    subsample of DB descriptors; the vocabulary is trained on `device`."""
    rng = np.random.default_rng(seed)
    chunks = []
    for iid in database.read_images():
        d = database.read_descriptors(iid)
        if d is not None and len(d):
            chunks.append(d)
    if not chunks:
        raise ValueError("database has no descriptors")
    desc = np.concatenate(chunks)
    if len(desc) > max_descriptors:
        desc = desc[rng.choice(len(desc), max_descriptors, replace=False)]
    vi = VisualIndex(options, device=device)
    vi.build(desc, seed=seed)
    return vi


def vocab_tree_pairs(database, visual_index: VisualIndex,
                     num_neighbors: int = 5) -> List[Tuple[int, int]]:
    """VocabTree pair generation (reference: VocabTreePairGenerator,
    feature/pairing.h): index all images, query each for its retrieval
    neighbors."""
    ids = sorted(database.read_images().keys())
    for iid in ids:
        d = database.read_descriptors(iid)
        if d is not None and len(d):
            visual_index.add_image(iid, d)
    pairs = set()
    for iid in ids:
        d = database.read_descriptors(iid)
        if d is None or len(d) == 0:
            continue
        for other, _ in visual_index.query(d, num_neighbors, exclude=iid):
            pairs.add(tuple(sorted((iid, other))))
    return sorted(pairs)
