"""Feature-level correspondence graph with CSR storage.

Copy of colmap_tpu/scene/correspondence_graph.py (reference:
scene/correspondence_graph.h:42-110): per (image, feature) the flat range of
corresponding (image, feature) pairs, plus per-pair correspondence counts.
Host-side numpy; the mapper reads slices out of it to form device batches.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from colmap_tpu_torch import native


class CorrespondenceGraph:
    def __init__(self):
        # per image: dict of raw match arrays keyed by other image
        self._matches: Dict[Tuple[int, int], np.ndarray] = {}
        self._num_observations: Dict[int, int] = {}
        self._num_correspondences: Dict[int, int] = {}
        self.finalized = False

    # -- build phase --------------------------------------------------------
    def add_image(self, image_id: int, num_features: int):
        self._num_observations[image_id] = num_features

    def add_correspondences(self, image_id1: int, image_id2: int, matches: np.ndarray):
        """matches: (K, 2) feature index pairs (columns follow arg order)."""
        if image_id1 == image_id2:
            return
        if image_id1 > image_id2:
            image_id1, image_id2 = image_id2, image_id1
            matches = matches[:, ::-1]
        self._matches[(image_id1, image_id2)] = np.ascontiguousarray(
            matches, np.int32)

    def finalize(self):
        """Build the feature -> [(other_image, other_feat)] CSR with one
        global sort over all 2E edge rows keyed by global feature slot."""
        img_ids = sorted(self._num_observations)
        idx_of = {iid: k for k, iid in enumerate(img_ids)}
        nf = np.array([self._num_observations[i] for i in img_ids], np.int64)
        base = np.concatenate([[0], np.cumsum(nf)])  # global feature slots
        n_bins = int(base[-1])

        total = 2 * sum(len(m) for m in self._matches.values())
        key = np.empty(total, np.int64)
        oimg = np.empty(total, np.int32)
        ofeat = np.empty(total, np.int32)
        pos = 0
        for (i1, i2), m in self._matches.items():
            k = len(m)
            if k == 0:
                continue
            key[pos:pos + k] = base[idx_of[i1]] + m[:, 0]
            oimg[pos:pos + k] = i2
            ofeat[pos:pos + k] = m[:, 1]
            pos += k
            key[pos:pos + k] = base[idx_of[i2]] + m[:, 1]
            oimg[pos:pos + k] = i1
            ofeat[pos:pos + k] = m[:, 0]
            pos += k

        offsets, order = native.build_csr(key[:pos], n_bins)
        self._g_offsets = offsets          # (n_bins + 1,)
        self._g_imgs = oimg[:pos][order]   # (E2,) int32
        self._g_feats = ofeat[:pos][order]
        self._base = {iid: (int(base[k]), int(nf[k]))
                      for k, iid in enumerate(img_ids)}
        self._csr: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        for iid in img_ids:
            b, n = self._base[iid]
            self._num_correspondences[iid] = int(
                self._g_offsets[b + n] - self._g_offsets[b])
        self.finalized = True

    def _image_csr(self, image_id: int):
        """Per-image view (offsets (F+1) local, imgs (E,), feats (E,));
        rebased lazily from the global CSR and cached."""
        got = self._csr.get(image_id)
        if got is None:
            b, n = self._base[image_id]
            lo, hi = int(self._g_offsets[b]), int(self._g_offsets[b + n])
            offsets = self._g_offsets[b:b + n + 1] - lo
            got = (offsets, self._g_imgs[lo:hi], self._g_feats[lo:hi])
            self._csr[image_id] = got
        return got

    # -- queries -------------------------------------------------------------
    def image_ids(self):
        return list(self._num_observations)

    def num_correspondences_for_image(self, image_id: int) -> int:
        return self._num_correspondences.get(image_id, 0)

    def num_correspondences_between(self, image_id1: int, image_id2: int) -> int:
        if image_id1 > image_id2:
            image_id1, image_id2 = image_id2, image_id1
        m = self._matches.get((image_id1, image_id2))
        return 0 if m is None else len(m)

    def image_pairs(self):
        return list(self._matches.keys())

    def find_correspondences(self, image_id: int, point2D_idx: int):
        """-> (other_image_ids (K,), other_feat_idx (K,)) numpy views."""
        offsets, imgs, feats = self._image_csr(image_id)
        a, b = offsets[point2D_idx], offsets[point2D_idx + 1]
        return imgs[a:b], feats[a:b]

    def find_correspondences_all(self, image_id: int):
        """CSR arrays for a whole image: (offsets (F+1,), imgs (E,), feats (E,))."""
        return self._image_csr(image_id)

    def has_correspondences(self, image_id: int, point2D_idx: int) -> bool:
        offsets, _, _ = self._image_csr(image_id)
        return offsets[point2D_idx + 1] > offsets[point2D_idx]

    def find_transitive_correspondences(self, image_id: int, point2D_idx: int,
                                        transitivity: int = 2):
        """BFS up to `transitivity` hops (reference: FindTransitiveCorrespondences)."""
        seen = {(image_id, int(point2D_idx))}
        frontier = [(image_id, int(point2D_idx))]
        out_imgs, out_feats = [], []
        for _ in range(transitivity):
            nxt = []
            for (ii, ff) in frontier:
                imgs, feats = self.find_correspondences(ii, ff)
                for oi, of in zip(imgs, feats):
                    key = (int(oi), int(of))
                    if key not in seen:
                        seen.add(key)
                        nxt.append(key)
                        out_imgs.append(int(oi))
                        out_feats.append(int(of))
            frontier = nxt
            if not frontier:
                break
        return np.array(out_imgs, np.int64), np.array(out_feats, np.int64)
