"""Incremental mapper: the outer SfM loop.

Port of colmap_tpu/sfm/incremental_mapper.py (reference:
sfm/incremental_mapper.h:63-340, with the IncrementalTriangulator and
ObservationManager responsibilities folded in). The working state lives in
flat numpy arrays on the host: poses (I, 7), one flat keypoint / ray /
point-id table over all images, and an append-only observation tableau
(obs_img_row, obs_feat, obs_pid), so every decision step is a vectorized
scan. Device work runs on the mapper's `device`, batched per round:

  * PnP registration of a whole candidate batch -> one batched P3P
    LO-RANSAC call (estimators/absolute_pose over optim/ransac),
  * triangulation of every new track candidate of the round -> one batched
    two-view DLT call,
  * the initial pair's two-view geometry -> estimators/two_view_geometry,
  * local and global BA -> estimators/bundle_adjustment,
  * rays after intrinsics refinement -> sensor/models.cam_from_img.

Track continuation, completion, merging and filtering stay vectorized host
numpy, as in the JAX package. All random draws come from one
torch.Generator on the device, seeded from `seed`.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from colmap_tpu_torch import native
from colmap_tpu_torch.estimators import absolute_pose as apose
from colmap_tpu_torch.estimators import bundle_adjustment as ba
from colmap_tpu_torch.estimators import two_view_geometry as tvg
from colmap_tpu_torch.geometry import rigid3
from colmap_tpu_torch.geometry.triangulation import (
    calculate_triangulation_angle,
    triangulate_point,
)
from colmap_tpu_torch.optim.ransac import RansacOptions, ransac
from colmap_tpu_torch.parallel import distributed_ba as dba
from colmap_tpu_torch.parallel.mesh import shard_mesh
from colmap_tpu_torch.scene.database_cache import DatabaseCache
from colmap_tpu_torch.scene.reconstruction import (
    Point3D,
    Reconstruction,
    Image as RecImage,
)
from colmap_tpu_torch.sensor import models as camera_models


# ---------------------------------------------------------------------------
# options
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IncrementalMapperOptions:
    """Defaults mirror the reference (sfm/incremental_mapper.h:63-160)."""

    init_min_num_inliers: int = 100
    init_max_error: float = 4.0
    init_max_forward_motion: float = 0.95
    init_min_tri_angle_deg: float = 16.0
    abs_pose_max_error: float = 12.0
    abs_pose_min_num_inliers: int = 30
    abs_pose_min_inlier_ratio: float = 0.25
    filter_max_reproj_error: float = 4.0
    filter_min_tri_angle_deg: float = 1.5
    create_min_tri_angle_deg: float = 1.5  # triangulator min angle
    continue_max_reproj_error: float = 4.0
    merge_max_reproj_error: float = 4.0  # triangulator MergeTracks
    complete_max_reproj_error: float = 4.0  # triangulator CompleteTracks
    local_ba_num_images: int = 6
    min_track_len: int = 2
    max_reg_trials: int = 3
    # image filtering (reference ObservationManager::FilterImages,
    # observation_manager.h:144-160): deregister images whose refined
    # intrinsics go bogus or that lost all their 3D points
    min_focal_length_ratio: float = 0.1
    max_focal_length_ratio: float = 10.0
    max_extra_param: float = 1.0
    # registration batch: up to this many candidates PnP-register in one
    # batched device call per round (host decisions stay per-image)
    max_batch_size: int = 16
    # flag parity with the JAX package, which declares it and never reads
    # it either: host work is vectorized, not threaded
    num_threads: int = -1
    # devices for global BA: > 1 shards every global BA of a model with at
    # least that many images by pose over a device mesh
    # (parallel/distributed_ba.py); 0 = every local card
    num_devices: int = 1


# ---------------------------------------------------------------------------
# batched device helpers
# ---------------------------------------------------------------------------


def _pnp_ransac_batch(generator: torch.Generator, points3d: torch.Tensor,
                      rays: torch.Tensor, valid: torch.Tensor,
                      err_norms: torch.Tensor, num_samples: int = 1024):
    """Register a candidate batch: P3P LO-RANSAC, then a 10-step GN polish,
    residuals in normalized coords.

    Shapes: points3d (K, N, 3), rays (K, N, 2), valid (K, N), err_norms
    (K,). Returns (poses (K, 7), inliers (K, N)) as numpy arrays.
    `num_samples` is the hypothesis budget: registration first tries 256
    samples and retries only the failed candidates at 1024 (the analog of
    the reference's dynamic trial count, optim/ransac.h:77)."""
    scale = 1.0 / torch.clamp(err_norms, min=1e-12) ** 2

    def scaled_res(model, data):
        r = apose.residuals(model, data)
        return r * scale.reshape((-1,) + (1,) * (r.dim() - 1))

    res = ransac(generator, apose.solve_p3p, scaled_res, apose.refit,
                 (points3d, rays), valid, 3,
                 RansacOptions(max_error=1.0, num_samples=num_samples,
                               lo_iterations=3))
    w = res.inlier_mask.to(points3d.dtype)
    pose = apose.gn_refine_pose(res.model, points3d, rays, w, num_iters=10)
    # inliers again after the polish
    inliers = (scaled_res(pose, (points3d, rays)) < 1.0) & valid
    return pose.cpu().numpy(), inliers.cpu().numpy()


def _triangulate_pairs(poses1, poses2, rays1, rays2, device) -> np.ndarray:
    """Batched two-view DLT triangulation of K candidate pairs (numpy
    inputs, float32 on `device`). Returns one (8, K) numpy array: world
    points (3) + tri angle + depths (2) + reprojection errors (2,
    normalized coords)."""
    poses1, poses2, rays1, rays2 = (
        torch.as_tensor(np.asarray(a, np.float32), device=device)
        for a in (poses1, poses2, rays1, rays2))
    X = triangulate_point(poses1, poses2, rays1, rays2)
    angle = calculate_triangulation_angle(
        rigid3.projection_center(poses1), rigid3.projection_center(poses2), X)
    pc1 = rigid3.apply(poses1, X)
    pc2 = rigid3.apply(poses2, X)
    z1, z2 = pc1[:, 2], pc2[:, 2]

    def err(pc, z, rays):
        z = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
        return torch.linalg.norm(pc[:, :2] / z[:, None] - rays, dim=-1)

    return torch.cat([X.T, torch.stack([angle, z1, z2, err(pc1, z1, rays1),
                                        err(pc2, z2, rays2)])]).cpu().numpy()


# ---------------------------------------------------------------------------
# host-side vectorized quaternion math (the decision-path geometry runs on
# the host tables)
# ---------------------------------------------------------------------------


def _np_quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate v (N, 3) by unit quaternions q (N, 4) [w x y z]."""
    qv = q[:, 1:4]
    t = 2.0 * np.cross(qv, v)
    return v + q[:, :1] * t + np.cross(qv, t)


def _np_pose_apply(poses: np.ndarray, X: np.ndarray) -> np.ndarray:
    """cam_from_world poses (N, 7) applied to world points X (N, 3)."""
    q = poses[:, :4] / np.maximum(
        np.linalg.norm(poses[:, :4], axis=-1, keepdims=True), 1e-12)
    return _np_quat_rotate(q, X) + poses[:, 4:7]


def _np_projection_center(poses: np.ndarray) -> np.ndarray:
    q = poses[:, :4] / np.maximum(
        np.linalg.norm(poses[:, :4], axis=-1, keepdims=True), 1e-12)
    q_conj = q * np.array([1.0, -1, -1, -1])
    return -_np_quat_rotate(q_conj, poses[:, 4:7])


# ---------------------------------------------------------------------------
# the mapper
# ---------------------------------------------------------------------------


class IncrementalMapper:
    def __init__(self, cache: DatabaseCache,
                 options: IncrementalMapperOptions = IncrementalMapperOptions(),
                 seed: int = 0, device="cuda"):
        self.cache = cache
        self.options = options
        self.device = torch.device(device)
        # global BAs shard over this mesh (at most one shard per card
        # present on `cuda`; None: one device); local BAs stay on `device`
        self._mesh = shard_mesh(options.num_devices, self.device)
        # BA sub-timers and counters (seconds of the build / solve / apply
        # phases; calls, LM iterations, CG steps and host synchronizations
        # of local "lba_" and global "gba_" bundle adjustments), reported
        # beside the pipeline's stage seconds
        self.prof = defaultdict(float)
        self.rec = Reconstruction()
        for cam in cache.cameras.values():
            # deep-copy: BA refines rec camera params in place; the cache
            # must stay pristine so it can back other sub-models
            self.rec.add_camera(dataclasses.replace(
                cam, params=np.array(cam.params, np.float64, copy=True)))

        # ---- flat image-side tables ------------------------------------
        ids = sorted(cache.images)
        self._img_ids = np.asarray(ids, np.int64)
        self._row_of: Dict[int, int] = {iid: k for k, iid in enumerate(ids)}
        counts = np.array([len(cache.images[i].xys) for i in ids], np.int64)
        self._kp_off = np.concatenate([[0], np.cumsum(counts)])
        total_kp = int(self._kp_off[-1])
        self._flat_xys = (np.concatenate([cache.images[i].xys for i in ids])
                          if total_kp else np.zeros((0, 2))).astype(np.float64)
        self._flat_rays = (np.concatenate([cache.images[i].rays for i in ids])
                           if total_kp else np.zeros((0, 2))).astype(np.float64)
        # feature -> point id, one flat array; per-image arrays are VIEWS
        self._flat_pids = np.full(total_kp, -1, np.int64)
        for k, iid in enumerate(ids):
            im = cache.images[iid]
            self.rec.add_image(
                RecImage(
                    image_id=im.image_id,
                    name=im.name,
                    camera_id=im.camera_id,
                    cam_from_world=None,
                    xys=im.xys.astype(np.float64),
                    point3D_ids=self._flat_pids[
                        self._kp_off[k]: self._kp_off[k + 1]],
                )
            )
        n_img = len(ids)
        self._poses = np.zeros((n_img, 7), np.float64)
        self._poses[:, 0] = 1.0
        self._reg_mask = np.zeros(n_img, bool)
        self._cam_of_row = np.array(
            [cache.images[i].camera_id for i in ids], np.int64)
        self._focal_arr = np.array(
            [self.rec.cameras[cid].mean_focal_length()
             for cid in self._cam_of_row], np.float64)
        self._db_cam_params: Dict[int, np.ndarray] = {
            cid: np.array(c.params, np.float64, copy=True)
            for cid, c in cache.cameras.items()
        }

        # ---- correspondence graph in row space --------------------------
        # per image row: (offsets (F+1,), other_img_rows (E,), other_feats
        # (E,), edge_feat (E,)) — feature ids are image-local
        self._graph: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
        id_to_row = np.zeros(int(self._img_ids.max()) + 1 if n_img else 1,
                             np.int64)
        id_to_row[self._img_ids] = np.arange(n_img)
        for iid in ids:
            offsets, imgs, feats = cache.graph.find_correspondences_all(iid)
            edge_feat = np.repeat(np.arange(len(offsets) - 1),
                                  np.diff(offsets))
            self._graph.append((offsets, id_to_row[imgs], feats, edge_feat))
        self._neighbors: List[np.ndarray] = [
            np.nonzero(np.bincount(self._graph[r][1], minlength=n_img))[0]
            for r in range(n_img)]
        # global match table: every correspondence edge once, as flat
        # keypoint indices (g = kp_off[row] + feat). Complete/Merge are
        # single vectorized passes over this table instead of per-query
        # CSR expansions (which blow up quadratically on dense graphs).
        n_match = sum(len(m) for m in cache.graph._matches.values())
        self._mg1 = np.empty(n_match, np.int64)
        self._mg2 = np.empty(n_match, np.int64)
        # row of each match endpoint (for registration checks), filled
        # from the pair loop (the endpoints of pair (i1, i2) are by
        # construction in rows r1/r2)
        self._mrow1 = np.empty(n_match, np.int64)
        self._mrow2 = np.empty(n_match, np.int64)
        pos = 0
        for (i1, i2), m in cache.graph._matches.items():
            k = len(m)
            if k == 0:
                continue
            r1, r2 = self._row_of[i1], self._row_of[i2]
            self._mg1[pos:pos + k] = self._kp_off[r1] + m[:, 0]
            self._mg2[pos:pos + k] = self._kp_off[r2] + m[:, 1]
            self._mrow1[pos:pos + k] = r1
            self._mrow2[pos:pos + k] = r2
            pos += k
        # g -> table-row index (both directions): subset passes
        # (per-round complete/merge) touch only the rows of the queried
        # features instead of scanning the whole table
        _, self._mg1_order = native.build_csr(self._mg1, total_kp)
        self._mg1_sorted = self._mg1[self._mg1_order]
        _, self._mg2_order = native.build_csr(self._mg2, total_kp)
        self._mg2_sorted = self._mg2[self._mg2_order]
        # per-feature count of triangulated correspondence partners
        # (reference: ObservationManager's incremental visibility
        # bookkeeping feeding the next-image ranking)
        self._feat_vis = np.zeros(total_kp, np.int32)

        # ---- point / observation store ----------------------------------
        self._xyz = np.zeros((1024, 3), np.float64)
        self._color = np.zeros((1024, 3), np.uint8)
        self._track_len = np.zeros(1024, np.int32)
        self._num_pts = 0
        self._obs_img_row = np.zeros(4096, np.int32)
        self._obs_feat = np.zeros(4096, np.int32)
        self._obs_pid = np.full(4096, -1, np.int64)
        self._num_obs = 0
        self._csr_cache = None
        self._seen_keys = None  # sorted (pid, img) keys of alive obs

        # modified-point tracking (reference: IncrementalTriangulator's
        # modified_point3D_ids_ — Create/Continue/Merge record the touched
        # points and global refinement's CompleteAndMergeTracks consumes
        # the set instead of scanning every track)
        self._dirty_pids: List[np.ndarray] = []
        # incremental merge-candidate pairs: every observation assignment
        # records the match edges that now link two DIFFERENT points
        # (reference: MergeTracks is tried on the triangulator's modified
        # points, incremental_triangulator.cc TryMergeTracks — here the
        # pair set is maintained edge-incrementally so merge never has to
        # rescan the full match table)
        self._pending_merge: List[np.ndarray] = []

        self.registered: List[int] = []
        self.num_reg_trials: Dict[int, int] = {}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

    # ------------------------------------------------------------------
    # small helpers
    # ------------------------------------------------------------------
    def _focal(self, image_id: int) -> float:
        return float(self._focal_arr[self._row_of[image_id]])

    def _rays_of(self, image_id: int) -> np.ndarray:
        r = self._row_of[image_id]
        return self._flat_rays[self._kp_off[r]: self._kp_off[r + 1]]

    def num_points3D(self) -> int:
        return int(np.count_nonzero(self._track_len[: self._num_pts]))

    def invalidate_focal_cache(self):
        """Recompute rays/focals for every image whose camera drifted from
        the DB params: one cam_from_img call on the device per camera."""
        groups: Dict[int, List[int]] = {}
        for r, iid in enumerate(self._img_ids):
            cid = int(self._cam_of_row[r])
            cam = self.rec.cameras[cid]
            self._focal_arr[r] = cam.mean_focal_length()
            if not np.array_equal(np.asarray(cam.params, np.float64),
                                  self._db_cam_params[cid]):
                groups.setdefault(cid, []).append(r)
            else:
                a, b = self._kp_off[r], self._kp_off[r + 1]
                self._flat_rays[a:b] = self.cache.images[int(iid)].rays
        for cid, rows in groups.items():
            cam = self.rec.cameras[cid]
            xys = np.concatenate(
                [self._flat_xys[self._kp_off[r]: self._kp_off[r + 1]]
                 for r in rows]).astype(np.float32)
            rays = camera_models.cam_from_img(
                int(cam.model_id),
                torch.as_tensor(cam.padded_params(), device=self.device),
                torch.as_tensor(xys, device=self.device)).cpu().numpy()
            off = 0
            for r in rows:
                n = int(self._kp_off[r + 1] - self._kp_off[r])
                self._flat_rays[self._kp_off[r]: self._kp_off[r + 1]] = \
                    rays[off: off + n]
                off += n

    # ------------------------------------------------------------------
    # observation store
    # ------------------------------------------------------------------
    def _grow_points(self, need: int):
        cap = len(self._xyz)
        if self._num_pts + need <= cap:
            return
        new_cap = max(cap * 2, self._num_pts + need)
        self._xyz = np.resize(self._xyz, (new_cap, 3))
        self._color = np.resize(self._color, (new_cap, 3))
        tl = np.zeros(new_cap, np.int32)
        tl[: self._num_pts] = self._track_len[: self._num_pts]
        self._track_len = tl

    def _grow_obs(self, need: int):
        cap = len(self._obs_pid)
        if self._num_obs + need <= cap:
            return
        new_cap = max(cap * 2, self._num_obs + need)
        for name in ("_obs_img_row", "_obs_feat"):
            arr = np.zeros(new_cap, getattr(self, name).dtype)
            arr[: self._num_obs] = getattr(self, name)[: self._num_obs]
            setattr(self, name, arr)
        pid = np.full(new_cap, -1, np.int64)
        pid[: self._num_obs] = self._obs_pid[: self._num_obs]
        self._obs_pid = pid

    def _append_obs(self, img_rows: np.ndarray, feats: np.ndarray,
                    pids: np.ndarray) -> int:
        """Bulk-append observations; skips features that already have a
        point or points that already see the image. Returns #appended."""
        if len(img_rows) == 0:
            return 0
        g = self._kp_off[img_rows] + feats
        keep = self._flat_pids[g] < 0
        # reject obs whose point already observes this image (track
        # uniqueness per image, reference Track semantics)
        if keep.any():
            seen = self._point_sees_image(pids[keep], img_rows[keep])
            k2 = np.zeros(len(img_rows), bool)
            k2[np.nonzero(keep)[0][~seen]] = True
            keep = k2
        img_rows, feats, pids, g = (img_rows[keep], feats[keep], pids[keep],
                                    g[keep])
        # a feature may appear twice in one batch: keep first
        _, first = np.unique(g, return_index=True)
        img_rows, feats, pids, g = (img_rows[first], feats[first], pids[first],
                                    g[first])
        # one obs per (point, image) inside the batch too
        key = pids * len(self._img_ids) + img_rows
        _, first = np.unique(key, return_index=True)
        img_rows, feats, pids, g = (img_rows[first], feats[first], pids[first],
                                    g[first])
        n = len(g)
        if n == 0:
            return 0
        self._grow_obs(n)
        s = self._num_obs
        self._obs_img_row[s: s + n] = img_rows
        self._obs_feat[s: s + n] = feats
        self._obs_pid[s: s + n] = pids
        self._num_obs += n
        self._flat_pids[g] = pids
        np.add.at(self._track_len, pids, 1)
        self._bump_feat_vis(g, +1, collect_merge=True)
        self._dirty_pids.append(pids.copy())
        self._csr_cache = None
        self._seen_keys = None
        return n

    def _table_rows_for_g(self, gs: np.ndarray):
        """Table rows whose side-1 / side-2 feature is in `gs`."""
        gs = np.unique(gs)
        out = []
        for sorted_g, order in ((self._mg1_sorted, self._mg1_order),
                                (self._mg2_sorted, self._mg2_order)):
            lo = np.searchsorted(sorted_g, gs)
            hi = np.searchsorted(sorted_g, gs, side="right")
            cnt = hi - lo
            tot = int(cnt.sum())
            idx = np.repeat(lo, cnt) + (
                np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt))
            out.append(order[idx])
        return out[0], out[1]

    def _bump_feat_vis(self, gs: np.ndarray, delta: int,
                       collect_merge: bool = False):
        """Incremental partner-visibility counters for the features
        corresponding to gained/lost observations. With `collect_merge`
        (observation gains only) the same table-row expansion also records
        match edges now linking two different points into the pending
        merge-candidate pool."""
        r1, r2 = self._table_rows_for_g(gs)
        if len(r1):
            np.add.at(self._feat_vis, self._mg2[r1], delta)
        if len(r2):
            np.add.at(self._feat_vis, self._mg1[r2], delta)
        if not collect_merge:
            return
        for rr, ours, theirs in ((r1, self._mg1, self._mg2),
                                 (r2, self._mg2, self._mg1)):
            if not len(rr):
                continue
            pa = self._flat_pids[ours[rr]]
            pb = self._flat_pids[theirs[rr]]
            m = (pa >= 0) & (pb >= 0) & (pa != pb)
            if m.any():
                self._pending_merge.append(
                    np.stack([np.minimum(pa[m], pb[m]),
                              np.maximum(pa[m], pb[m])], axis=1))

    def _point_sees_image(self, pids: np.ndarray, img_rows: np.ndarray
                          ) -> np.ndarray:
        """For each (pid, img_row) query: does pid already observe the image?

        Sorted-key membership over all alive observations (cached with the
        CSR; long tracks made the old per-track-slot loop O(track_len)
        vectorized passes)."""
        if self._seen_keys is None:
            alive = self._obs_pid[: self._num_obs] >= 0
            keys = (self._obs_pid[: self._num_obs][alive]
                    * len(self._img_ids)
                    + self._obs_img_row[: self._num_obs][alive])
            self._seen_keys = np.sort(keys)
        keys = self._seen_keys
        if len(keys) == 0:
            return np.zeros(len(pids), bool)
        q = pids * len(self._img_ids) + img_rows
        idx = np.clip(np.searchsorted(keys, q), 0, len(keys) - 1)
        return keys[idx] == q

    def _point_csr(self):
        """(offsets (num_pts+1,), obs_rows_sorted) over ALIVE observations."""
        if (self._csr_cache is not None
                and len(self._csr_cache[0]) != self._num_pts + 1):
            self._csr_cache = None  # points allocated since the last build
        if self._csr_cache is None:
            alive = np.nonzero(self._obs_pid[: self._num_obs] >= 0)[0]
            offsets, order = native.build_csr(self._obs_pid[alive],
                                              self._num_pts)
            self._csr_cache = (offsets, alive[order])
        return self._csr_cache

    def _remove_obs(self, rows: np.ndarray):
        if len(rows) == 0:
            return
        pids = self._obs_pid[rows]
        g = self._kp_off[self._obs_img_row[rows]] + self._obs_feat[rows]
        keep = self._flat_pids[g] == pids
        self._flat_pids[g[keep]] = -1
        self._obs_pid[rows] = -1
        np.subtract.at(self._track_len, pids, 1)
        self._bump_feat_vis(g[keep], -1)
        self._csr_cache = None
        self._seen_keys = None

    def _delete_points(self, pids: np.ndarray):
        if len(pids) == 0:
            return
        offsets, rows_sorted = self._point_csr()
        chunks = [rows_sorted[offsets[p]: offsets[p + 1]] for p in pids]
        if chunks:
            self._remove_obs(np.concatenate(chunks))
        self._track_len[pids] = 0

    def add_point(self, xyz, track, color=None) -> int:
        """Create one point from a [(image_id, feat), ...] track."""
        self._grow_points(1)
        pid = self._num_pts
        self._num_pts += 1
        self._xyz[pid] = np.asarray(xyz, np.float64)
        if color is not None:
            self._color[pid] = np.asarray(color, np.uint8)
        rows = np.array([self._row_of[iid] for iid, _ in track], np.int32)
        feats = np.array([f for _, f in track], np.int32)
        self._append_obs(rows, feats, np.full(len(rows), pid, np.int64))
        return pid

    def _add_points_bulk(self, X: np.ndarray, rows1, feats1, rows2, feats2
                         ) -> np.ndarray:
        """Create len(X) two-view points at once."""
        n = len(X)
        self._grow_points(n)
        pids = np.arange(self._num_pts, self._num_pts + n, dtype=np.int64)
        self._num_pts += n
        self._xyz[pids] = X
        self._append_obs(
            np.concatenate([rows1, rows2]).astype(np.int32),
            np.concatenate([feats1, feats2]).astype(np.int32),
            np.concatenate([pids, pids]),
        )
        return pids

    # ------------------------------------------------------------------
    # initial pair
    # ------------------------------------------------------------------
    def find_initial_image_pair(self, max_image1: int = 50,
                                max_trials: int = 4000, exclude=()):
        """Two-level candidate iteration, reference semantics
        (FindInitialImagePair + FindFirstInitialImage /
        FindSecondInitialImage, sfm/incremental_mapper.cc): rank image1 by
        total correspondences, then for each image1 try EVERY partner in
        correspondence order. A flat global top-K pair ranking cannot work
        on dense sequences — at 1000 images x 50-frame overlap the
        top ~45k pairs are all small-separation (they fail the 16-degree
        triangulation-angle gate) and the usable wide-baseline partners of
        any image1 rank at the tail of ITS partner list, not in the global
        top ranks. `max_trials` bounds total verifications on degenerate
        scenes.
        """
        graph = self.cache.graph
        partners: Dict[int, List[int]] = {}
        strength: Dict[Tuple[int, int], int] = {}
        for (a, b) in graph.image_pairs():
            n = graph.num_correspondences_between(a, b)
            strength[(a, b)] = n
            partners.setdefault(a, []).append(b)
            partners.setdefault(b, []).append(a)

        def pair_n(a, b):
            return strength.get((a, b), strength.get((b, a), 0))

        img1_rank = sorted(
            partners, key=lambda i: -sum(pair_n(i, j) for j in partners[i]))
        opts = tvg.TwoViewGeometryOptions(
            min_num_inliers=self.options.init_min_num_inliers,
            max_error_px=self.options.init_max_error,
            compute_relative_pose=True,
        )
        exclude = set(exclude)
        trials = 0

        def candidates():
            nonlocal trials
            for i1 in img1_rank[:max_image1]:
                for i2 in sorted(partners[i1], key=lambda j: -pair_n(i1, j)):
                    if trials >= max_trials:
                        return
                    trials += 1
                    yield i1, i2

        for (i1, i2) in candidates():
            if (i1, i2) in exclude or (i2, i1) in exclude:
                continue
            g = self._estimate_pair_geometry(i1, i2, opts)
            if g is None:
                continue
            if int(g.config) not in (
                int(tvg.TwoViewConfig.CALIBRATED),
                int(tvg.TwoViewConfig.UNCALIBRATED),
                # planar/panoramic pairs initialize via homography
                # decomposition; the tri-angle and forward-motion gates
                # below still reject panoramic pairs.
                int(tvg.TwoViewConfig.PLANAR),
                int(tvg.TwoViewConfig.PLANAR_OR_PANORAMIC),
            ):
                continue
            if int(g.num_inliers) < self.options.init_min_num_inliers:
                continue
            if np.degrees(float(g.tri_angle)) < self.options.init_min_tri_angle_deg:
                continue
            pose = np.asarray(g.cam2_from_cam1)
            # forward-motion gate: |tz|/|t| (reference init_max_forward_motion)
            t = pose[4:]
            if np.linalg.norm(t) > 1e-9 and abs(t[2]) / np.linalg.norm(t) > self.options.init_max_forward_motion:
                continue
            return (i1, i2), g
        return None, None

    def _estimate_pair_geometry(self, i1, i2, opts: tvg.TwoViewGeometryOptions):
        m = self.cache.graph._matches.get((min(i1, i2), max(i1, i2)))
        if m is None or len(m) < opts.min_num_inliers:
            return None
        if i1 > i2:
            m = m[:, ::-1]
        r1, r2 = self._row_of[i1], self._row_of[i2]
        xys1 = self._flat_xys[self._kp_off[r1]: self._kp_off[r1 + 1]]
        xys2 = self._flat_xys[self._kp_off[r2]: self._kp_off[r2 + 1]]

        def dev(a):  # one pair: a batch of 1 on the device
            return torch.as_tensor(np.asarray(a, np.float32)[None],
                                   device=self.device)

        g = tvg.estimate_two_view_geometry(
            self._gen, dev(self._rays_of(i1)[m[:, 0]]),
            dev(self._rays_of(i2)[m[:, 1]]), dev(xys1[m[:, 0]]),
            dev(xys2[m[:, 1]]),
            torch.ones((1, len(m)), dtype=torch.bool, device=self.device),
            dev(np.sqrt(self._focal(i1) * self._focal(i2))), opts)
        return tvg.TwoViewGeometry(*(x[0].cpu().numpy() for x in g))

    def _set_pose(self, image_id: int, pose: np.ndarray):
        r = self._row_of[image_id]
        self._poses[r] = pose
        self.rec.images[image_id].cam_from_world = self._poses[r]
        if not self._reg_mask[r]:
            self._reg_mask[r] = True
            self.registered.append(image_id)

    def register_initial_image_pair(self, i1: int, i2: int, g) -> bool:
        """Set identity + relative pose, triangulate the inlier matches."""
        m = self.cache.graph._matches.get((min(i1, i2), max(i1, i2)))
        if i1 > i2:
            m = m[:, ::-1]
        inl = np.asarray(g.inlier_mask)[: len(m)]
        m = m[inl]
        self._set_pose(i1, np.array([1.0, 0, 0, 0, 0, 0, 0]))
        self._set_pose(i2, np.asarray(g.cam2_from_cam1, np.float64))

        r1, r2 = self._row_of[i1], self._row_of[i2]
        packed = _triangulate_pairs(
            np.tile(self._poses[r1], (len(m), 1)),
            np.tile(self._poses[r2], (len(m), 1)),
            self._rays_of(i1)[m[:, 0]], self._rays_of(i2)[m[:, 1]],
            self.device)
        X, (angle, z1, z2, e1, e2) = packed[:3].T, packed[3:8]
        f1, f2 = self._focal(i1), self._focal(i2)
        min_angle = np.radians(self.options.create_min_tri_angle_deg)
        err_px = self.options.filter_max_reproj_error
        n = len(m)
        ok = (
            (angle[:n] > min_angle)
            & (z1[:n] > 0)
            & (z2[:n] > 0)
            & (e1[:n] * f1 < err_px)
            & (e2[:n] * f2 < err_px)
        )
        sel = np.nonzero(ok)[0]
        self._add_points_bulk(
            X[sel].astype(np.float64),
            np.full(len(sel), r1, np.int32), m[sel, 0],
            np.full(len(sel), r2, np.int32), m[sel, 1],
        )
        return int(ok.sum()) >= self.options.init_min_num_inliers // 2

    # ------------------------------------------------------------------
    # next-image selection
    # ------------------------------------------------------------------
    def find_next_images(self, max_images: int = 20) -> List[int]:
        """Rank unregistered images by visible-triangulated-point score.

        Score = visibility-pyramid style: count of features whose
        correspondences touch an existing 3D point, weighted by spatial
        spread over a multi-level grid (reference: VisibilityPyramid,
        scene/visibility_pyramid.h:51; ObservationManager ranking).
        Candidate counts come from the incrementally maintained
        per-feature visibility counters (no per-call scan of the match
        table); the pyramid score runs only on the best candidates.
        """
        g_vis = np.nonzero(self._feat_vis > 0)[0]
        if len(g_vis) == 0:
            return []
        rows = np.searchsorted(self._kp_off, g_vis, side="right") - 1
        counts = np.bincount(rows, minlength=len(self._img_ids))
        counts[self._reg_mask] = 0
        cand_rows = np.nonzero(counts > 0)[0]
        # drop exhausted candidates, pre-rank by raw visible-feature count
        cand_rows = [int(r) for r in cand_rows
                     if self.num_reg_trials.get(int(self._img_ids[r]), 0)
                     < self.options.max_reg_trials]
        cand_rows.sort(key=lambda r: -counts[r])
        cand_rows = cand_rows[: 4 * max_images]
        scores = []
        for r in cand_rows:
            feats = np.nonzero(
                self._feat_vis[self._kp_off[r]: self._kp_off[r + 1]] > 0)[0]
            scores.append((self._pyramid_score(r, feats),
                           int(self._img_ids[r])))
        scores.sort(reverse=True)
        return [iid for _, iid in scores[:max_images]]

    def _pyramid_score(self, row: int, feat_idx: np.ndarray) -> float:
        cam = self.rec.cameras[int(self._cam_of_row[row])]
        xy = self._flat_xys[self._kp_off[row] + feat_idx]
        score = 0.0
        for level in range(2, 7):
            g = 1 << level
            cx = np.clip((xy[:, 0] / cam.width * g).astype(int), 0, g - 1)
            cy = np.clip((xy[:, 1] / cam.height * g).astype(int), 0, g - 1)
            occupied = len(np.unique(cx * g + cy))
            score += occupied * (g * g)
        return score

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def _collect_2d3d(self, row: int) -> Tuple[np.ndarray, np.ndarray]:
        """(feature_idx, pid) 2D-3D correspondence candidates, deduped."""
        _, img_rows, feats, edge_feat = self._graph[row]
        sel = self._reg_mask[img_rows]
        if not sel.any():
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        g_other = self._kp_off[img_rows[sel]] + feats[sel]
        pids = self._flat_pids[g_other]
        f = edge_feat[sel]
        m = pids >= 0
        f, pids = f[m], pids[m]
        key = f * (self._num_pts + 1) + pids
        _, first = np.unique(key, return_index=True)
        return f[first], pids[first]

    def register_next_image(self, image_id: int) -> bool:
        """2D-3D PnP registration (reference RegisterNextImage .cc:344)."""
        return len(self.register_next_images([image_id])) == 1

    def register_next_images(self, candidates: Sequence[int]) -> List[int]:
        """PnP-register a whole candidate batch with one batched device
        call; per-candidate acceptance stays on the host."""
        cands = []
        for iid in candidates:
            self.num_reg_trials[iid] = self.num_reg_trials.get(iid, 0) + 1
            f, pids = self._collect_2d3d(self._row_of[iid])
            if len(f) >= self.options.abs_pose_min_num_inliers:
                cands.append((iid, f, pids))
        if not cands:
            return []

        cap = max(len(f) for _, f, _ in cands)
        K = len(cands)
        X = np.zeros((K, cap, 3), np.float32)
        rays = np.zeros((K, cap, 2), np.float32)
        valid = np.zeros((K, cap), bool)
        errs = np.zeros(K, np.float32)
        for k, (iid, f, pids) in enumerate(cands):
            r = self._row_of[iid]
            n = len(f)
            X[k, :n] = self._xyz[pids]
            rays[k, :n] = self._flat_rays[self._kp_off[r] + f]
            valid[k, :n] = True
            errs[k] = self.options.abs_pose_max_error / self._focal_arr[r]

        def acceptance(inliers, n):
            num_inl = int(inliers[:n].sum())
            return (num_inl >= self.options.abs_pose_min_num_inliers
                    and num_inl / n >= self.options.abs_pose_min_inlier_ratio)

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        # stage 1: 256-sample budget (covers inlier ratios down to ~0.26
        # at 99% confidence); failed candidates retry at the full budget
        poses, inliers = _pnp_ransac_batch(
            self._gen, dev(X), dev(rays), dev(valid), dev(errs),
            num_samples=256)
        retry = [k for k, (iid, f, _) in enumerate(cands)
                 if not acceptance(inliers[k], len(f))]
        if retry:
            sel = np.asarray(retry, np.int64)
            poses2, inliers2 = _pnp_ransac_batch(
                self._gen, dev(X[sel]), dev(rays[sel]), dev(valid[sel]),
                dev(errs[sel]), num_samples=1024)
            poses[sel], inliers[sel] = poses2, inliers2

        accepted: List[int] = []
        for k, (iid, f, pids) in enumerate(cands):
            pose = poses[k]
            n = len(f)
            num_inl = int(inliers[k, :n].sum())
            if num_inl < self.options.abs_pose_min_num_inliers:
                continue
            if num_inl / n < self.options.abs_pose_min_inlier_ratio:
                continue
            self._set_pose(iid, pose.astype(np.float64))
            accepted.append(iid)
            # extend tracks with the inlier 2D-3D matches (reference: the
            # triangulator's Continue step covers these)
            inl = inliers[k, :n]
            live = self._track_len[pids] > 0
            sel = inl & live
            r = self._row_of[iid]
            self._append_obs(
                np.full(int(sel.sum()), r, np.int32),
                f[sel].astype(np.int32), pids[sel])
        return accepted

    # ------------------------------------------------------------------
    # triangulation
    # ------------------------------------------------------------------
    def triangulate_image(self, image_id: int) -> int:
        return self.triangulate_images([image_id])

    def _classify_candidates(self, image_ids: Sequence[int]):
        """Split each image's correspondence edges into continue vs create
        candidates (vectorized host pass)."""
        cont_r, cont_f, cont_p = [], [], []
        cand_r, cand_f, cand_or, cand_of = [], [], [], []
        for iid in image_ids:
            r = self._row_of[iid]
            _, img_rows, feats, edge_feat = self._graph[r]
            sel = self._reg_mask[img_rows]
            if not sel.any():
                continue
            f = edge_feat[sel]
            orow = img_rows[sel]
            ofeat = feats[sel]
            free = self._flat_pids[self._kp_off[r] + f] < 0
            pid_other = self._flat_pids[self._kp_off[orow] + ofeat]
            cont = free & (pid_other >= 0)
            cand = free & (pid_other < 0)
            cont_r.append(np.full(int(cont.sum()), r, np.int64))
            cont_f.append(f[cont])
            cont_p.append(pid_other[cont])
            cand_r.append(np.full(int(cand.sum()), r, np.int64))
            cand_f.append(f[cand])
            cand_or.append(orow[cand])
            cand_of.append(ofeat[cand])

        def cat(xs):
            return np.concatenate(xs) if xs else np.zeros(0, np.int64)

        return ((cat(cont_r), cat(cont_f), cat(cont_p)),
                (cat(cand_r), cat(cand_f), cat(cand_or), cat(cand_of)))

    def _np_reproj_err(self, img_rows: np.ndarray, g: np.ndarray,
                       X: np.ndarray):
        """Vectorized reprojection error (px, via mean focal) + depth."""
        pc = _np_pose_apply(self._poses[img_rows], X)
        z = pc[:, 2]
        z_safe = np.where(np.abs(z) > 1e-9, z, 1e-9)
        e = np.linalg.norm(pc[:, :2] / z_safe[:, None] - self._flat_rays[g],
                           axis=-1)
        return e * self._focal_arr[img_rows], z

    def _continue_tracks(self, rows, feats, pids, max_error: float) -> int:
        """Batched Continue: extend pids into (row, feat) where the
        reprojection fits (reference incremental_triangulator.cc:538)."""
        if len(rows) == 0:
            return 0
        g = self._kp_off[rows] + feats
        # dedupe feature -> first pid (greedy, as reference iteration order)
        _, first = np.unique(g, return_index=True)
        rows, feats, pids, g = rows[first], feats[first], pids[first], g[first]
        live = self._track_len[pids] > 0
        rows, feats, pids, g = rows[live], feats[live], pids[live], g[live]
        if len(rows) == 0:
            return 0
        err, z = self._np_reproj_err(rows, g, self._xyz[pids])
        ok = (err < max_error) & (z > 0)
        return self._append_obs(rows[ok].astype(np.int32),
                                feats[ok].astype(np.int32), pids[ok])

    def _obs_of_points(self, pids: np.ndarray):
        """Alive observation rows of the given points (via the CSR)."""
        offsets, rows_sorted = self._point_csr()
        cnt = offsets[pids + 1] - offsets[pids]
        tot = int(cnt.sum())
        obs = np.repeat(offsets[pids], cnt) + (
            np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt))
        return rows_sorted[obs]

    def _live_pids(self, pids=None) -> np.ndarray:
        if pids is None:
            return np.nonzero(self._track_len[: self._num_pts] > 0)[0]
        pids = np.unique(np.asarray(pids, np.int64))
        safe = np.clip(pids, 0, len(self._track_len) - 1)
        return pids[(pids >= 0) & (pids < self._num_pts)
                    & (self._track_len[safe] > 0)]

    def complete_tracks(self, pids=None, max_transitivity: int = 2) -> int:
        """Extend tracks into already-registered images along correspondence
        edges, breadth-first (reference: IncrementalTriangulator::
        CompleteTracks, incremental_triangulator.h:112, .cc Complete).

        Completion is always global (the reference restricts to modified
        points to bound C++ loop costs; here the incremental visibility
        counters make the candidate set = free-but-visible features, which
        is small and shrinks as tracks complete). `pids` is accepted for
        API parity and ignored.
        """
        n_total = 0
        for _ in range(max_transitivity):
            # candidates = FREE features with a triangulated partner — the
            # incrementally maintained _feat_vis counters make this an
            # O(#features) scan, and the set shrinks as tracks complete
            g_cand = np.nonzero((self._flat_pids < 0)
                                & (self._feat_vis > 0))[0]
            if len(g_cand) == 0:
                break
            rows = np.searchsorted(self._kp_off, g_cand, side="right") - 1
            reg = self._reg_mask[rows]
            g_cand, rows = g_cand[reg], rows[reg]
            if len(g_cand) == 0:
                break
            r1, r2 = self._table_rows_for_g(g_cand)
            dst_list, pid_list = [], []
            for ridx, dst_arr, partner_arr in ((r1, self._mg1, self._mg2),
                                               (r2, self._mg2, self._mg1)):
                pp = self._flat_pids[partner_arr[ridx]]
                m = pp >= 0
                dst_list.append(dst_arr[ridx][m])
                pid_list.append(pp[m])
            dst = np.concatenate(dst_list)
            if len(dst) == 0:
                break
            src_pids = np.concatenate(pid_list)
            rows_d = np.searchsorted(self._kp_off, dst, side="right") - 1
            n_added = self._continue_tracks(
                rows_d, dst - self._kp_off[rows_d], src_pids,
                max_error=self.options.complete_max_reproj_error)
            n_total += n_added
            if n_added == 0:
                break
        return n_total

    def _table_view(self, pids=None):
        """The global match table, restricted (via the g->row index) to
        rows touching the given points' observations when `pids` is set."""
        if pids is None:
            return self._mg1, self._mg2, self._mrow1, self._mrow2
        live = self._live_pids(pids)
        if len(live) == 0:
            z = np.zeros(0, np.int64)
            return z, z, z, z
        # a subset covering most points costs more to build than the full
        # scan it would save
        if len(live) > 0.3 * max(self.num_points3D(), 1):
            return self._mg1, self._mg2, self._mrow1, self._mrow2
        obs = self._obs_of_points(live)
        gs = self._kp_off[self._obs_img_row[obs]] + self._obs_feat[obs]
        r1, r2 = self._table_rows_for_g(gs)
        idx = np.unique(np.concatenate([r1, r2]))
        return (self._mg1[idx], self._mg2[idx],
                self._mrow1[idx], self._mrow2[idx])

    def merge_tracks(self, pids=None, use_pending: bool = False) -> int:
        """Merge pairs of points linked by a correspondence edge when the
        track-length-weighted merged point reprojects within threshold in
        EVERY observation of both tracks (reference: IncrementalTriangulator
        ::MergeTracks, incremental_triangulator.h:105, .cc TryMergeTracks).

        Candidate discovery: `use_pending` consumes the incrementally
        maintained pair pool (the edge-level analog of the reference's
        modified-points restriction — no table scan at all); otherwise one
        vectorized pass over the (subset) match table. Returns the number
        of points removed by merging."""
        if use_pending:
            if not self._pending_merge:
                return 0
            pairs = np.concatenate(self._pending_merge, axis=0)
            self._pending_merge = []
            # re-validate: endpoints may have merged/died since recording
            alive = ((self._track_len[pairs[:, 0]] > 0)
                     & (self._track_len[pairs[:, 1]] > 0)
                     & (pairs[:, 0] != pairs[:, 1]))
            pairs = pairs[alive]
            if len(pairs) == 0:
                return 0
            p1_all, p2_all = pairs[:, 0], pairs[:, 1]
        else:
            mg1, mg2, _, _ = self._table_view(pids)
            if len(mg1) == 0:
                return 0
            p1_all = self._flat_pids[mg1]
            p2_all = self._flat_pids[mg2]
            mask = (p1_all >= 0) & (p2_all >= 0) & (p1_all != p2_all)
            if not mask.any():
                return 0
            p1_all, p2_all = p1_all[mask], p2_all[mask]
        p1 = np.minimum(p1_all, p2_all)
        p2 = np.maximum(p1_all, p2_all)
        key = p1 * (self._num_pts + 1) + p2
        _, first = np.unique(key, return_index=True)
        p1, p2 = p1[first], p2[first]

        n1 = self._track_len[p1].astype(np.float64)
        n2 = self._track_len[p2].astype(np.float64)
        Xm = (n1[:, None] * self._xyz[p1] + n2[:, None] * self._xyz[p2]) \
            / (n1 + n2)[:, None]

        # test every observation of both tracks against the merged point
        offsets, rows_sorted = self._point_csr()
        max_err = np.zeros(len(p1))
        ok_depth = np.ones(len(p1), bool)
        for side in (p1, p2):
            cnt = offsets[side + 1] - offsets[side]
            tot = int(cnt.sum())
            o = np.repeat(offsets[side], cnt) + (
                np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt))
            o = rows_sorted[o]
            pair_idx = np.repeat(np.arange(len(side)), cnt)
            ir = self._obs_img_row[o].astype(np.int64)
            g = self._kp_off[ir] + self._obs_feat[o]
            err, z = self._np_reproj_err(ir, g, Xm[pair_idx])
            np.maximum.at(max_err, pair_idx, err)
            bad_z = np.zeros(len(p1), bool)
            np.logical_or.at(bad_z, pair_idx, z <= 0)
            ok_depth &= ~bad_z
        accept = (max_err < self.options.merge_max_reproj_error) & ok_depth
        if not accept.any():
            return 0

        # greedy disjoint merges, largest combined track first
        idx = np.nonzero(accept)[0]
        idx = idx[np.argsort(-(n1[idx] + n2[idx]), kind="stable")]
        used = np.zeros(self._num_pts, bool)
        merges = []
        for i in idx:
            a, b = int(p1[i]), int(p2[i])
            if used[a] or used[b]:
                continue
            used[a] = used[b] = True
            merges.append(i)
        if not merges:
            return 0
        merges = np.array(merges)
        members1, members2 = p1[merges], p2[merges]
        self._grow_points(len(merges))
        new_pids = np.arange(self._num_pts, self._num_pts + len(merges),
                             dtype=np.int64)
        self._num_pts += len(merges)
        self._xyz[new_pids] = Xm[merges]
        self._color[new_pids] = self._color[members1]
        # collect both tracks' observations, delete the members, re-append
        offsets, rows_sorted = self._point_csr()
        rows_all, feats_all, pid_all = [], [], []
        for side in (members1, members2):
            cnt = offsets[side + 1] - offsets[side]
            tot = int(cnt.sum())
            o = np.repeat(offsets[side], cnt) + (
                np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt))
            o = rows_sorted[o]
            rows_all.append(self._obs_img_row[o].copy())
            feats_all.append(self._obs_feat[o].copy())
            pid_all.append(np.repeat(new_pids, cnt))
        self._delete_points(np.concatenate([members1, members2]))
        self._append_obs(np.concatenate(rows_all),
                         np.concatenate(feats_all),
                         np.concatenate(pid_all))
        return len(merges)

    def consume_modified_pids(self) -> Optional[np.ndarray]:
        """Points whose tracks changed since the last consume (created,
        continued, merged, or retriangulated) — the reference triangulator's
        modified_point3D_ids_ set (incremental_triangulator.h:118), cleared
        on read. Returns None when the set covers most live points (a full
        scan is cheaper than the subset indexing)."""
        if not self._dirty_pids:
            return np.zeros(0, np.int64)
        u = self._live_pids(np.concatenate(self._dirty_pids))
        self._dirty_pids = []
        if len(u) > 0.3 * max(self.num_points3D(), 1):
            return None
        return u

    def complete_and_merge_tracks(self, pids=None, merge_pids=None,
                                  full_merge: bool = False) -> np.ndarray:
        """Complete then merge (reference: CompleteAndMergeTracks inside
        local/global refinement). Merging consumes the incremental pending
        pair pool by default (`merge_pids` is accepted for API parity —
        its pairs are already in the pool); `full_merge` forces one full
        match-table sweep (used once in the final refinement as a safety
        net). Returns the live pids touched."""
        before = self._num_pts
        self.complete_tracks(pids)
        if full_merge:
            self._pending_merge = []
            self.merge_tracks(None)
        else:
            self.merge_tracks(use_pending=True)
        if pids is None:
            return self._live_pids(None)
        touched = np.concatenate([
            np.asarray(pids, np.int64),
            np.arange(before, self._num_pts, dtype=np.int64)])
        return self._live_pids(touched)

    def triangulate_images(self, image_ids: Sequence[int]) -> int:
        """Create/continue tracks for newly registered images: one batched
        device call triangulates every candidate pair from every image in
        the round. Reference: IncrementalTriangulator Find/Create/Continue
        (sfm/incremental_triangulator.cc:437,478,538).
        """
        (cont, cand) = self._classify_candidates(image_ids)
        n_new = 0
        n_new += self._continue_tracks(
            *cont, max_error=self.options.continue_max_reproj_error)

        cand_r, cand_f, cand_or, cand_of = cand
        if len(cand_r) == 0:
            return n_new
        # canonical pair dedup: when several round images share edges (or a
        # full retriangulation sweep runs), the same feature pair appears
        # from both sides — keep one instance
        ga = self._kp_off[cand_r] + cand_f
        gb = self._kp_off[cand_or] + cand_of
        lo, hi = np.minimum(ga, gb), np.maximum(ga, gb)
        key = lo * (self._kp_off[-1] + 1) + hi
        _, first = np.unique(key, return_index=True)
        first = np.sort(first)
        cand_r, cand_f, cand_or, cand_of = (
            cand_r[first], cand_f[first], cand_or[first], cand_of[first])
        K = len(cand_r)
        g1 = self._kp_off[cand_r] + cand_f
        g2 = self._kp_off[cand_or] + cand_of
        packed = _triangulate_pairs(
            self._poses[cand_r], self._poses[cand_or], self._flat_rays[g1],
            self._flat_rays[g2], self.device)
        X, (angle, z1, z2, e1, e2) = packed[:3].T, packed[3:8]
        min_angle = np.radians(self.options.create_min_tri_angle_deg)
        err_px = self.options.filter_max_reproj_error
        ok = (
            (angle[:K] > min_angle)
            & (z1[:K] > 0)
            & (z2[:K] > 0)
            & (e1[:K] * self._focal_arr[cand_r] < err_px)
            & (e2[:K] * self._focal_arr[cand_or] < err_px)
        )
        # Track building: candidate pairs that share features form ONE
        # track (the reference builds tracks from transitive
        # correspondences, incremental_triangulator.cc:478). Group the
        # accepted pairs into connected components over their feature
        # nodes, create one point per component from its best-angle pair,
        # then Continue-extend every remaining feature of the component.
        sel = np.nonzero(ok)[0]
        if len(sel) == 0:
            return n_new
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        nodes = np.unique(np.concatenate([g1[sel], g2[sel]]))
        a = np.searchsorted(nodes, g1[sel])
        b = np.searchsorted(nodes, g2[sel])
        adj = coo_matrix((np.ones(len(sel), np.int8), (a, b)),
                         shape=(len(nodes), len(nodes)))
        n_comp, labels = connected_components(adj, directed=False)
        comp = labels[a]  # component of each accepted pair

        # Multi-view hypothesis selection (reference: RANSAC over view
        # pairs with support over the whole track, estimators/
        # triangulation.h:123-155 — done exhaustively-batched): for each
        # component, score up to 16 best-angle pair hypotheses by how many
        # of the component's features reproject within threshold, and
        # create the point from the max-support pair.
        order = np.lexsort((-angle[sel], comp))
        pairs_sorted = sel[order]
        comp_sorted = comp[order]
        starts = np.unique(comp_sorted, return_index=True)[1]
        counts = np.diff(np.append(starts, len(order)))
        rank = np.arange(len(order)) - np.repeat(starts, counts)
        keep = rank < 16
        pairs_sorted, comp_sorted = pairs_sorted[keep], comp_sorted[keep]

        node_order = np.argsort(labels, kind="stable")
        nodes_by_comp = nodes[node_order]
        node_comp_sorted = labels[node_order]
        noff = np.searchsorted(node_comp_sorted, np.arange(n_comp + 1))
        Vc = np.diff(noff)
        rep = Vc[comp_sorted]
        tot = int(rep.sum())
        pair_idx = np.repeat(np.arange(len(pairs_sorted)), rep)
        grp_off = np.cumsum(rep) - rep
        within = np.arange(tot) - np.repeat(grp_off, rep)
        node_g = nodes_by_comp[noff[comp_sorted[pair_idx]] + within]
        rows_n = np.searchsorted(self._kp_off, node_g, side="right") - 1
        err_n, z_n = self._np_reproj_err(
            rows_n, node_g, X[pairs_sorted[pair_idx]])
        good = (err_n < err_px) & (z_n > 0)
        support = np.bincount(pair_idx, weights=good,
                              minlength=len(pairs_sorted))
        o2 = np.lexsort((-angle[pairs_sorted], -support, comp_sorted))
        firsts = np.unique(comp_sorted[o2], return_index=True)[1]
        best = pairs_sorted[o2[firsts]]
        comp_best = comp_sorted[o2[firsts]]

        pids = self._add_points_bulk(
            X[best].astype(np.float64),
            cand_r[best].astype(np.int32), cand_f[best],
            cand_or[best].astype(np.int32), cand_of[best])
        n_new += len(pids)
        # extend all other component features into the new point
        comp_pid = np.full(n_comp, -1, np.int64)
        comp_pid[comp_best] = pids
        node_pid = comp_pid[labels]
        ext = node_pid >= 0
        ext &= self._flat_pids[nodes] < 0  # skip the just-assigned pairs
        g_ext = nodes[ext]
        rows_ext = np.searchsorted(self._kp_off, g_ext, side="right") - 1
        feats_ext = g_ext - self._kp_off[rows_ext]
        n_new += self._continue_tracks(
            rows_ext, feats_ext, node_pid[ext],
            max_error=self.options.continue_max_reproj_error)
        return n_new

    # ------------------------------------------------------------------
    # bundle adjustment
    # ------------------------------------------------------------------
    def _find_local_bundle(self, image_ids: Sequence[int]) -> List[int]:
        """Most-connected registered images by shared 3D points
        (reference FindLocalBundle .cc:1044), unioned over the round."""
        rows = [self._row_of[i] for i in image_ids]
        offsets, rows_sorted = self._point_csr()
        shared = np.zeros(len(self._img_ids), np.int64)
        pid_set: List[np.ndarray] = []
        for r in rows:
            p = self._flat_pids[self._kp_off[r]: self._kp_off[r + 1]]
            pid_set.append(p[p >= 0])
        if not pid_set:
            return []
        pids = np.unique(np.concatenate(pid_set))
        if len(pids) == 0:
            return []
        chunks = [rows_sorted[offsets[p]: offsets[p + 1]] for p in pids]
        obs = np.concatenate(chunks) if chunks else np.zeros(0, np.int64)
        np.add.at(shared, self._obs_img_row[obs], 1)
        for r in rows:
            shared[r] = 0
        ranked = np.argsort(-shared, kind="stable")
        budget = max(self.options.local_ba_num_images - 1, len(image_ids))
        out = []
        for r in ranked[:budget]:
            if shared[r] > 0:
                out.append(int(self._img_ids[r]))
        return out

    def _build_ba_problem(self, image_ids: Sequence[int],
                          fix_extra_images: bool = True,
                          refine_intrinsics: bool = False,
                          variable_pids: Optional[np.ndarray] = None,
                          local_obs_only: bool = False):
        """Assemble a BAProblem on the device for the given variable images.
        Pure array gathers, no Python loops over tracks.

        `local_obs_only` reproduces the reference's LOCAL-BA problem
        selection (incremental_mapper.cc:584-648 + bundle_adjustment.cc
        AddImageToProblem/AddPointToProblem/ParameterizePoints): residuals
        come from the local images' observations only; `variable_pids`
        (the modified points) with track length <= 15 contribute their
        FULL tracks with constant poses; any point whose included
        observation count is below its track length and that is not in
        `variable_pids` is held constant. Without it, every observation
        of every point seen by the images is included (global-BA style)."""
        var_rows = np.array([self._row_of[i] for i in image_ids], np.int64)
        vp = np.zeros(0, np.int64)
        if local_obs_only:
            alive = self._obs_pid[: self._num_obs] >= 0
            in_local = np.zeros(len(self._img_ids), bool)
            in_local[var_rows] = True
            obs = np.nonzero(
                alive & in_local[self._obs_img_row[: self._num_obs]])[0]
            if variable_pids is not None and len(variable_pids):
                vp = self._live_pids(variable_pids)
                vp = vp[self._track_len[vp] <= 15]  # ref kMaxTrackLength
            if len(vp):
                obs = np.unique(np.concatenate(
                    [obs, self._obs_of_points(vp)]))
            if len(obs) == 0:
                return None, None, None, None
            pids = np.unique(self._obs_pid[obs])
        else:
            pid_chunks = [
                self._flat_pids[self._kp_off[r]: self._kp_off[r + 1]]
                for r in var_rows]
            pids = np.unique(np.concatenate(pid_chunks)) if pid_chunks else \
                np.zeros(0, np.int64)
            pids = pids[pids >= 0]
            if len(pids) == 0:
                return None, None, None, None
            obs = self._obs_of_points(pids)
        obs_row = self._obs_img_row[obs]
        obs_feat = self._obs_feat[obs]
        obs_pid_raw = self._obs_pid[obs]

        all_rows = np.unique(obs_row)
        # variable rows first (gauge masks index them directly)
        is_var = np.isin(all_rows, var_rows)
        all_rows = np.concatenate([all_rows[is_var], all_rows[~is_var]])
        row_to_idx = np.zeros(len(self._img_ids), np.int64)
        row_to_idx[all_rows] = np.arange(len(all_rows))
        pid_to_idx_map = np.searchsorted(pids, obs_pid_raw)

        cams = sorted({int(self._cam_of_row[r]) for r in all_rows})
        cam_index = {cid: k for k, cid in enumerate(cams)}
        obs_cam = np.array([cam_index[int(c)]
                            for c in self._cam_of_row[obs_row]], np.int64)
        g = self._kp_off[obs_row] + obs_feat

        # freeze non-variable images
        pose_mask = np.zeros((len(all_rows), 6), np.float32)
        n_var = int(is_var.sum())
        pose_mask[: n_var if fix_extra_images else len(all_rows)] = 1.0
        point_mask = np.ones((len(pids), 3), np.float32)
        if local_obs_only:
            # ParameterizePoints parity: a partially-observed point is
            # constant unless explicitly variable (modified short-track)
            inc = np.bincount(pid_to_idx_map, minlength=len(pids))
            full = inc >= self._track_len[pids]
            if len(vp):
                full |= np.isin(pids, vp, assume_unique=True)
            point_mask[~full] = 0.0
            if n_var == len(all_rows) and n_var >= 2:
                # no constant observers pin the gauge: fix the last local
                # pose + the second-to-last pose's tx (reference
                # incremental_mapper.cc:620-632)
                last = row_to_idx[self._row_of[image_ids[-1]]]
                second = row_to_idx[self._row_of[image_ids[-2]]]
                pose_mask[last] = 0.0
                pose_mask[second, 3] = 0.0
        problem = ba.make_problem(
            self._poses[all_rows].astype(np.float32),
            np.stack([self.rec.cameras[cid].padded_params() for cid in cams]),
            self._xyz[pids].astype(np.float32),
            row_to_idx[obs_row],
            obs_cam,
            pid_to_idx_map,
            self._flat_xys[g].astype(np.float32),
            refine_intrinsics=refine_intrinsics,
            refine_extra_params=refine_intrinsics,
            camera_model_ids=[self.rec.cameras[cid].model_id for cid in cams],
            device=self.device,
        )
        problem = problem._replace(
            pose_mask=torch.as_tensor(pose_mask, device=self.device),
            point_mask=torch.as_tensor(point_mask, device=self.device))
        all_imgs = [int(self._img_ids[r]) for r in all_rows]
        return problem, all_imgs, pids, cams

    def _apply_ba_result(self, state: ba.LMState, all_imgs, pids, cams,
                         update_intrinsics: bool = False):
        pr = state.problem
        P, C = pr.poses.shape[0], pr.cam_params.shape[0]
        flat = torch.cat([pr.poses.reshape(-1), pr.cam_params.reshape(-1),
                          pr.points.reshape(-1)]).cpu().numpy()  # one copy
        flat = flat.astype(np.float64)
        poses = flat[: P * 7].reshape(P, 7)
        cam_params = flat[P * 7: P * 7 + C * 12].reshape(C, 12)
        points = flat[P * 7 + C * 12:].reshape(-1, 3)
        rows = np.array([self._row_of[i] for i in all_imgs], np.int64)
        self._poses[rows] = poses
        live = self._track_len[pids] > 0
        self._xyz[pids[live]] = points[live]
        if update_intrinsics:
            for k, cid in enumerate(cams):
                n = camera_models.NUM_PARAMS[
                    camera_models.CameraModelId(self.rec.cameras[cid].model_id)]
                self.rec.cameras[cid].params = cam_params[k][:n]

    def _solve(self, problem, options: ba.BAOptions, kind: str,
               mesh=None):
        """BA solve with its counters kept in self.prof[kind + "_..."];
        with a `mesh`, sharded by pose over it (counted in
        kind + "_sharded_calls" too)."""
        t0 = time.perf_counter()
        if mesh is None:
            state = ba.solve(problem, options)
        else:
            state = dba.solve_distributed(problem, options, mesh)
            self.prof[kind + "_sharded_calls"] += 1
        self.prof[kind + "_calls"] += 1
        self.prof[kind + "_lm_iters"] += state.iteration
        self.prof[kind + "_cg_steps"] += state.cg_steps
        self.prof[kind + "_syncs"] += state.syncs
        self.prof[kind + "_solve"] += time.perf_counter() - t0
        return state

    def adjust_local_bundle(self, image_ids,
                            ba_options: Optional[ba.BAOptions] = None):
        """BA over the most-connected local bundle (reference .cc:572,1044).

        `image_ids` may be one id or the round's list."""
        if isinstance(image_ids, (int, np.integer)):
            image_ids = [int(image_ids)]
        local = self._find_local_bundle(image_ids)
        # modified points since the last consume = the reference's
        # GetModifiedPoints3D() argument to AdjustLocalBundle (.cc:765)
        dirty = (self._live_pids(np.concatenate(self._dirty_pids))
                 if self._dirty_pids else np.zeros(0, np.int64))
        self._dirty_pids = []
        problem, all_imgs, pids, cams = self._build_ba_problem(
            list(image_ids) + local, variable_pids=dirty,
            local_obs_only=True)
        if problem is None:
            return []
        if ba_options is None:
            cam0 = self.rec.cameras[int(self._cam_of_row[
                self._row_of[image_ids[0]]])]
            ba_options = ba.BAOptions(
                max_iterations=10,
                cg_iterations=15,
                loss="cauchy",
                loss_scale=1.0,
                camera_model_id=cam0.model_id,
                refine_intrinsics=False,
                cg_tolerance=0.1,  # ceres eta default for ITERATIVE_SCHUR
            )
        state = self._solve(problem, ba_options, "lba")
        self._apply_ba_result(state, all_imgs, pids, cams)
        return pids

    def adjust_global_bundle(self, refine_intrinsics: bool = False,
                             ba_options: Optional[ba.BAOptions] = None,
                             function_tolerance: Optional[float] = None):
        """`function_tolerance` overrides the LM early-exit tolerance:
        intermediate growth-triggered global BAs converge to ~1e-4 (the
        outer refinement loop re-triangulates and re-runs anyway), the final
        refinement to 1e-6."""
        t0 = time.perf_counter()
        problem, all_imgs, pids, cams = self._build_ba_problem(
            list(self.registered), fix_extra_images=False,
            refine_intrinsics=refine_intrinsics,
        )
        self.prof["gba_build"] += time.perf_counter() - t0
        if problem is None:
            return
        # gauge: fix the first pose entirely + the second pose's tx
        pose_mask = problem.pose_mask.clone()
        pose_mask[0] = 0.0
        if len(all_imgs) > 1:
            pose_mask[1, 3] = 0.0
        problem = problem._replace(pose_mask=pose_mask)
        if ba_options is None:
            cam0 = self.rec.cameras[int(self._cam_of_row[
                self._row_of[self.registered[0]]])]
            intermediate = function_tolerance is not None
            ba_options = ba.BAOptions(
                # intermediates run a looser regime (the outer refinement
                # loop re-triangulates and re-solves; the final refinement
                # gets the full budget at 1e-6)
                max_iterations=30 if intermediate else 50,
                cg_iterations=15 if intermediate else 25,
                loss="cauchy",
                loss_scale=1.0,
                camera_model_id=cam0.model_id,
                refine_intrinsics=refine_intrinsics,
                function_tolerance=(1e-6 if function_tolerance is None
                                    else float(function_tolerance)),
                cg_tolerance=0.1,  # ceres eta default for ITERATIVE_SCHUR
            )
        elif function_tolerance is not None:
            ba_options = dataclasses.replace(
                ba_options, function_tolerance=float(function_tolerance))
        # multi-device: the pose-sharded solver, once the model has an
        # image for every shard (JAX: incremental_mapper.py:1680-1704)
        mesh = None
        if self._mesh is not None and len(all_imgs) >= self._mesh.size:
            mesh = self._mesh
        state = self._solve(problem, ba_options, "gba", mesh)
        t0 = time.perf_counter()
        self._apply_ba_result(state, all_imgs, pids, cams,
                              update_intrinsics=refine_intrinsics)
        self.prof["gba_apply"] += time.perf_counter() - t0
        if refine_intrinsics:
            self.invalidate_focal_cache()

    # ------------------------------------------------------------------
    # filtering
    # ------------------------------------------------------------------
    def filter_points(self, pids=None) -> int:
        """Drop bad observations/points (reference ObservationManager
        FilterPoints3D: reproj error, tri angle, negative depth).

        Fully vectorized over the flat observation tableau; `pids`
        restricts the pass to a subset (local filtering after local BA).
        """
        offsets, rows_sorted = self._point_csr()
        if pids is None:
            pids = np.nonzero(self._track_len[: self._num_pts] > 0)[0]
        else:
            pids = np.asarray(pids, np.int64)
            pids = pids[(pids >= 0) & (self._track_len[pids] > 0)]
        if len(pids) == 0:
            return 0
        cnt = offsets[pids + 1] - offsets[pids]
        obs = np.repeat(offsets[pids], cnt) + (
            np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt))
        obs = rows_sorted[obs]

        img_rows = self._obs_img_row[obs]
        g = self._kp_off[img_rows] + self._obs_feat[obs]
        X = self._xyz[self._obs_pid[obs]]
        err, z = self._np_reproj_err(img_rows, g, X)
        bad = (err > self.options.filter_max_reproj_error) | (z <= 0)
        num_filtered = int(bad.sum())
        self._remove_obs(obs[bad])

        # short tracks die
        short = pids[self._track_len[pids] < self.options.min_track_len]
        self._delete_points(short)
        num_filtered += len(short)

        # low max-pairwise-triangulation-angle points die. Sample up to 16
        # track entries per point (exact for tracks <= 16; a conservative
        # spread sample above, where the test passes anyway).
        offsets, rows_sorted = self._point_csr()
        live = pids[self._track_len[pids] >= self.options.min_track_len]
        if len(live) == 0:
            return num_filtered
        cnt = (offsets[live + 1] - offsets[live]).astype(np.int64)
        T = 16
        take = np.minimum(cnt, T)
        # sample indices into each track: consecutive when the track fits,
        # evenly spaced when longer than the sample width
        j = np.arange(T)
        step = np.where(cnt[:, None] <= T, j[None, :],
                        (j[None, :] * cnt[:, None]) // T)
        idx = offsets[live][:, None] + np.minimum(step, cnt[:, None] - 1)
        mask = j[None, :] < take[:, None]
        obs_idx = rows_sorted[np.minimum(idx, len(rows_sorted) - 1)]
        centers = _np_projection_center(
            self._poses[self._obs_img_row[obs_idx].reshape(-1)]
        ).reshape(len(live), T, 3)
        Xl = self._xyz[live]
        rays = Xl[:, None, :] - centers  # (n, T, 3)
        ray2 = np.sum(rays * rays, -1)
        min_angle = np.radians(self.options.filter_min_tri_angle_deg)
        cos_thresh = np.cos(min_angle)
        # max pairwise angle >= threshold <=> some pair has angle above it;
        # chunk the (n, T, T) pairwise test to bound memory
        to_delete = []
        for s in range(0, len(live), 16384):
            e = min(s + 16384, len(live))
            c = centers[s:e]
            r2 = ray2[s:e]
            m = mask[s:e]
            base2 = np.sum((c[:, :, None, :] - c[:, None, :, :]) ** 2, -1)
            denom = 2.0 * np.sqrt(np.maximum(r2[:, :, None] * r2[:, None, :],
                                             1e-24))
            cosang = np.clip((r2[:, :, None] + r2[:, None, :] - base2) / denom,
                             -1, 1)
            ang = np.arccos(cosang)
            ang = np.minimum(ang, np.pi - ang)
            pair_ok = m[:, :, None] & m[:, None, :]
            ang = np.where(pair_ok, ang, 0.0)
            ii = np.arange(T)
            ang[:, ii, ii] = 0.0
            max_ang = ang.reshape(e - s, -1).max(1)
            to_delete.append(live[s:e][max_ang < min_angle])
        dead = np.concatenate(to_delete)
        self._delete_points(dead)
        num_filtered += len(dead)
        return num_filtered

    def filter_images(self) -> List[int]:
        """Deregister images with no triangulated points or bogus refined
        intrinsics (reference: ObservationManager::FilterImages,
        observation_manager.h:144-160 — focal ratio out of
        [min, max]_focal_length_ratio vs the prior focal, or any extra
        param beyond max_extra_param). Returns the deregistered ids."""
        if len(self.registered) <= 2:
            return []
        # bogus-intrinsics check per camera (vs the DB prior focal)
        bogus_cam: Dict[int, bool] = {}
        for cid, cam in self.rec.cameras.items():
            prior = self._db_cam_params[cid]
            mid = camera_models.CameraModelId(cam.model_id)
            i_fx, i_fy, i_cx, i_cy = camera_models._FXFY_CXCY[mid]
            prior_f = 0.5 * (prior[i_fx] + prior[i_fy])
            f = cam.mean_focal_length()
            ratio = f / max(prior_f, 1e-9)
            n = camera_models.NUM_PARAMS[mid]
            non_extra = {i_fx, i_fy, i_cx, i_cy}
            extra = np.asarray([cam.params[i] for i in range(n)
                                if i not in non_extra], np.float64)
            bogus_cam[cid] = (
                ratio < self.options.min_focal_length_ratio
                or ratio > self.options.max_focal_length_ratio
                or (extra.size > 0
                    and np.abs(extra).max() > self.options.max_extra_param))

        # triangulated-point counts per image: one pass over alive obs
        counts = np.zeros(len(self._img_ids), np.int64)
        alive = self._obs_pid[: self._num_obs] >= 0
        np.add.at(counts, self._obs_img_row[: self._num_obs][alive], 1)

        dropped = []
        for iid in list(self.registered):
            r = self._row_of[iid]
            if counts[r] == 0 or bogus_cam[int(self._cam_of_row[r])]:
                dropped.append(iid)
        # never drop below a 2-image model; bogus intrinsics affect whole
        # cameras — deregistering every image would delete the model
        if len(self.registered) - len(dropped) < 2:
            dropped = [iid for iid in dropped
                       if counts[self._row_of[iid]] == 0]
        for iid in dropped:
            self._deregister_image(iid)
        return dropped

    def _deregister_image(self, image_id: int):
        r = self._row_of[image_id]
        # drop all its observations
        sel = np.nonzero((self._obs_img_row[: self._num_obs] == r)
                         & (self._obs_pid[: self._num_obs] >= 0))[0]
        self._remove_obs(sel)
        self._reg_mask[r] = False
        self.rec.images[image_id].cam_from_world = None
        self.registered.remove(image_id)

    # ------------------------------------------------------------------
    # import/export
    # ------------------------------------------------------------------
    def seed_from_model(self, model: Reconstruction) -> bool:
        """Adopt poses/intrinsics/points from an existing reconstruction
        (resume path; reference RunMapper --input_path, exe/sfm.cc:230)."""
        for iid, im in model.images.items():
            if iid in self._row_of and im.registered:
                self._set_pose(iid, np.asarray(im.cam_from_world, np.float64))
        for cid, cam in model.cameras.items():
            if cid in self.rec.cameras:
                self.rec.cameras[cid].params = np.asarray(cam.params,
                                                          np.float64)
        # refined intrinsics invalidate the DB-derived rays/focals
        self.invalidate_focal_cache()
        for pid, pt in model.points3D.items():
            track = [(iid, p2d) for (iid, p2d) in pt.track
                     if iid in self._row_of
                     and p2d < len(self.rec.images[iid].point3D_ids)
                     and self.rec.images[iid].point3D_ids[p2d] < 0]
            if len(track) >= 2:
                self.add_point(pt.xyz, track, color=pt.color)
        return len(self.registered) >= 2

    def finalize(self) -> Reconstruction:
        """Materialize the flat store into the interchange Reconstruction.

        Non-destructive: the mapper keeps working after finalize (model
        snapshots call this mid-run), so the internal store is untouched
        and the returned images carry remapped COPIES of the pid table.
        """
        rec = self.rec
        rec.points3D.clear()
        rec._next_point3D_id = 1
        offsets, rows_sorted = self._point_csr()
        alive = np.nonzero(self._track_len[: self._num_pts] > 0)[0]
        remap = np.full(max(self._num_pts, 1), -1, np.int64)
        obs_img = self._obs_img_row
        obs_feat = self._obs_feat
        img_ids = self._img_ids
        for p in alive:
            track_rows = rows_sorted[offsets[p]: offsets[p + 1]]
            track = [(int(img_ids[obs_img[t]]), int(obs_feat[t]))
                     for t in track_rows]
            ext = rec._next_point3D_id
            rec._next_point3D_id += 1
            rec.points3D[ext] = Point3D(
                xyz=self._xyz[p].copy(),
                color=self._color[p].copy(),
                error=-1.0,
                track=track,
            )
            remap[p] = ext
        for k, iid in enumerate(img_ids):
            im = rec.images[int(iid)]
            view = self._flat_pids[self._kp_off[k]: self._kp_off[k + 1]]
            im.point3D_ids = np.where(view >= 0, remap[np.maximum(view, 0)],
                                      -1)
            if self._reg_mask[k]:
                im.cam_from_world = np.array(self._poses[k], np.float64,
                                             copy=True)
        return rec
