"""Hierarchical mapper: cluster the scene, map the clusters, merge the models.

Port of colmap_tpu/controllers/hierarchical_pipeline.py (reference:
controllers/hierarchical_mapper.h:45-80): normalized-cut scene clustering,
then concurrent per-cluster incremental mapping on a host thread pool, then
the merge. Like the JAX package, the merge goes further than the
reference's greedy pairwise Sim3 chaining: every pairwise cluster alignment
becomes an edge of a Sim3 pose graph that is optimized jointly
(estimators/pose_graph.py), so loop-closure error spreads over the whole
graph before the models fuse.

The sqlite connection is bound to its thread, so the per-cluster
DatabaseCaches are built serially on the calling thread; then the clusters
map concurrently, each on its own IncrementalPipeline (own generator,
stage timers and BA counters), all on `device`. An exception in any
cluster propagates to the caller.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from colmap_tpu_torch.controllers.incremental_pipeline import (
    IncrementalPipeline,
    IncrementalPipelineOptions,
)
from colmap_tpu_torch.estimators import alignment as alignment_mod
from colmap_tpu_torch.estimators import pose_graph as pose_graph_mod
from colmap_tpu_torch.geometry import sim3 as s3
from colmap_tpu_torch.scene import scene_clustering as sc
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.database_cache import DatabaseCache
from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.util.controller import BaseController

logger = logging.getLogger("colmap_tpu_torch")

_IDENTITY = np.array([1, 1, 0, 0, 0, 0, 0, 0], np.float64)


@dataclasses.dataclass
class HierarchicalPipelineOptions:
    clustering: sc.SceneClusteringOptions = dataclasses.field(
        default_factory=sc.SceneClusteringOptions)
    incremental: IncrementalPipelineOptions = dataclasses.field(
        default_factory=IncrementalPipelineOptions)
    min_num_inliers: int = 15
    # concurrent cluster reconstructions (reference: a thread pool over
    # the clusters, hierarchical_mapper.cc). On one H100 the 200-image
    # hierarchical gate mapped 0.50x as fast with 4 threads as with 1
    # (158.9 against 79.1 s), the 1000-image scale run (leaves of 238, 294
    # and 508 images) 0.68x (175.6 against 119.2 s; PERF.md section 7):
    # the threads share one process, so on CUDA num_workers=1 is the
    # faster setting today.
    num_workers: int = 4
    # pose-graph edge acceptance
    align_max_error: float = 0.1
    pose_graph_iters: int = 20


class HierarchicalPipeline(BaseController):
    """After `run`: `leaf_sizes`, `clusters` (per leaf: images, registered,
    mapping seconds), `timings` (wall
    seconds of clustering, caches, mapping, align, pose_graph, fuse), and
    the clusters' mapper `stage_s` and BA counters `ba_stats`, summed over
    clusters. Each `run` starts these afresh."""

    def __init__(self, database: Database,
                 options: HierarchicalPipelineOptions = HierarchicalPipelineOptions(),
                 device="cuda"):
        super().__init__()
        self.database = database
        self.options = options
        self.device = device
        self.leaf_sizes: List[int] = []
        self.clusters: List[dict] = []
        self.timings: Dict[str, float] = defaultdict(float)
        self.stage_s: Dict[str, float] = defaultdict(float)
        self.ba_stats: Dict[str, float] = defaultdict(float)

    def _reconstruct_clusters(self, leaves, id_to_name, seed: int
                              ) -> List[Reconstruction]:
        t0 = time.perf_counter()
        caches = [DatabaseCache.create(
            self.database,
            min_num_matches=self.options.incremental.min_num_matches,
            image_names={id_to_name[iid] for iid in leaf.image_ids},
            device=self.device) for leaf in leaves]
        self.timings["caches"] += time.perf_counter() - t0

        def work(args):
            li, cache = args
            if self.check_if_stopped():
                return None, None, 0.0
            t = time.perf_counter()
            pipeline = IncrementalPipeline(
                self.database, self.options.incremental, device=self.device)
            rec = pipeline.run(seed=seed + li, cache=cache)
            return rec, pipeline, time.perf_counter() - t

        workers = max(1, min(self.options.num_workers, len(leaves)))
        t0 = time.perf_counter()
        if workers == 1:
            results = [work(a) for a in enumerate(caches)]
        else:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                results = list(ex.map(work, enumerate(caches)))
        self.timings["mapping"] += time.perf_counter() - t0

        recs = []
        for li, (rec, pipeline, secs) in enumerate(results):
            n_reg = 0 if rec is None else rec.num_registered_images()
            self.clusters.append(dict(images=len(leaves[li].image_ids),
                                      registered=n_reg, seconds=secs))
            if pipeline is not None:
                for k, v in pipeline.stage_s.items():
                    self.stage_s[k] += v
                for k, v in pipeline.ba_stats.items():
                    self.ba_stats[k] += v
            if rec is not None:
                logger.info("cluster %d: %d images registered", li, n_reg)
                recs.append(rec)
        return recs

    def _placement_ok(self, base: Reconstruction, rec: Reconstruction
                      ) -> bool:
        """Do the common registered images of `rec` (already in the global
        frame) agree with `base` on projection centres? Median error gate
        at align_max_error; no common image counts as not validated (the
        robust fallback can still align through points)."""
        common = sorted(set(base.registered_image_ids())
                        & set(rec.registered_image_ids()))
        if not common:
            return False
        a = np.stack([base.images[i].projection_center() for i in common])
        b = np.stack([rec.images[i].projection_center() for i in common])
        err = np.linalg.norm(a - b, axis=1)
        return float(np.median(err)) <= self.options.align_max_error

    def _merge_with_pose_graph(self, recs: List[Reconstruction]
                               ) -> Reconstruction:
        """Pairwise Sim3 edges -> joint pose-graph refinement -> fuse."""
        recs = sorted(recs, key=lambda r: -r.num_registered_images())
        n = len(recs)
        if n == 1:
            return recs[0]

        t0 = time.perf_counter()
        edges: List[Tuple[int, int]] = []
        meas: List[np.ndarray] = []
        weights: List[float] = []
        for i in range(n):
            for j in range(i + 1, n):
                common = (set(recs[i].registered_image_ids())
                          & set(recs[j].registered_image_ids()))
                if len(common) < 3:
                    continue
                t = alignment_mod.align_reconstructions_robust(
                    recs[i], recs[j], max_error=self.options.align_max_error,
                    device=self.device)
                if t is None:
                    continue
                edges.append((i, j))
                meas.append(np.asarray(t))  # j_from_i
                weights.append(float(np.sqrt(len(common))))
        self.timings["align"] += time.perf_counter() - t0
        if not edges:
            logger.warning("no alignable cluster pairs; returning largest")
            return recs[0]

        # initial placements: breadth-first composition from the largest
        # cluster (float32 host bookkeeping, as in the JAX package)
        def f32(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32)

        placement: List[Optional[np.ndarray]] = [None] * n
        placement[0] = _IDENTITY.copy()
        adj: Dict[int, List[Tuple[int, np.ndarray]]] = {}
        for (i, j), m in zip(edges, meas):
            # global_from_i = global_from_j o j_from_i
            adj.setdefault(i, []).append((j, m))
            adj.setdefault(j, []).append((i, s3.inverse(f32(m)).numpy()))
        frontier = [0]
        while frontier:
            j = frontier.pop()
            for (i, m_ij) in adj.get(j, []):
                if placement[i] is None:
                    placement[i] = s3.compose(
                        f32(placement[j]), f32(m_ij)).numpy().astype(
                            np.float64)
                    frontier.append(i)
        connected = [k for k in range(n) if placement[k] is not None]
        if len(connected) < n:
            logger.warning("%d cluster models unreachable from the largest",
                           n - len(connected))

        # joint refinement over the connected subgraph
        t0 = time.perf_counter()
        remap = {k: idx for idx, k in enumerate(connected)}
        kept = [k for k, (i, j) in enumerate(edges)
                if i in remap and j in remap]
        init = np.stack([placement[k] for k in connected])
        refined = init
        if kept:
            refined = pose_graph_mod.optimize_sim3_pose_graph(
                init, np.array([(remap[edges[k][0]], remap[edges[k][1]])
                                for k in kept], np.int64),
                np.stack([meas[k] for k in kept]),
                np.array([weights[k] for k in kept], np.float32),
                num_iters=self.options.pose_graph_iters, device=self.device)
        self.timings["pose_graph"] += time.perf_counter() - t0

        # every cluster into the global frame, then fuse
        t0 = time.perf_counter()
        base = recs[connected[0]]
        base.transform(refined[0])
        for idx in range(1, len(connected)):
            rec = recs[connected[idx]]
            rec.transform(refined[idx])
            # validate the placement before fusing: the precomputed-identity
            # merge skips the internal alignment, so one bad placement (a
            # weak 3-common-image edge) would corrupt the fused model; on
            # failure, re-align robustly (reference: the RANSAC-gated
            # MergeReconstructions, estimators/alignment.cc)
            if self._placement_ok(base, rec):
                ok = alignment_mod.merge_reconstructions(
                    base, rec, precomputed_sim3=_IDENTITY,
                    device=self.device)
            else:
                logger.warning(
                    "cluster %d pose-graph placement fails the proj-center "
                    "check; re-aligning robustly", connected[idx])
                ok = alignment_mod.merge_reconstructions(
                    base, rec,
                    max_proj_center_error=self.options.align_max_error,
                    device=self.device)
            if not ok:
                logger.warning("cluster %d failed to fuse", connected[idx])
        # unreachable clusters: greedy fallback against the fused base (the
        # grown overlap may now align, e.g. through common 3D points)
        pending = [recs[k] for k in range(n) if k not in remap]
        progress = True
        while pending and progress:
            progress = False
            rest = []
            for rec in pending:
                if alignment_mod.merge_reconstructions(base, rec,
                                                       device=self.device):
                    progress = True
                else:
                    rest.append(rec)
            pending = rest
        if pending:
            logger.warning("%d cluster models could not be merged",
                           len(pending))
        self.timings["fuse"] += time.perf_counter() - t0
        return base

    def run(self, seed: int = 0) -> Optional[Reconstruction]:
        self.clusters = []
        self.timings = defaultdict(float)
        self.stage_s = defaultdict(float)
        self.ba_stats = defaultdict(float)
        t0 = time.perf_counter()
        weights = sc.edge_weights_from_database(
            self.database, self.options.min_num_inliers)
        images = self.database.read_images()
        tree = sc.cluster_scene(sorted(images), weights,
                                self.options.clustering)
        leaves = tree.leaves()
        self.leaf_sizes = [len(leaf.image_ids) for leaf in leaves]
        self.timings["clustering"] += time.perf_counter() - t0
        logger.info("scene clustered into %d leaves: %s", len(leaves),
                    self.leaf_sizes)

        id_to_name = {iid: im["name"] for iid, im in images.items()}
        recs = self._reconstruct_clusters(leaves, id_to_name, seed)
        if not recs:
            return None
        return self._merge_with_pose_graph(recs)
