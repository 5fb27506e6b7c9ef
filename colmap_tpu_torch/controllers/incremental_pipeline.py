"""The outer incremental-SfM pipeline.

Port of colmap_tpu/controllers/incremental_pipeline.py (reference:
controllers/incremental_mapper.h:39-220): LoadDatabase -> init pair ->
register/triangulate/local-BA loop with growth-triggered global BA +
retriangulation -> filtering; multi-model management (Reconstruct loop over
sub-models, .cc:474), model snapshots (snapshot_path /
snapshot_images_freq, .cc:437-442) and resume from an existing model
(RunMapper --input_path, exe/sfm.cc:230-237).

Device work runs on the pipeline's `device`. A failed round is not caught
and retried: an error, on the device or not, ends the run.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from collections import defaultdict
from typing import Optional, Set

import numpy as np

from colmap_tpu_torch.scene import reconstruction_io
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.database_cache import DatabaseCache
from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.scene.reconstruction_manager import (
    ReconstructionManager)
from colmap_tpu_torch.sfm.incremental_mapper import (
    IncrementalMapper,
    IncrementalMapperOptions,
)
from colmap_tpu_torch.util.controller import BaseController

logger = logging.getLogger("colmap_tpu_torch")


@dataclasses.dataclass
class IncrementalPipelineOptions:
    mapper: IncrementalMapperOptions = dataclasses.field(
        default_factory=IncrementalMapperOptions
    )
    min_num_matches: int = 15
    ba_global_images_ratio: float = 1.1  # reference growth trigger
    ba_global_points_ratio: float = 1.1
    # from `ba_global_coarse_cadence_size` registered images on, both growth
    # ratios relax to `ba_global_images_ratio_large` (the JAX package's
    # large-model cadence; 1.1 keeps the reference's flat cadence)
    ba_global_images_ratio_large: float = 1.2
    ba_global_coarse_cadence_size: int = 500
    ba_refine_focal_length: bool = True
    ba_refine_extra_params: bool = True
    min_model_size: int = 3
    init_num_trials: int = 200
    # flag parity with the JAX package, which declares it and never reads
    # it either (colours come from the extract_colors tool)
    extract_colors: bool = False
    # multi-model management (reference: multiple_models / max_num_models)
    multiple_models: bool = True
    max_num_models: int = 50
    max_model_overlap: int = 20
    # retriangulation inside global refinement (reference:
    # IterativeGlobalRefinement)
    retriangulate: bool = True
    # final refinement iterates until the changed-observation ratio drops
    # (reference: ba_global_max_refinements / ba_global_max_refinement_change)
    ba_global_max_refinements: int = 5
    ba_global_max_refinement_change: float = 0.0005
    # LM early-exit tolerance for INTERMEDIATE growth-triggered global BAs
    # (the final refinement always runs at 1e-6): the outer refinement loop
    # retriangulates + re-solves anyway
    ba_global_intermediate_function_tolerance: float = 1e-4
    # snapshots (reference: snapshot_path / snapshot_images_freq)
    snapshot_path: Optional[str] = None
    snapshot_images_freq: int = 0


class IncrementalPipeline(BaseController):
    """Run incremental SfM from a database into Reconstruction(s).

    Callbacks (reference: BaseController callback registry /
    pycolmap initial_image_pair_callback + next_image_callback,
    pipeline/sfm.cc:116): `initial_image_pair_callback(i1, i2)` fires after
    a successful initialization, `next_image_callback(image_id)` after each
    registered image.

    Stop/Pause: `request_stop()` makes the run unwind at the next round
    boundary and return the model built so far; `request_pause()` blocks
    the loop until `resume()` (reference: Thread/BaseController stop-check
    injection, util/base_controller.h:42).
    """

    def __init__(self, database: Database,
                 options: IncrementalPipelineOptions = IncrementalPipelineOptions(),
                 initial_image_pair_callback=None,
                 next_image_callback=None, device="cuda"):
        super().__init__()
        self.database = database
        self.options = options
        self.initial_image_pair_callback = initial_image_pair_callback
        self.next_image_callback = next_image_callback
        self.device = device
        # per-stage cumulative seconds
        self.stage_s = defaultdict(float)
        # the mappers' BA sub-timers and counters (IncrementalMapper.prof),
        # summed over sub-models; they subdivide stages of stage_s, so they
        # are kept apart from it
        self.ba_stats = defaultdict(float)

    def _timed(self, stage: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.stage_s[stage] += time.perf_counter() - t0
        return out

    # -- single sub-model -------------------------------------------------------

    def _initialize(self, cache: DatabaseCache, seed: int,
                    exclude_images: Set[int]) -> Optional[IncrementalMapper]:
        """Find + register an initial pair, retrying on triangulation
        failure (reference: init_num_trials re-init loop)."""
        tried = set()
        for _ in range(self.options.init_num_trials):
            candidate = IncrementalMapper(cache, self.options.mapper,
                                          seed=seed, device=self.device)
            pair, g = candidate.find_initial_image_pair(exclude=tried)
            if pair is None:
                return None
            if pair[0] in exclude_images or pair[1] in exclude_images:
                tried.add(pair)
                continue
            logger.info("initializing with pair %s (%d inliers)",
                        pair, int(g.num_inliers))
            if candidate.register_initial_image_pair(pair[0], pair[1], g):
                if self.initial_image_pair_callback is not None:
                    self.initial_image_pair_callback(pair[0], pair[1])
                return candidate
            logger.warning("initial pair %s triangulation failed, retrying",
                           pair)
            tried.add(pair)
        return None

    def _maybe_snapshot(self, mapper: IncrementalMapper, last_snapshot: int) -> int:
        opts = self.options
        if not opts.snapshot_path or opts.snapshot_images_freq <= 0:
            return last_snapshot
        n = len(mapper.registered)
        if n // opts.snapshot_images_freq > last_snapshot // opts.snapshot_images_freq:
            t0 = time.perf_counter()
            path = os.path.join(opts.snapshot_path, f"{n:06d}")
            os.makedirs(path, exist_ok=True)
            reconstruction_io.write_model(mapper.finalize(), path, ext=".bin")
            # the model's finalize and write: a stage of its own
            self.stage_s["snapshot"] += time.perf_counter() - t0
            logger.info("snapshot at %d images -> %s", n, path)
            return n
        return last_snapshot

    def _reconstruct_sub_model(self, cache: DatabaseCache, seed: int,
                               exclude_images: Set[int],
                               mapper: Optional[IncrementalMapper] = None
                               ) -> Optional[Reconstruction]:
        """Grow one model (reference: ReconstructSubModel, .cc:342-472)."""
        if mapper is None:
            mapper = self._timed("initialize", self._initialize, cache, seed,
                                 exclude_images)
            if mapper is None:
                return None
            self._timed("global_ba", mapper.adjust_global_bundle)
            self._timed("filter_global", mapper.filter_points)

        last_global_images = max(len(mapper.registered), 2)
        last_global_points = max(mapper.num_points3D(), 1)
        last_snapshot = 0

        while not self.check_if_stopped():
            status = self._map_round(mapper, exclude_images)
            if status == "done":
                break
            if status == "retry":
                continue  # trials are bounded by max_reg_trials
            last_snapshot = self._maybe_snapshot(mapper, last_snapshot)
            n_img = len(mapper.registered)
            n_pts = max(mapper.num_points3D(), 1)
            if self._global_ba_due(n_img, n_pts, last_global_images,
                                   last_global_points):
                self._global_refinement(mapper)
                last_global_images = n_img
                last_global_points = mapper.num_points3D()

        self._global_refinement(mapper, final=True)
        for k, v in mapper.prof.items():
            self.ba_stats[k] += v
        if mapper.rec.num_registered_images() < self.options.min_model_size:
            return None
        return mapper.finalize()

    def _global_ba_due(self, n_img: int, n_pts: int, last_images: int,
                       last_points: int) -> bool:
        """Has the model grown enough since the last global refinement?
        Below `ba_global_coarse_cadence_size` images the images and points
        ratios apply; from it on both read `ba_global_images_ratio_large`."""
        opts = self.options
        large = n_img >= opts.ba_global_coarse_cadence_size
        img_ratio = (opts.ba_global_images_ratio_large if large
                     else opts.ba_global_images_ratio)
        pts_ratio = (opts.ba_global_images_ratio_large if large
                     else opts.ba_global_points_ratio)
        return (n_img > img_ratio * last_images
                or n_pts > pts_ratio * last_points)

    def _map_round(self, mapper: IncrementalMapper,
                   exclude_images: Set[int]) -> str:
        """One registration round: PnP-register up to ~10% of the current
        model in one batched device call, triangulate the whole round in
        one batch, local-BA the union, complete/merge/filter the touched
        tracks. Growth-triggered global refinements keep the same cadence
        as the reference's per-image loop (ratio 1.1).

        Returns "done" (no candidates), "retry" (round registered
        nothing), or "ok"."""
        n_reg = len(mapper.registered)
        batch = max(1, min(self.options.mapper.max_batch_size, n_reg // 10))
        candidates = [i for i in self._timed(
            "find_next", mapper.find_next_images,
            max_images=2 * batch + 10) if i not in exclude_images][:batch]
        if not candidates:
            return "done"
        accepted = self._timed("register", mapper.register_next_images,
                               candidates)
        if not accepted:
            return "retry"
        logger.info("registered %d image(s) (#%d): %s", len(accepted),
                    len(mapper.registered), accepted)
        if self.next_image_callback is not None:
            for iid in accepted:
                self.next_image_callback(iid)
        pts_before = mapper._num_pts
        self._timed("triangulate", mapper.triangulate_images, accepted)
        local_pids = self._timed("local_ba", mapper.adjust_local_bundle,
                                 accepted)
        # complete + merge the locally-adjusted tracks, then filter only
        # those (reference: IterativeLocalRefinement runs
        # CompleteAndMergeTracks + FilterPoints3DInImages; the full pass
        # runs in global refinement). Merge consumes the incremental
        # pending-pair pool (the round's new points' edges are in it).
        # The round's new points join the touched set explicitly: a point
        # created between classification and _add_points_bulk in the same
        # triangulate_images call may not appear in local_pids, and the
        # local filter must see it before it feeds PnP/local BA.
        new_pids = np.arange(pts_before, mapper._num_pts, dtype=np.int64)
        touched = self._timed("complete_merge",
                              mapper.complete_and_merge_tracks,
                              np.concatenate([np.asarray(local_pids,
                                                         np.int64),
                                              new_pids]))
        self._timed("filter", mapper.filter_points, pids=touched)
        return "ok"

    def _global_refinement(self, mapper: IncrementalMapper, final: bool = False):
        """Retriangulate + global BA + filter on EVERY global refinement
        (reference: IterativeGlobalRefinement, sfm/incremental_mapper.cc:688
        — retriangulates and filters inside the loop, not just at the end).
        The whole retriangulation sweep is one batched create/continue pass
        over all registered images. The FINAL refinement iterates until the
        changed-observation ratio drops below
        ba_global_max_refinement_change (reference parity)."""
        n_img = len(mapper.registered)
        logger.info("global refinement at %d images", n_img)
        max_iters = self.options.ba_global_max_refinements if final else 1
        for it in range(max_iters):
            n_changed = 0
            if self.options.retriangulate:
                n_changed += self._timed(
                    "retriangulate", mapper.triangulate_images,
                    list(mapper.registered))
                # merge consumes the incrementally maintained candidate
                # pool (the edge-level analog of the reference's
                # modified_point3D_ids_ snapshot — no match-table scan);
                # the FIRST iteration of the final refinement runs one
                # full-table sweep as a completeness safety net
                self._timed("complete_merge_global",
                            mapper.complete_and_merge_tracks,
                            full_merge=(final and it == 0))
            t_ba = time.perf_counter()
            self._timed(
                "global_ba", mapper.adjust_global_bundle,
                refine_intrinsics=(self.options.ba_refine_focal_length
                                   and n_img >= 8),
                function_tolerance=(
                    None if final else self.options
                    .ba_global_intermediate_function_tolerance))
            logger.info("global BA at %d images: %.2fs (%d obs)",
                        n_img, time.perf_counter() - t_ba,
                        int((mapper._obs_pid[: mapper._num_obs] >= 0).sum()))
            n_changed += self._timed("filter_global", mapper.filter_points)
            dropped = mapper.filter_images()
            if dropped:
                logger.info("filtered %d images with bogus intrinsics / no "
                            "points: %s", len(dropped), dropped)
                n_changed += len(dropped)
            total_obs = max(int((mapper._obs_pid[: mapper._num_obs] >= 0).sum()),
                            1)
            change = n_changed / total_obs
            logger.info("refinement %d: %d changed obs (%.5f)", it,
                        n_changed, change)
            if change < self.options.ba_global_max_refinement_change:
                break

    # -- multi-model entry points ------------------------------------------------

    def run_multi(self, seed: int = 0, image_names=None,
                  input_model: Optional[Reconstruction] = None,
                  cache: Optional[DatabaseCache] = None
                  ) -> ReconstructionManager:
        """Reconstruct all sub-models (reference: Reconstruct, .cc:474).

        Pass `cache` to reuse a pre-built DatabaseCache (the hierarchical
        mapper builds per-cluster caches serially, then maps clusters
        concurrently — sqlite connections are thread-bound)."""
        if cache is None:
            cache = self._timed(
                "load", DatabaseCache.create, self.database,
                min_num_matches=self.options.min_num_matches,
                image_names=image_names, device=self.device)
        manager = ReconstructionManager()
        if len(cache.images) < 2:
            return manager

        exclude: Set[int] = set()
        max_models = self.options.max_num_models if self.options.multiple_models else 1
        for model_idx in range(max_models):
            if self.check_if_stopped():
                break
            mapper = None
            if model_idx == 0 and input_model is not None:
                # resume: seed mapper state from the existing model
                mapper = self._mapper_from_model(cache, input_model, seed)
            remaining = [i for i in cache.images if i not in exclude]
            if len(remaining) < max(self.options.min_model_size, 2):
                break
            rec = self._reconstruct_sub_model(cache, seed + model_idx,
                                              exclude, mapper=mapper)
            if rec is None:
                break
            manager.add(rec)
            logger.info("sub-model %d: %d images, %d points", model_idx,
                        rec.num_registered_images(), len(rec.points3D))
            exclude |= set(rec.registered_image_ids())
        return manager

    def _mapper_from_model(self, cache: DatabaseCache,
                           model: Reconstruction, seed: int
                           ) -> Optional[IncrementalMapper]:
        mapper = IncrementalMapper(cache, self.options.mapper, seed=seed,
                                   device=self.device)
        if not mapper.seed_from_model(model):
            return None
        return mapper

    def run(self, seed: int = 0, image_names=None,
            input_model: Optional[Reconstruction] = None,
            cache: Optional[DatabaseCache] = None
            ) -> Optional[Reconstruction]:
        """Reconstruct and return the largest sub-model."""
        manager = self.run_multi(seed=seed, image_names=image_names,
                                 input_model=input_model, cache=cache)
        if len(manager) == 0:
            return None
        return manager.largest()
