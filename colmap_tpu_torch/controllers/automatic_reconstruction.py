"""One-click reconstruction: images dir -> database -> sparse model ->
dense cloud and mesh.

Port of colmap_tpu/controllers/automatic_reconstruction.py: feature
extraction, matching (exhaustive, or for VIDEO sequential with vocab-tree
loop detection) and, with `sparse=True`, the incremental mapper, whose
model is written to workspace/sparse/0 in the binary format; with
`dense=True` as well, undistortion into workspace/dense, PatchMatch stereo
(photometric, then geometric), fusion into dense/fused.ply and Poisson
meshing into dense/meshed-poisson.ply, with the JAX package's defaults. The
quality presets are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import enum
import gc
import logging
import os
import time
from typing import Optional

import torch

from colmap_tpu_torch.controllers import dense_reconstruction as dense
from colmap_tpu_torch.controllers import feature_extraction as fe
from colmap_tpu_torch.controllers import feature_matching as fm
from colmap_tpu_torch.controllers.incremental_pipeline import (
    IncrementalPipeline,
    IncrementalPipelineOptions,
)
from colmap_tpu_torch.features import pairing as pairing_mod
from colmap_tpu_torch.features import sift as sift_mod
from colmap_tpu_torch.image import undistortion as und
from colmap_tpu_torch.scene import reconstruction_io
from colmap_tpu_torch.scene.database import Database

logger = logging.getLogger("colmap_tpu_torch")


class DataType(enum.Enum):
    INDIVIDUAL = "individual"
    VIDEO = "video"
    INTERNET = "internet"


class Quality(enum.Enum):
    LOW = "low"
    MEDIUM = "medium"
    HIGH = "high"
    EXTREME = "extreme"


@dataclasses.dataclass
class AutomaticReconstructionOptions:
    workspace_path: str = ""
    image_path: str = ""
    data_type: DataType = DataType.INDIVIDUAL
    quality: Quality = Quality.HIGH
    camera_model: str = "SIMPLE_RADIAL"
    single_camera: bool = False
    camera_params: str = ""
    sparse: bool = True
    dense: bool = False
    # VIDEO sequential-matching temporal window (reference
    # SequentialMatchingOptions.overlap). Slow orbital / small-baseline
    # footage needs a window wide enough that some pair clears the
    # mapper's 16-degree init triangulation-angle gate with
    # init_min_num_inliers correspondences.
    video_overlap: int = 10

    def sift_options(self) -> sift_mod.SiftExtractionOptions:
        # reference quality scaling (automatic_reconstruction.cc)
        table = {
            Quality.LOW: (1000, 2048),
            Quality.MEDIUM: (1600, 4096),
            Quality.HIGH: (2400, 8192),
            Quality.EXTREME: (3200, 8192),
        }
        max_size, max_feats = table[self.quality]
        return sift_mod.SiftExtractionOptions(
            max_image_size=max_size, max_num_features=max_feats)


def run_automatic_reconstruction(
    options: AutomaticReconstructionOptions,
    mapper_options: Optional[IncrementalPipelineOptions] = None,
    seed: int = 0,
    stage_timings: Optional[dict] = None,
    device="cuda",
):
    """Extraction + matching on `device` into workspace/database.db, then,
    with `options.sparse`, incremental mapping into workspace/sparse/0,
    and with `options.dense` too the dense stages into workspace/dense.
    INDIVIDUAL and INTERNET data are matched exhaustively; VIDEO frames
    sequentially in name order (window `video_overlap`) with vocab-tree
    loop detection. Returns (reconstruction | None, database).

    `stage_timings`, when a dict, gets the wall seconds of "extraction",
    "matching" and, when mapping ran, "mapping", the matcher's counters
    (MatchingStats) under "matching_stats", the pipeline's per-stage
    seconds under "mapping_stages" and its BA sub-timers and counters
    (calls, LM iterations, CG steps, host synchronizations) under
    "mapping_ba"; when the dense stages ran, the seconds of
    "undistortion", "patch_match_photometric", "patch_match_geometric",
    "fusion" and "meshing" and the depth maps per pass
    ("patch_match_maps")."""
    os.makedirs(options.workspace_path, exist_ok=True)
    database = Database(os.path.join(options.workspace_path, "database.db"))
    reader = fe.ImageReaderOptions(
        camera_model=options.camera_model,
        single_camera=options.single_camera,
        camera_params=options.camera_params,
    )
    logger.info("=== feature extraction ===")
    t0 = time.perf_counter()
    fe.run_feature_extraction(database, options.image_path, reader,
                              options.sift_options(), device=device)
    t1 = time.perf_counter()
    logger.info("=== feature matching ===")
    match_opts = fm.FeatureMatchingOptions()
    if options.data_type == DataType.VIDEO:
        # video sequences revisit places: vocab-tree loop detection joins
        # the temporal window (reference automatic_reconstruction.cc wires
        # SequentialMatching with loop detection for VIDEO)
        stats = fm.match_sequential(
            database, match_opts,
            pairing=pairing_mod.SequentialPairingOptions(
                overlap=options.video_overlap, loop_detection=True),
            seed=seed, device=device)
    else:
        stats = fm.match_exhaustive(database, match_opts, seed=seed,
                                    device=device)
    t2 = time.perf_counter()
    if stage_timings is not None:
        stage_timings["extraction"] = t1 - t0
        stage_timings["matching"] = t2 - t1
        stage_timings["matching_stats"] = dataclasses.asdict(stats)

    rec = None
    if options.sparse:
        logger.info("=== incremental mapping ===")
        pipeline = IncrementalPipeline(
            database, mapper_options or IncrementalPipelineOptions(),
            device=device)
        rec = pipeline.run(seed=seed)
        if rec is not None:
            reconstruction_io.write_model(
                rec, os.path.join(options.workspace_path, "sparse", "0"),
                ext=".bin")
        if stage_timings is not None:
            stage_timings["mapping"] = time.perf_counter() - t2
            stage_timings["mapping_stages"] = dict(sorted(
                pipeline.stage_s.items(), key=lambda kv: -kv[1]))
            stage_timings["mapping_ba"] = dict(pipeline.ba_stats)
        del pipeline  # its device caches go before the dense stage

    if options.dense and rec is not None:
        logger.info("=== dense reconstruction ===")
        timings = run_dense(rec, options, device, seed)
        if stage_timings is not None:
            stage_timings.update(timings)
    return rec, database


def run_dense(rec, options: AutomaticReconstructionOptions, device,
              seed: int = 0) -> dict:
    """The dense stages of the JAX package, in its order and with its
    defaults: undistort into workspace/dense, PatchMatch stereo
    (photometric, then geometric), fusion into fused.ply, Poisson meshing
    into meshed-poisson.ply. Returns the stage seconds."""
    # the sparse stage's freed blocks go back to the card before the
    # memory-heavy dense stage
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    dense_dir = os.path.join(options.workspace_path, "dense")
    t = {}
    t0 = time.perf_counter()
    und.run_undistorter(rec, options.image_path, dense_dir, device=device)
    t["undistortion"] = time.perf_counter() - t0
    pm_t = {}
    dense.run_patch_match_stereo(dense_dir, seed=seed, device=device,
                                 timings=pm_t)
    t["patch_match_photometric"] = pm_t["photometric"]
    t["patch_match_geometric"] = pm_t["geometric"]
    t["patch_match_maps"] = pm_t["maps"]
    t0 = time.perf_counter()
    dense.run_stereo_fusion(dense_dir, device=device)
    t["fusion"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense.run_poisson_mesher(os.path.join(dense_dir, "fused.ply"),
                             os.path.join(dense_dir, "meshed-poisson.ply"),
                             device=device)
    t["meshing"] = time.perf_counter() - t0
    return t
