"""One-click reconstruction: images dir -> database -> sparse model.

Port of colmap_tpu/controllers/automatic_reconstruction.py: feature
extraction, matching (exhaustive, or for VIDEO sequential with vocab-tree
loop detection) and, with `sparse=True`, the incremental mapper, whose
model is written to workspace/sparse/0 in the binary format. The quality
presets are the JAX package's. Dense reconstruction is not ported yet and
raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import os
import time
from typing import Optional

from colmap_tpu_torch.controllers import feature_extraction as fe
from colmap_tpu_torch.controllers import feature_matching as fm
from colmap_tpu_torch.controllers.incremental_pipeline import (
    IncrementalPipeline,
    IncrementalPipelineOptions,
)
from colmap_tpu_torch.features import pairing as pairing_mod
from colmap_tpu_torch.features import sift as sift_mod
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
    with `options.sparse`, incremental mapping into workspace/sparse/0.
    INDIVIDUAL and INTERNET data are matched exhaustively; VIDEO frames
    sequentially in name order (window `video_overlap`) with vocab-tree
    loop detection. Returns (reconstruction | None, database).

    `stage_timings`, when a dict, gets the wall seconds of "extraction",
    "matching" and, when mapping ran, "mapping", the matcher's counters
    (MatchingStats) under "matching_stats", the pipeline's per-stage
    seconds under "mapping_stages" and its BA sub-timers and counters
    (calls, LM iterations, CG steps, host synchronizations) under
    "mapping_ba"."""
    if options.dense:
        raise NotImplementedError("dense reconstruction: ROADMAP queue 1 "
                                  "item 9")
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
    return rec, database
