"""One-click reconstruction, front end: images dir -> database.

Port of colmap_tpu/controllers/automatic_reconstruction.py through feature
extraction and exhaustive matching (the correspondence front end). The
quality presets are the JAX package's. The mapper (`sparse=True`), dense
reconstruction and the VIDEO data type are not ported yet and raise
NotImplementedError.
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
from colmap_tpu_torch.features import sift as sift_mod
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
    seed: int = 0,
    stage_timings: Optional[dict] = None,
    device="cuda",
):
    """Extraction + exhaustive matching on `device` into
    workspace/database.db. Returns (None, database): the reconstruction
    slot stays None until the mapper is ported. `stage_timings`, when a
    dict, gets the wall seconds of "extraction" and "matching"."""
    if options.sparse:
        raise NotImplementedError("mapper: ROADMAP queue 1 item 5")
    if options.dense:
        raise NotImplementedError("dense reconstruction: ROADMAP queue 1 "
                                  "item 9")
    if options.data_type == DataType.VIDEO:
        raise NotImplementedError("sequential matching with loop detection "
                                  "for VIDEO: ROADMAP queue 1 item 6")
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
    fm.match_exhaustive(database, fm.FeatureMatchingOptions(), seed=seed,
                        device=device)
    t2 = time.perf_counter()
    if stage_timings is not None:
        stage_timings["extraction"] = t1 - t0
        stage_timings["matching"] = t2 - t1
    return None, database
