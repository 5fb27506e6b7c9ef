"""Feature extraction pipeline: image dir -> database.

Port of colmap_tpu/controllers/feature_extraction.py. The host reads and
resizes images and groups consecutive same-bucket images into batches; each
batch is uploaded as uint8 and extracted on `device`; one writer flushes
keypoints and descriptors to SQLite. Images whose features are already in
the database are skipped (resume).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from colmap_tpu_torch.features import sift as sift_mod
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.sensor import bitmap as bitmap_mod
from colmap_tpu_torch.sensor import models as camera_models

logger = logging.getLogger("colmap_tpu_torch")


@dataclasses.dataclass
class ImageReaderOptions:
    """Reference: ImageReaderOptions (controllers/image_reader.h)."""

    camera_model: str = "SIMPLE_RADIAL"
    single_camera: bool = False
    single_camera_per_folder: bool = False
    camera_params: str = ""  # comma-separated explicit params
    default_focal_length_factor: float = 1.2


def init_camera_params(model_name: str, width: int, height: int,
                       focal: float) -> List[float]:
    """Default params for a model: focal(s), principal point center, zeros."""
    mid = camera_models.MODEL_IDS_BY_NAME[model_name]
    n = camera_models.NUM_PARAMS[mid]
    i_fx, i_fy, i_cx, i_cy = camera_models._FXFY_CXCY[mid]
    params = [0.0] * n
    params[i_fx] = focal
    params[i_fy] = focal
    params[i_cx] = width / 2.0
    params[i_cy] = height / 2.0
    return params


def _infer_camera(options: ImageReaderOptions, bmp: bitmap_mod.Bitmap):
    """Explicit params, else EXIF focal, else the default factor."""
    if options.camera_params:
        return [float(v) for v in options.camera_params.split(",")], True
    focal = bmp.exif_focal_px
    has_prior = focal is not None
    if focal is None:
        focal = bitmap_mod.default_focal_length(
            bmp.width, bmp.height, options.default_focal_length_factor)
    return init_camera_params(options.camera_model, bmp.width, bmp.height,
                              focal), has_prior


@dataclasses.dataclass
class FeatureExtractionResult:
    image_ids: List[int]
    num_features: Dict[int, int]


def run_feature_extraction(
    database: Database,
    image_dir: str,
    reader_options: ImageReaderOptions = ImageReaderOptions(),
    sift_options: sift_mod.SiftExtractionOptions = sift_mod.SiftExtractionOptions(),
    image_names: Optional[List[str]] = None,
    device="cuda",
) -> FeatureExtractionResult:
    """Extract SIFT on `device` for every image under image_dir into the
    database."""
    sift_options.check()
    names = image_names or bitmap_mod.list_image_files(image_dir)
    if not names:
        raise ValueError(f"no images found in {image_dir}")

    existing = {im["name"]: iid for iid, im in database.read_images().items()}
    image_ids: List[int] = []
    num_features: Dict[int, int] = {}
    shared_camera_id: Optional[int] = None
    folder_camera_ids: Dict[str, int] = {}
    pending: List[tuple] = []  # (image_id, padded_u8, scale, h, w)

    def flush():
        if not pending:
            return
        stack = torch.as_tensor(np.stack([p[1] for p in pending]),
                                device=device)
        out = sift_mod.extract_batch(stack, sift_options)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        for i, (image_id, _, scale, h, w) in enumerate(pending):
            feats = sift_mod._finalize_features(
                {k: v[i] for k, v in host.items()}, scale, h, w)
            kp6 = sift_mod.keypoints_to_affine(
                feats["xy"], feats["scale"], feats["orientation"])
            database.write_keypoints(image_id, kp6)
            database.write_descriptors(image_id, feats["descriptors"])
            num_features[image_id] = len(kp6)
            logger.info("extracted %d features for image %d", len(kp6),
                        image_id)
        pending.clear()

    for name in names:
        n_existing = (database.num_keypoints(existing[name])
                      if name in existing else 0)
        if n_existing > 0:
            # resume: skip images whose features are already in the DB
            image_id = existing[name]
            image_ids.append(image_id)
            num_features[image_id] = n_existing
            continue
        bmp = bitmap_mod.read_bitmap(os.path.join(image_dir, name))

        if name in existing:
            image_id = existing[name]
        else:
            folder = os.path.dirname(name)
            if reader_options.single_camera and shared_camera_id is not None:
                camera_id = shared_camera_id
            elif (reader_options.single_camera_per_folder
                  and folder in folder_camera_ids):
                camera_id = folder_camera_ids[folder]
            else:
                params, _ = _infer_camera(reader_options, bmp)
                model_id = camera_models.MODEL_IDS_BY_NAME[
                    reader_options.camera_model]
                camera_id = database.write_camera(
                    int(model_id), bmp.width, bmp.height, np.asarray(params))
                if reader_options.single_camera:
                    shared_camera_id = camera_id
                folder_camera_ids[folder] = camera_id
            image_id = database.write_image(name, camera_id)
            if bmp.gps is not None:
                database.write_pose_prior(image_id, bmp.gps,
                                          coordinate_system=1)

        padded, scale, h, w = sift_mod._prepare_u8(bmp.data, sift_options)
        if pending and pending[-1][1].shape != padded.shape:
            flush()  # bucket shape changed: run the accumulated batch
        pending.append((image_id, padded, scale, h, w))
        image_ids.append(image_id)
        if len(pending) >= max(1, sift_options.batch_size):
            flush()

    flush()
    database.commit()
    return FeatureExtractionResult(image_ids=image_ids,
                                   num_features=num_features)
