"""Database utilities: create / clean / merge, feature + matches import,
image delete/filter.

Port of colmap_tpu/tools/database_tools.py: host SQLite through the port's
scene/database.py; `import_matches(verify=True)` matches and verifies the
imported pairs on `device`. Reference: exe/database.cc
(RunDatabaseCreator, RunDatabaseCleaner, RunDatabaseMerger),
exe/feature.cc (RunFeatureImporter, RunMatchesImporter), exe/image.cc
(RunImageDeleter, RunImageFilterer).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from colmap_tpu_torch.scene.database import Database, pair_id_to_image_pair

logger = logging.getLogger("colmap_tpu_torch")


def create_database(path: str) -> Database:
    """reference: RunDatabaseCreator."""
    return Database(path)


def clean_database(database: Database, clean_type: str = "all"):
    """clean_type: all | images | features | matches
    (reference: RunDatabaseCleaner)."""
    c = database.conn
    if clean_type in ("all", "matches"):
        c.execute("DELETE FROM matches")
        c.execute("DELETE FROM two_view_geometries")
    if clean_type in ("all", "features"):
        c.execute("DELETE FROM keypoints")
        c.execute("DELETE FROM descriptors")
    if clean_type in ("all", "images"):
        c.execute("DELETE FROM images")
        c.execute("DELETE FROM cameras")
        c.execute("DELETE FROM pose_priors")
    database.commit()


def merge_databases(db1: Database, db2: Database, out: Database):
    """Merge two databases into a third with re-assigned ids
    (reference: RunDatabaseMerger / Database::Merge)."""
    used_names = set()
    for src_idx, src in enumerate((db1, db2)):
        cam_map: Dict[int, int] = {}
        for cid, cam in src.read_cameras().items():
            cam_map[cid] = out.write_camera(cam["model_id"], cam["width"],
                                            cam["height"], cam["params"])
        img_map: Dict[int, int] = {}
        for iid, im in src.read_images().items():
            name = im["name"]
            if name in used_names:
                name = f"db{src_idx + 1}/{name}"
            used_names.add(name)
            img_map[iid] = out.write_image(name, cam_map[im["camera_id"]])
            kp = src.read_keypoints(iid)
            if kp is not None:
                out.write_keypoints(img_map[iid], kp)
            d = src.read_descriptors(iid)
            if d is not None:
                out.write_descriptors(img_map[iid], d)
        for iid, prior in src.read_pose_priors().items():
            out.write_pose_prior(img_map[iid], prior["position"],
                                 prior.get("coordinate_system", 0))
        for (a, b), g in src.read_all_two_view_geometries().items():
            m = src.read_matches(a, b)
            if m is not None and len(m):
                out.write_matches(img_map[a], img_map[b], m)
            out.write_two_view_geometry(
                img_map[a], img_map[b], g["inlier_matches"], g["config"])
    out.commit()


def import_features(database: Database, image_dir: str, import_dir: str,
                    camera_model: str = "SIMPLE_RADIAL",
                    camera_params: str = ""):
    """Import features from <name>.txt files in the VLFeat text format:
    first line 'N 128', then x y scale orientation d0..d127 per row
    (reference: RunFeatureImporter, exe/feature.cc)."""
    from colmap_tpu_torch.controllers.feature_extraction import (
        ImageReaderOptions, _infer_camera)
    from colmap_tpu_torch.features.sift import keypoints_to_affine
    from colmap_tpu_torch.sensor import bitmap as bitmap_mod
    from colmap_tpu_torch.sensor import models as camera_models

    reader = ImageReaderOptions(camera_model=camera_model,
                                camera_params=camera_params)
    names = bitmap_mod.list_image_files(image_dir)
    for name in names:
        txt = os.path.join(import_dir, name + ".txt")
        if not os.path.exists(txt):
            continue
        bmp = bitmap_mod.read_bitmap(os.path.join(image_dir, name))
        params, _ = _infer_camera(reader, bmp)
        model_id = camera_models.MODEL_IDS_BY_NAME[camera_model]
        cid = database.write_camera(int(model_id), bmp.width, bmp.height,
                                    np.asarray(params))
        iid = database.write_image(name, cid)
        with open(txt) as fp:
            header = fp.readline().split()
            n, dim = int(header[0]), int(header[1])
            rows = np.loadtxt(fp, ndmin=2)
        if len(rows) == 0:
            continue
        xy = rows[:, :2].astype(np.float32)
        scale = rows[:, 2].astype(np.float32)
        ori = rows[:, 3].astype(np.float32)
        desc = np.clip(rows[:, 4:4 + dim], 0, 255).astype(np.uint8)
        database.write_keypoints(iid, keypoints_to_affine(xy, scale, ori))
        database.write_descriptors(iid, desc)
    database.commit()


def import_matches(database: Database, match_list_path: str,
                   verify: bool = True, seed: int = 0, device="cuda"):
    """Import raw matches from a text file of 'name1 name2' blocks followed
    by index pairs (reference: RunMatchesImporter); with `verify`, the
    imported pairs are matched and verified again on `device` in blocks of
    32 (the matcher kernel on the card)."""
    name_to_id = {im["name"]: iid
                  for iid, im in database.read_images().items()}
    pairs: List[Tuple[int, int]] = []
    with open(match_list_path) as fp:
        block: Optional[Tuple[int, int]] = None
        rows: List[Tuple[int, int]] = []

        def flush():
            if block is not None and rows:
                database.write_matches(block[0], block[1],
                                       np.asarray(rows, np.uint32))
                pairs.append(block)

        for line in fp:
            parts = line.split()
            if not parts:
                continue
            if len(parts) == 2 and parts[0] in name_to_id:
                flush()
                block = (name_to_id[parts[0]], name_to_id[parts[1]])
                rows = []
            elif len(parts) == 2:
                rows.append((int(parts[0]), int(parts[1])))
        flush()
    database.commit()
    if verify and pairs:
        from colmap_tpu_torch.controllers import feature_matching as fm

        fm.match_and_verify_blocks(
            database, fm._chunk(pairs, 32), seed=seed, device=device)


def delete_images(database: Database, image_ids: List[int]):
    """reference: RunImageDeleter."""
    for iid in image_ids:
        database.conn.execute("DELETE FROM images WHERE image_id=?", (iid,))
        database.conn.execute("DELETE FROM keypoints WHERE image_id=?", (iid,))
        database.conn.execute("DELETE FROM descriptors WHERE image_id=?", (iid,))
        database.conn.execute("DELETE FROM pose_priors WHERE image_id=?", (iid,))
    # drop any pair rows touching the deleted images
    ids = set(image_ids)
    for table in ("matches", "two_view_geometries"):
        for (pid,) in database.conn.execute(f"SELECT pair_id FROM {table}").fetchall():
            a, b = pair_id_to_image_pair(pid)
            if a in ids or b in ids:
                database.conn.execute(f"DELETE FROM {table} WHERE pair_id=?", (pid,))
    database.commit()


def filter_images(database: Database, min_focal_ratio: float = 0.1,
                  max_focal_ratio: float = 10.0,
                  max_extra_param: float = 100.0) -> List[int]:
    """Remove images with bogus intrinsics (reference: RunImageFilterer)."""
    from colmap_tpu_torch.sensor import models as camera_models

    bad_cams = set()
    for cid, cam in database.read_cameras().items():
        mid = camera_models.CameraModelId(cam["model_id"])
        i_fx, i_fy, _, _ = camera_models._FXFY_CXCY[mid]
        f = 0.5 * (cam["params"][i_fx] + cam["params"][i_fy])
        ratio = f / max(cam["width"], cam["height"])
        n_base = 4 if i_fx != i_fy else 3
        extra = np.abs(np.asarray(cam["params"][n_base:]))
        if not (min_focal_ratio < ratio < max_focal_ratio) or \
                (len(extra) and extra.max() > max_extra_param):
            bad_cams.add(cid)
    bad_images = [iid for iid, im in database.read_images().items()
                  if im["camera_id"] in bad_cams]
    if bad_images:
        delete_images(database, bad_images)
    return bad_images
