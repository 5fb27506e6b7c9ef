"""SQLite feature/match database, schema-compatible with COLMAP.

Reference: src/colmap/scene/database.h:61 (table DDL database.cc:1338-1431).
Using the same schema means databases interchange with reference COLMAP
tooling. This is host-side IO — device arrays are produced in bulk by the
DatabaseCache, not per-row.

pair_id convention (reference database.cc ImagePairToPairId):
    pair_id = image_id1 * kMaxNumImages + image_id2, image_id1 < image_id2.
Matches with image_id1 > image_id2 are stored with swapped columns.
"""

from __future__ import annotations

import sqlite3
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

MAX_NUM_IMAGES = 2147483647


def image_pair_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_NUM_IMAGES + image_id2


def pair_id_to_image_pair(pair_id: int) -> Tuple[int, int]:
    image_id2 = pair_id % MAX_NUM_IMAGES
    image_id1 = (pair_id - image_id2) // MAX_NUM_IMAGES
    return image_id1, image_id2


_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS pose_priors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    position BLOB,
    coordinate_system INTEGER NOT NULL,
    position_covariance BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    config INTEGER NOT NULL,
    F BLOB,
    E BLOB,
    H BLOB,
    qvec BLOB,
    tvec BLOB);
"""


class Database:
    """COLMAP-schema SQLite database."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)
        self.conn.commit()

    def close(self):
        self.conn.commit()
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    # -- cameras -----------------------------------------------------------
    def write_camera(self, model_id: int, width: int, height: int,
                     params: np.ndarray, prior_focal_length: bool = False,
                     camera_id: Optional[int] = None) -> int:
        blob = np.asarray(params, dtype=np.float64).tobytes()
        cur = self.conn.execute(
            "INSERT INTO cameras (camera_id, model, width, height, params, prior_focal_length)"
            " VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, int(model_id), int(width), int(height), blob, int(prior_focal_length)),
        )
        return cur.lastrowid

    def read_cameras(self) -> Dict[int, dict]:
        out = {}
        for cid, model, w, h, blob, prior in self.conn.execute(
            "SELECT camera_id, model, width, height, params, prior_focal_length FROM cameras"
        ):
            out[cid] = dict(
                camera_id=cid,
                model_id=model,
                width=w,
                height=h,
                params=np.frombuffer(blob, dtype=np.float64).copy(),
                prior_focal_length=bool(prior),
            )
        return out

    # -- images ------------------------------------------------------------
    def write_image(self, name: str, camera_id: int, image_id: Optional[int] = None) -> int:
        cur = self.conn.execute(
            "INSERT INTO images (image_id, name, camera_id) VALUES (?, ?, ?)",
            (image_id, name, camera_id),
        )
        return cur.lastrowid

    def read_images(self) -> Dict[int, dict]:
        return {
            iid: dict(image_id=iid, name=name, camera_id=cid)
            for iid, name, cid in self.conn.execute(
                "SELECT image_id, name, camera_id FROM images"
            )
        }

    def num_images(self) -> int:
        return self.conn.execute("SELECT COUNT(*) FROM images").fetchone()[0]

    # -- pose priors ---------------------------------------------------------
    def write_pose_prior(self, image_id: int, position: np.ndarray,
                         coordinate_system: int = 0,
                         covariance: Optional[np.ndarray] = None):
        cov = covariance if covariance is not None else np.full((3, 3), np.nan)
        self.conn.execute(
            "INSERT OR REPLACE INTO pose_priors (image_id, position, coordinate_system, position_covariance)"
            " VALUES (?, ?, ?, ?)",
            (
                image_id,
                np.asarray(position, np.float64).tobytes(),
                coordinate_system,
                np.asarray(cov, np.float64).tobytes(),
            ),
        )

    def read_pose_priors(self) -> Dict[int, dict]:
        out = {}
        for iid, pos, cs, cov in self.conn.execute(
            "SELECT image_id, position, coordinate_system, position_covariance FROM pose_priors"
        ):
            out[iid] = dict(
                position=np.frombuffer(pos, np.float64).copy(),
                coordinate_system=cs,
                covariance=np.frombuffer(cov, np.float64).copy().reshape(3, 3),
            )
        return out

    # -- keypoints/descriptors ----------------------------------------------
    def write_keypoints(self, image_id: int, keypoints: np.ndarray):
        """keypoints: (N, >=2) float32 — x, y [, affine a11 a12 a21 a22].

        The reference stores 2/4/6-column float32 (feature/types.h:41).
        """
        kp = np.asarray(keypoints, dtype=np.float32)
        self.conn.execute(
            "INSERT OR REPLACE INTO keypoints (image_id, rows, cols, data) VALUES (?, ?, ?, ?)",
            (image_id, kp.shape[0], kp.shape[1] if kp.ndim > 1 else 0, kp.tobytes()),
        )

    def num_keypoints(self, image_id: int) -> int:
        """Stored keypoint count, 0 if absent (extraction resume:
        reference feature_extraction.cc skips images with existing
        features)."""
        row = self.conn.execute(
            "SELECT rows FROM keypoints WHERE image_id = ?",
            (int(image_id),)).fetchone()
        return int(row[0]) if row is not None else 0

    def read_keypoints(self, image_id: int) -> Optional[np.ndarray]:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?", (image_id,)
        ).fetchone()
        if row is None:
            return None
        r, c, blob = row
        return np.frombuffer(blob, dtype=np.float32).reshape(r, c).copy()

    def write_descriptors(self, image_id: int, descriptors: np.ndarray):
        """descriptors: (N, 128) uint8 (reference: feature/types.h:98)."""
        d = np.asarray(descriptors, dtype=np.uint8)
        self.conn.execute(
            "INSERT OR REPLACE INTO descriptors (image_id, rows, cols, data) VALUES (?, ?, ?, ?)",
            (image_id, d.shape[0], d.shape[1], d.tobytes()),
        )

    def read_descriptors(self, image_id: int) -> Optional[np.ndarray]:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM descriptors WHERE image_id=?", (image_id,)
        ).fetchone()
        if row is None:
            return None
        r, c, blob = row
        return np.frombuffer(blob, dtype=np.uint8).reshape(r, c).copy()

    # -- matches / two-view geometry ------------------------------------------
    def write_matches(self, image_id1: int, image_id2: int, matches: np.ndarray):
        """matches: (N, 2) uint32 feature index pairs."""
        m = np.asarray(matches, dtype=np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        pid = image_pair_to_pair_id(image_id1, image_id2)
        self.conn.execute(
            "INSERT OR REPLACE INTO matches (pair_id, rows, cols, data) VALUES (?, ?, ?, ?)",
            (pid, m.shape[0], 2, np.ascontiguousarray(m).tobytes()),
        )

    def read_matches(self, image_id1: int, image_id2: int) -> Optional[np.ndarray]:
        pid = image_pair_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, data FROM matches WHERE pair_id=?", (pid,)
        ).fetchone()
        if row is None:
            return None
        n, blob = row
        m = np.frombuffer(blob, dtype=np.uint32).reshape(n, 2).copy()
        if image_id1 > image_id2:
            m = m[:, ::-1]
        return m

    def write_two_view_geometry(self, image_id1: int, image_id2: int,
                                inlier_matches: np.ndarray, config: int,
                                F=None, E=None, H=None, qvec=None, tvec=None):
        m = np.asarray(inlier_matches, dtype=np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        pid = image_pair_to_pair_id(image_id1, image_id2)

        def b(x, default_shape):
            arr = np.asarray(x, np.float64) if x is not None else np.eye(*default_shape) if len(default_shape) == 2 else np.zeros(default_shape)
            return arr.tobytes()

        self.conn.execute(
            "INSERT OR REPLACE INTO two_view_geometries"
            " (pair_id, rows, cols, data, config, F, E, H, qvec, tvec)"
            " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (
                pid,
                m.shape[0],
                2,
                np.ascontiguousarray(m).tobytes(),
                int(config),
                b(F, (3, 3)),
                b(E, (3, 3)),
                b(H, (3, 3)),
                b(qvec, (4,)),
                b(tvec, (3,)),
            ),
        )

    def read_two_view_geometry(self, image_id1: int, image_id2: int) -> Optional[dict]:
        pid = image_pair_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, data, config, F, E, H, qvec, tvec FROM two_view_geometries WHERE pair_id=?",
            (pid,),
        ).fetchone()
        if row is None:
            return None
        n, blob, config, F, E, H, qvec, tvec = row
        m = np.frombuffer(blob, dtype=np.uint32).reshape(n, 2).copy() if n else np.zeros((0, 2), np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        return dict(
            inlier_matches=m,
            config=config,
            F=np.frombuffer(F, np.float64).reshape(3, 3).copy(),
            E=np.frombuffer(E, np.float64).reshape(3, 3).copy(),
            H=np.frombuffer(H, np.float64).reshape(3, 3).copy(),
            qvec=np.frombuffer(qvec, np.float64).copy(),
            tvec=np.frombuffer(tvec, np.float64).copy(),
        )

    def read_all_two_view_geometries(self) -> Dict[Tuple[int, int], dict]:
        out = {}
        for pid, n, blob, config in self.conn.execute(
            "SELECT pair_id, rows, data, config FROM two_view_geometries"
        ):
            pair = pair_id_to_image_pair(pid)
            m = np.frombuffer(blob, dtype=np.uint32).reshape(n, 2).copy() if n else np.zeros((0, 2), np.uint32)
            out[pair] = dict(inlier_matches=m, config=config)
        return out

    def num_matched_pairs(self) -> int:
        return self.conn.execute("SELECT COUNT(*) FROM matches").fetchone()[0]

    def num_verified_pairs(self) -> int:
        return self.conn.execute(
            "SELECT COUNT(*) FROM two_view_geometries WHERE rows > 0"
        ).fetchone()[0]

    def commit(self):
        self.conn.commit()
