"""Feature matching + geometric verification pipeline: pairs -> database.

Port of the single-device path of colmap_tpu/controllers/feature_matching.py:

- each image's descriptors are prepared once into a device-resident pool
  (slot-addressed, FIFO eviction), and each pair block gathers both sides
  from the pool and runs the fused matcher kernel
  (features/hopper_matcher.py) on a CUDA device, its plain twin on the CPU;
- the block is verified by the batched two-view cascade
  (estimators/two_view_geometry.py), split into pair chunks whose RANSAC
  sample draws stay within a memory budget;
- matches and verified geometries are written to SQLite, one transaction
  per block.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from colmap_tpu_torch.estimators import two_view_geometry as tvg
from colmap_tpu_torch.features import hopper_matcher
from colmap_tpu_torch.features import matching as matching_mod
from colmap_tpu_torch.features import pairing as pairing_mod
from colmap_tpu_torch.features.sift import affine_to_keypoints
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.sensor import models as camera_models

logger = logging.getLogger("colmap_tpu_torch")

# RANSAC sample-draw elements (pairs x samples x matches) per verification
# chunk: the (chunk, 512, mcap) uniform keys are the largest buffer
VERIFY_ELEMS = 1 << 27


@dataclasses.dataclass
class FeatureMatchingOptions:
    matching: matching_mod.MatchingOptions = dataclasses.field(
        default_factory=matching_mod.MatchingOptions)
    verification: tvg.TwoViewGeometryOptions = dataclasses.field(
        default_factory=tvg.TwoViewGeometryOptions)
    guided_matching: bool = False
    max_num_matches: int = 32768
    # per-image descriptor capacity ceiling for the batched pair program
    feature_capacity: int = 8192
    block_pairs: int = 32
    # device-resident descriptor pool slots (FIFO re-upload beyond this)
    descriptor_pool_size: int = 1024
    min_num_inliers: int = 15
    num_devices: int = 1


class _ImageData:
    """Host-side per-image cache of descriptors/keypoints/rays."""

    def __init__(self, db: Database, cameras: Dict[int, dict]):
        self.db = db
        self.cameras = cameras
        self.images = db.read_images()
        self._cache: Dict[int, dict] = {}

    def get(self, image_id: int) -> dict:
        if image_id not in self._cache:
            desc = self.db.read_descriptors(image_id)
            kp = self.db.read_keypoints(image_id)
            xy, _, _ = affine_to_keypoints(kp)
            cam = self.cameras[self.images[image_id]["camera_id"]]
            params = camera_models.pad_params(list(cam["params"]))
            rays = camera_models.cam_from_img(
                cam["model_id"], torch.as_tensor(params),
                torch.as_tensor(np.asarray(xy, np.float32))).numpy()
            i_fx, i_fy, _, _ = camera_models._FXFY_CXCY[
                camera_models.CameraModelId(cam["model_id"])]
            focal = 0.5 * (cam["params"][i_fx] + cam["params"][i_fy])
            self._cache[image_id] = {
                "desc": desc, "xy": xy.astype(np.float32),
                "rays": rays.astype(np.float32), "focal": float(focal),
            }
        return self._cache[image_id]


def _pool_add(pool: "_DevicePool", desc_u8: torch.Tensor,
              new_valid: torch.Tensor, slots: torch.Tensor):
    """Prepare raw uint8 descriptors and write them into pool rows (in
    place: the JAX version donates the pool buffers to the same effect)."""
    b = matching_mod.prepare_descriptors(desc_u8, new_valid,
                                         device=desc_u8.device)
    pool.centered[slots] = b.centered
    pool.row_sum[slots] = b.row_sum
    pool.inv_norm[slots] = b.inv_norm
    pool.valid[slots] = b.valid


class _DevicePool:
    """Slot-addressed device pool of prepared descriptor blocks."""

    def __init__(self, cap: int, pool_size: int = 1024, add_bucket: int = 32,
                 device="cuda"):
        self.cap = cap
        self.size = pool_size
        self.add_bucket = add_bucket
        self.device = device
        self.slot_of: Dict[int, int] = {}
        self._fifo: List[int] = []  # image ids in slot-assignment order
        self._next = 0
        self.centered = torch.zeros((pool_size, cap, 128), dtype=torch.int8,
                                    device=device)
        self.row_sum = torch.zeros((pool_size, cap), dtype=torch.float32,
                                   device=device)
        self.inv_norm = torch.zeros((pool_size, cap), dtype=torch.float32,
                                    device=device)
        self.valid = torch.zeros((pool_size, cap), dtype=torch.bool,
                                 device=device)

    def ensure(self, image_ids: Sequence[int], data: _ImageData):
        """Upload the images not yet pooled, add_bucket at a time."""
        unique = list(dict.fromkeys(image_ids))
        # touch pooled block images to the FIFO tail so eviction (while
        # adding the missing ones) can only hit out-of-block images
        present = [i for i in unique if i in self.slot_of]
        if present:
            pset = set(present)
            self._fifo = [i for i in self._fifo if i not in pset] + present
        missing = [i for i in unique if i not in self.slot_of]
        for start in range(0, len(missing), self.add_bucket):
            chunk = missing[start: start + self.add_bucket]
            desc = np.zeros((len(chunk), self.cap, 128), np.uint8)
            val = np.zeros((len(chunk), self.cap), bool)
            slots = np.zeros(len(chunk), np.int64)
            for k, iid in enumerate(chunk):
                d = data.get(iid)["desc"]
                n = min(len(d), self.cap)
                desc[k, :n] = d[:n]
                val[k, :n] = True
                if self._next >= self.size:  # FIFO eviction
                    old = self._fifo.pop(0)
                    slots[k] = self.slot_of.pop(old)
                else:
                    slots[k] = self._next
                    self._next += 1
                self.slot_of[iid] = int(slots[k])
                self._fifo.append(iid)
            _pool_add(self, torch.as_tensor(desc, device=self.device),
                      torch.as_tensor(val, device=self.device),
                      torch.as_tensor(slots, device=self.device))

    def gather(self, image_ids: Sequence[int]) -> matching_mod.DescriptorBlock:
        """(B, cap, ...) DescriptorBlock of the given pooled images."""
        idx = torch.as_tensor([self.slot_of[i] for i in image_ids],
                              dtype=torch.int64, device=self.device)
        return matching_mod.DescriptorBlock(
            centered=self.centered[idx], row_sum=self.row_sum[idx],
            inv_norm=self.inv_norm[idx], valid=self.valid[idx])

    def match_block(self, block: Sequence[Tuple[int, int]],
                    options: matching_mod.MatchingOptions) -> np.ndarray:
        """Match the pairs of a block: (B, cap) int32 indices (host)."""
        b1 = self.gather([a for a, _ in block])
        b2 = self.gather([b for _, b in block])
        return hopper_matcher.match_pairs_batch_fused(
            b1, b2, options).cpu().numpy()


@dataclasses.dataclass
class MatchingStats:
    num_matched_pairs: int = 0
    num_verified_pairs: int = 0
    num_inlier_matches: int = 0


def _verify(generator, arrays: Dict[str, np.ndarray], opts, device):
    """Batched two-view verification of a block, in pair chunks."""
    B, mcap = arrays["mvalid"].shape
    chunk = max(1, min(B, VERIFY_ELEMS // (opts.ransac.num_samples * mcap)))
    parts = []
    for s in range(0, B, chunk):
        t = {k: torch.as_tensor(v[s:s + chunk], device=device)
             for k, v in arrays.items()}
        res = tvg.estimate_two_view_geometry(
            generator, t["rays1"], t["rays2"], t["pix1"], t["pix2"],
            t["mvalid"], t["focal"], opts, sizes1=t["sizes1"],
            sizes2=t["sizes2"])
        parts.append([x.cpu().numpy() for x in res])
    return tvg.TwoViewGeometry(*(np.concatenate(p) for p in zip(*parts)))


def match_and_verify_blocks(
    database: Database,
    pair_blocks: Iterable[Sequence[Tuple[int, int]]],
    options: FeatureMatchingOptions = FeatureMatchingOptions(),
    seed: int = 0,
    device="cuda",
) -> MatchingStats:
    """Match + verify all pair blocks on `device` and persist matches and
    two-view geometries."""
    if options.guided_matching:
        raise NotImplementedError("guided matching: ROADMAP queue 1 item 3")
    if options.num_devices != 1:
        raise NotImplementedError("multi-device matching: ROADMAP queue 1 "
                                  "item 11")
    cameras = database.read_cameras()
    data = _ImageData(database, cameras)
    stats = MatchingStats()
    pool: Optional[_DevicePool] = None
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    match_opts = options.matching
    verify_opts = options.verification

    for block in pair_blocks:
        block = list(block)
        if not block:
            continue
        # per-block pow2 capacity: the matcher's work is quadratic in it
        t_block = time.perf_counter()
        n_max = max((len(data.get(im)["desc"]) for ab in block for im in ab),
                    default=1)
        cap = min(options.feature_capacity,
                  1 << max(8, int(n_max - 1).bit_length()))
        if pool is None or pool.cap < cap:
            # the pool holds at least one block's images; slots beyond the
            # database's image count would never be used
            size = max(options.descriptor_pool_size, 2 * options.block_pairs)
            pool = _DevicePool(cap, pool_size=min(size, len(data.images)),
                               device=device)
        pool.ensure([im for ab in block for im in ab], data)
        midx = pool.match_block(block, match_opts)
        t_match = time.perf_counter()

        # ---- per-pair correspondences (host) ----
        pair_matches = []
        for i, (a, b) in enumerate(block):
            m = matching_mod.matches_to_pairs(midx[i])
            if len(m) > options.max_num_matches:
                m = m[: options.max_num_matches]
            pair_matches.append(m)
            if len(m) > 0:
                database.write_matches(a, b, m)
                stats.num_matched_pairs += 1

        # ---- batched verification ----
        mcap = max(16, max((len(m) for m in pair_matches), default=16))
        mcap = int(2 ** np.ceil(np.log2(mcap)))
        B = len(block)
        arrays = {
            "rays1": np.zeros((B, mcap, 2), np.float32),
            "rays2": np.zeros((B, mcap, 2), np.float32),
            "pix1": np.zeros((B, mcap, 2), np.float32),
            "pix2": np.zeros((B, mcap, 2), np.float32),
            "mvalid": np.zeros((B, mcap), bool),
            "focal": np.ones(B, np.float32),
            "sizes1": np.ones((B, 2), np.float32),
            "sizes2": np.ones((B, 2), np.float32),
        }
        for i, ((a, b), m) in enumerate(zip(block, pair_matches)):
            if len(m) == 0:
                continue
            da, db_ = data.get(a), data.get(b)
            n = min(len(m), mcap)
            arrays["rays1"][i, :n] = da["rays"][m[:n, 0]]
            arrays["rays2"][i, :n] = db_["rays"][m[:n, 1]]
            arrays["pix1"][i, :n] = da["xy"][m[:n, 0]]
            arrays["pix2"][i, :n] = db_["xy"][m[:n, 1]]
            arrays["mvalid"][i, :n] = True
            arrays["focal"][i] = np.sqrt(da["focal"] * db_["focal"])
            cam_a = cameras[data.images[a]["camera_id"]]
            cam_b = cameras[data.images[b]["camera_id"]]
            arrays["sizes1"][i] = (cam_a["width"], cam_a["height"])
            arrays["sizes2"][i] = (cam_b["width"], cam_b["height"])
        res = _verify(generator, arrays, verify_opts, device)
        t_verify = time.perf_counter()
        logger.info("pair block: %d pairs cap %d (match %.2fs, verify %.2fs)",
                    len(block), cap, t_match - t_block, t_verify - t_match)

        for i, ((a, b), m) in enumerate(zip(block, pair_matches)):
            ni = int(res.num_inliers[i])
            if len(m) == 0 or ni < options.min_num_inliers:
                continue
            if int(res.config[i]) == int(tvg.TwoViewConfig.WATERMARK):
                continue  # reference: watermark pairs are not used
            inlier_matches = m[res.inlier_mask[i][: len(m)]]
            pose = res.cam2_from_cam1[i]
            database.write_two_view_geometry(
                a, b, inlier_matches, config=int(res.config[i]),
                F=res.F[i], E=res.E[i], H=res.H[i],
                qvec=pose[:4], tvec=pose[4:])
            stats.num_verified_pairs += 1
            stats.num_inlier_matches += len(inlier_matches)

        database.commit()
    return stats


def match_exhaustive(database: Database,
                     options: FeatureMatchingOptions = FeatureMatchingOptions(),
                     pairing: Optional[pairing_mod.ExhaustivePairingOptions] = None,
                     seed: int = 0, device="cuda") -> MatchingStats:
    ids = sorted(database.read_images().keys())
    blocks = pairing_mod.exhaustive_pairs(
        ids, pairing or pairing_mod.ExhaustivePairingOptions())
    return match_and_verify_blocks(database, blocks, options, seed, device)
