"""Feature matching + geometric verification pipeline: pairs -> database.

Port of colmap_tpu/controllers/feature_matching.py:

- each image's descriptors are prepared once into a device-resident pool
  (slot-addressed, FIFO eviction), and each pair block gathers both sides
  from the pool and runs the fused matcher kernel
  (features/hopper_matcher.py) on a CUDA device, its plain twin on the CPU;
- the block is verified by the batched two-view cascade
  (estimators/two_view_geometry.py), split into pair chunks whose RANSAC
  sample draws stay within a memory budget;
- with `guided_matching`, each verified pair is matched again with its
  candidates gated by the epipolar constraint, both sides read from the
  pool at the pool's one capacity;
- matches and verified geometries are written to SQLite, one transaction
  per block;
- with `num_devices` > 1 each block's pairs split over a device mesh, each
  shard with its own pool and generator (unlike the JAX package, whose
  multi-device branch matches without the pool).

The strategies (exhaustive, sequential with loop detection, spatial,
imported pairs, vocab tree, transitive) generate the pair blocks.
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
from colmap_tpu_torch.parallel.mesh import run_shards, shard_mesh
from colmap_tpu_torch.retrieval import visual_index as vi_mod
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

    def block_view(self, image_id: int) -> matching_mod.DescriptorBlock:
        """(cap, ...) DescriptorBlock view of one pooled image."""
        s = self.slot_of[image_id]
        return matching_mod.DescriptorBlock(
            centered=self.centered[s], row_sum=self.row_sum[s],
            inv_norm=self.inv_norm[s], valid=self.valid[s])


@dataclasses.dataclass
class MatchingStats:
    num_matched_pairs: int = 0
    num_verified_pairs: int = 0
    num_inlier_matches: int = 0
    num_pairs: int = 0  # pairs handed to the matcher
    num_blocks: int = 0  # pair blocks matched (one matcher call each)
    pool_builds: int = 0  # descriptor pools allocated (capacity growth)

    def add(self, other: "MatchingStats"):
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name)
                    + getattr(other, f.name))


def _verify(generator, arrays: Dict[str, np.ndarray], opts, device):
    """Batched two-view verification of a block, in pair chunks."""
    B, mcap = arrays["mvalid"].shape
    # the largest budget of the E, F and H solvers' minimal samples (a
    # fixed budget is the same for all three; an adaptive one grows with
    # the sample size, so F's 7 sets it)
    hyps = max(opts.ransac.resolved_num_samples(k) for k in (4, 5, 7))
    chunk = max(1, min(B, VERIFY_ELEMS // (hyps * mcap)))
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


class _Shard:
    """One shard's matcher state: its device, its descriptor pool (grown
    with the block capacity) and its verification generator."""

    def __init__(self, device, seed: int):
        self.device = device
        self.pool: Optional[_DevicePool] = None
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)


@dataclasses.dataclass
class _PartResult:
    pair_matches: List[np.ndarray]
    res: tvg.TwoViewGeometry
    guided: Dict[int, np.ndarray]
    pool_built: bool
    match_s: float
    verify_s: float


def _match_and_verify_part(shard: _Shard, data: _ImageData, part, cap: int,
                           options: FeatureMatchingOptions) -> _PartResult:
    """Match, verify and (optionally) guide-match the pairs `part` on the
    shard's device. Reads only images already in `data`'s cache and writes
    nothing to the database, so shard threads may run it at once."""
    t0 = time.perf_counter()
    pool_built = shard.pool is None or shard.pool.cap < cap
    if pool_built:
        # the pool holds at least one block's images; slots beyond the
        # database's image count would never be used
        size = max(options.descriptor_pool_size, 2 * options.block_pairs)
        shard.pool = _DevicePool(cap, pool_size=min(size, len(data.images)),
                                 device=shard.device)
    shard.pool.ensure([im for ab in part for im in ab], data)
    midx = shard.pool.match_block(part, options.matching)
    t_match = time.perf_counter()

    # ---- per-pair correspondences (host) ----
    pair_matches = []
    for i in range(len(part)):
        m = matching_mod.matches_to_pairs(midx[i])
        pair_matches.append(m[: options.max_num_matches])

    # ---- batched verification ----
    mcap = max(16, max((len(m) for m in pair_matches), default=16))
    mcap = int(2 ** np.ceil(np.log2(mcap)))
    B = len(part)
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
    for i, ((a, b), m) in enumerate(zip(part, pair_matches)):
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
        cam_a = data.cameras[data.images[a]["camera_id"]]
        cam_b = data.cameras[data.images[b]["camera_id"]]
        arrays["sizes1"][i] = (cam_a["width"], cam_a["height"])
        arrays["sizes2"][i] = (cam_b["width"], cam_b["height"])
    res = _verify(shard.generator, arrays, options.verification, shard.device)
    t_verify = time.perf_counter()
    guided = (_guided_matches(shard.pool, data, part, pair_matches, res,
                              options, shard.device)
              if options.guided_matching else {})
    return _PartResult(pair_matches, res, guided, pool_built,
                       t_match - t0, t_verify - t_match)


def match_and_verify_blocks(
    database: Database,
    pair_blocks: Iterable[Sequence[Tuple[int, int]]],
    options: FeatureMatchingOptions = FeatureMatchingOptions(),
    seed: int = 0,
    device="cuda",
) -> MatchingStats:
    """Match + verify all pair blocks on `device` and persist matches and
    two-view geometries.

    With `options.num_devices` > 1 (0 = every local card) each block's
    pairs split into contiguous parts over a mesh of that many shards, at
    most one per card present on `cuda` (parallel/mesh.py): each shard
    matches its part from a descriptor pool of its own and verifies it
    with a generator of its own (seeded seed + rank), on its device and
    thread; the host then writes the block's rows in pair order. The matches equal one device's; the
    verification draws differ."""
    cameras = database.read_cameras()
    data = _ImageData(database, cameras)
    stats = MatchingStats()
    mesh = shard_mesh(options.num_devices, device)
    shards = ([_Shard(d, seed + k) for k, d in enumerate(mesh.devices)]
              if mesh is not None else [_Shard(device, seed)])

    for block in pair_blocks:
        block = list(block)
        if not block:
            continue
        # per-block pow2 capacity: the matcher's work is quadratic in it
        # (this also loads every image of the block into data's cache
        # before any shard thread reads it)
        t_block = time.perf_counter()
        n_max = max((len(data.get(im)["desc"]) for ab in block for im in ab),
                    default=1)
        cap = min(options.feature_capacity,
                  1 << max(8, int(n_max - 1).bit_length()))
        if mesh is None:
            parts = [block]
            results = [_match_and_verify_part(shards[0], data, block, cap,
                                              options)]
        else:
            per = -(-len(block) // mesh.size)
            parts = [block[k * per:(k + 1) * per] for k in range(mesh.size)]
            results = run_shards(mesh, lambda g: (
                _match_and_verify_part(shards[g.rank], data, parts[g.rank],
                                       cap, options)
                if parts[g.rank] else None))
        done = [(p, r) for p, r in zip(parts, results) if r is not None]
        stats.num_pairs += len(block)
        stats.num_blocks += 1
        stats.pool_builds += sum(r.pool_built for _, r in done)
        logger.info("pair block: %d pairs cap %d on %d shard(s) (match "
                    "%.2fs, verify %.2fs, block %.2fs)", len(block), cap,
                    len(shards), max(r.match_s for _, r in done),
                    max(r.verify_s for _, r in done),
                    time.perf_counter() - t_block)

        for part, r in done:
            for (a, b), m in zip(part, r.pair_matches):
                if len(m) > 0:
                    database.write_matches(a, b, m)
                    stats.num_matched_pairs += 1
        for part, r in done:
            res = r.res
            for i, ((a, b), m) in enumerate(zip(part, r.pair_matches)):
                ni = int(res.num_inliers[i])
                if len(m) == 0 or ni < options.min_num_inliers:
                    continue
                if int(res.config[i]) == int(tvg.TwoViewConfig.WATERMARK):
                    continue  # reference: watermark pairs are not used
                if i in r.guided:
                    inlier_matches = r.guided[i]
                else:
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


def _guided_matches(pool: _DevicePool, data: _ImageData, block,
                    pair_matches, res, options: FeatureMatchingOptions,
                    device) -> Dict[int, np.ndarray]:
    """Guided matching of a block's verified pairs (reference: the guided
    matcher workers, feature_matching_utils.cc): each side's descriptors
    and keypoints at the pool's capacity, candidates gated by the pair's F.
    Returns {pair index: matches} where the guided set is the larger."""
    guided = {}
    for i, ((a, b), m) in enumerate(zip(block, pair_matches)):
        if len(m) == 0 or int(res.num_inliers[i]) < options.min_num_inliers:
            continue
        xy = []
        for im in (a, b):
            p = np.zeros((pool.cap, 2), np.float32)
            kp = data.get(im)["xy"][:pool.cap]
            p[:len(kp)] = kp
            xy.append(torch.as_tensor(p, device=device))
        gm = matching_mod.guided_match_descriptors(
            pool.block_view(a), pool.block_view(b), xy[0], xy[1],
            torch.as_tensor(res.F[i], dtype=torch.float32, device=device),
            max_epipolar_error=options.verification.max_error_px,
            options=options.matching)
        gmp = matching_mod.matches_to_pairs(gm)
        if len(gmp) > len(m):
            guided[i] = gmp[: options.max_num_matches]
    return guided


def match_exhaustive(database: Database,
                     options: FeatureMatchingOptions = FeatureMatchingOptions(),
                     pairing: Optional[pairing_mod.ExhaustivePairingOptions] = None,
                     seed: int = 0, device="cuda") -> MatchingStats:
    ids = sorted(database.read_images().keys())
    blocks = pairing_mod.exhaustive_pairs(
        ids, pairing or pairing_mod.ExhaustivePairingOptions())
    return match_and_verify_blocks(database, blocks, options, seed, device)


def _chunk(pairs: List[Tuple[int, int]], n: int):
    for i in range(0, len(pairs), n):
        yield pairs[i:i + n]


def _filter_existing(database: Database, pairs):
    """Skip pairs with an existing two-view geometry (reference:
    FeatureMatcherCache existing-match checks — re-running a matcher over
    a partially matched database only matches the NEW pairs)."""
    done = {tuple(sorted(k)) for k in database.read_all_two_view_geometries()}
    if not done:
        return pairs
    return [p for p in pairs if tuple(sorted(p)) not in done]


def match_sequential(database: Database,
                     options: FeatureMatchingOptions = FeatureMatchingOptions(),
                     pairing: Optional[pairing_mod.SequentialPairingOptions] = None,
                     seed: int = 0, device="cuda") -> MatchingStats:
    """Sequential matching of the images in name order, with vocab-tree
    loop detection when `pairing.loop_detection` is set (reference:
    SequentialFeatureMatcher, SequentialPairGenerator)."""
    images = database.read_images()
    ids = [iid for iid, _ in sorted(images.items(), key=lambda kv: kv[1]["name"])]
    popts = pairing or pairing_mod.SequentialPairingOptions()
    pairs = pairing_mod.sequential_pairs(ids, popts)
    num_sequential = len(pairs)
    if popts.loop_detection:
        # vocab-tree loop closure (reference: SequentialPairGenerator,
        # feature/pairing.h:89-110) — retrieval pairs join the temporal set
        loop = pairing_mod.sequential_loop_detection_pairs(
            database, ids, popts, seed=seed, device=device)
        pairs = sorted(set(pairs) | set(loop))
    new = _filter_existing(database, pairs)
    logger.info("sequential pairs: %d from the window, %d more from loop "
                "detection; %d already verified are skipped", num_sequential,
                len(pairs) - num_sequential, len(pairs) - len(new))
    return match_and_verify_blocks(
        database, _chunk(new, options.block_pairs), options, seed, device)


def match_spatial(database: Database,
                  options: FeatureMatchingOptions = FeatureMatchingOptions(),
                  pairing: Optional[pairing_mod.SpatialPairingOptions] = None,
                  seed: int = 0, device="cuda") -> MatchingStats:
    """Spatial matching by pose priors (reference: SpatialFeatureMatcher)."""
    pairs = pairing_mod.spatial_pairs_from_database(
        database, pairing or pairing_mod.SpatialPairingOptions(), device)
    return match_and_verify_blocks(
        database, _chunk(pairs, options.block_pairs), options, seed, device)


def match_pairs(database: Database, pairs: List[Tuple[int, int]],
                options: FeatureMatchingOptions = FeatureMatchingOptions(),
                seed: int = 0, device="cuda") -> MatchingStats:
    """Imported pair list (reference: ImportedPairGenerator)."""
    return match_and_verify_blocks(
        database, _chunk(pairs, options.block_pairs), options, seed, device)


def match_vocab_tree(database: Database,
                     options: FeatureMatchingOptions = FeatureMatchingOptions(),
                     vocab_tree_path: Optional[str] = None,
                     num_neighbors: int = 5,
                     seed: int = 0, device="cuda") -> MatchingStats:
    """Vocab-tree retrieval matching (reference: VocabTreeFeatureMatcher,
    controllers/feature_matching.h). Builds (or loads) the visual index,
    retrieves each image's neighbors, matches those pairs."""
    if vocab_tree_path:
        vi = vi_mod.VisualIndex.load(vocab_tree_path, device=device)
    else:
        vi = vi_mod.build_vocab_tree_from_database(
            database, vi_mod.VisualIndexOptions(), seed=seed, device=device)
    pairs = vi_mod.vocab_tree_pairs(database, vi, num_neighbors)
    return match_and_verify_blocks(
        database, _chunk(pairs, options.block_pairs), options, seed, device)


def match_transitive(database: Database,
                     options: FeatureMatchingOptions = FeatureMatchingOptions(),
                     num_iterations: int = 3,
                     seed: int = 0, device="cuda") -> MatchingStats:
    """Transitive closure matching (reference: TransitiveFeatureMatcher)."""
    total = MatchingStats()
    for _ in range(num_iterations):
        existing = [k for k in database.read_all_two_view_geometries()]
        new_pairs = pairing_mod.transitive_pairs(existing)
        new_pairs = [p for p in new_pairs
                     if database.read_matches(*p) is None]
        if not new_pairs:
            break
        total.add(match_and_verify_blocks(
            database, _chunk(new_pairs, options.block_pairs), options, seed,
            device))
    return total
