"""Drive the PyTorch / CUDA port's correspondence front end on one GPU.

    python3 chip_smoke.py

Runs colmap_tpu_torch (never jax or colmap_tpu) at the size of the repo's
DSLR gate: 20 rendered 1536x1152 images, Quality.HIGH (8192 features),
one PINHOLE camera, exhaustive pairing (190 pairs in one block). Phases:

1. device: fails without CUDA; prints the card's name and power limit;
2. build: compiles the matcher kernel (csrc/matcher_top2.cu) with nvcc;
3. kernel against its plain twin on the card at (B=8, N=M=8192) and
   (B=190, N=M=1024) with padding rows: indices exactly equal, forward
   best/second bit-equal; prints both times;
4. main path: run_automatic_reconstruction(sparse=False) on cuda, with the
   kernel launch counter zeroed just before it and read just after;
5. outcome: every verified pair's relative rotation, recovered from its
   stored E and inlier matches, within 1 deg of ground truth, and every
   image in a verified pair with >= 100 inliers.

The second-to-last line is the kernel report, one JSON object; the last
line is {"ok": true, "device": {...}}. Any failed check exits nonzero.
"""

import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from colmap_tpu_torch import cuda_build  # noqa: E402
from colmap_tpu_torch.controllers import automatic_reconstruction as ar  # noqa: E402
from colmap_tpu_torch.features import hopper_matcher as hm  # noqa: E402
from colmap_tpu_torch.features import matching as mm  # noqa: E402
from colmap_tpu_torch.features import pairing  # noqa: E402
from colmap_tpu_torch.geometry import rotation as rot  # noqa: E402
from colmap_tpu_torch.geometry.essential import (  # noqa: E402
    pose_from_essential_matrix)
from colmap_tpu_torch.scene import synthetic_images as synth  # noqa: E402
from colmap_tpu_torch.sensor import models as cam_models  # noqa: E402


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def random_blocks(B, n, seed):
    """A batch of matchable pairs: b2 is a permuted, noised b1, with
    padding rows on both sides."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d1 = torch.randint(0, 200, (B, n, 128), generator=g, device="cuda",
                       dtype=torch.int32)
    perm = torch.randperm(n, generator=g, device="cuda")
    noise = torch.randint(-3, 4, (B, n, 128), generator=g, device="cuda",
                          dtype=torch.int32)
    d2 = torch.clamp(d1[:, perm] + noise, 0, 255)
    v1 = torch.ones(B, n, dtype=torch.bool, device="cuda")
    v2 = v1.clone()
    v1[:, n - n // 8:] = False
    v2[0, : n // 4] = False
    return (mm.prepare_descriptors(d1.to(torch.uint8), v1, device="cuda"),
            mm.prepare_descriptors(d2.to(torch.uint8), v2, device="cuda"))


def main():
    # ---- 1. device
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs only on a GPU")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if not card:
        fail(f"nvidia-smi gave no card: {smi.stderr.strip()}")
    phase(card)
    phase(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}")

    # ---- 2. build
    t0 = time.perf_counter()
    hm.build()
    phase(f"[build] matcher_top2 built in "
          f"{cuda_build.build_seconds['matcher_top2']:.3f} s "
          f"({time.perf_counter() - t0:.3f} s with loading)")

    # ---- 3. kernel against its plain twin on the card
    report = {"name": "matcher_top2", "route": "cuda",
              "source": "colmap_tpu_torch/csrc/matcher_top2.cu",
              "replaces": "colmap_tpu/features/pallas_matcher.py:57"}
    max_err = 0.0
    for B, n in ((8, 8192), (190, 1024)):
        b1, b2 = random_blocks(B, n, seed=B)
        k = hm.top2_fwd_rev(b1, b2)
        r = hm._top2_fwd_rev_reference(b1, b2)
        torch.cuda.synchronize()
        names = ("best", "second", "idx", "rev_best", "rev_idx")
        for name, a, b in zip(names, k, r):
            if not torch.equal(a, b):
                fail(f"kernel != twin for {name} at B={B} N=M={n}: "
                     f"{(a != b).float().mean().item()} of entries differ")
        err = max(float((k[i] - r[i]).abs().max()) for i in (0, 1, 3))
        max_err = max(max_err, err)
        m_k = hm.match_pairs_batch_fused(b1, b2)
        ms = cuda_ms(lambda: hm.top2_fwd_rev(b1, b2), 5)
        plain_ms = cuda_ms(lambda: hm._top2_fwd_rev_reference(b1, b2), 3)
        ms2 = cuda_ms(lambda: hm.top2_fwd_rev(b1, b2), 5)
        phase(f"[kernel] B={B} N=M={n}: indices equal, best/second "
              f"bit-equal; kernel {ms:.4f} / {ms2:.4f} ms, twin "
              f"{plain_ms:.4f} ms; matched {float((m_k >= 0).float().mean())}")
        if (B, n) == (8, 8192):
            report.update(ms=min(ms, ms2), plain_ms=plain_ms)
        del b1, b2, k, r, m_k
    report["max_abs_err"] = max_err

    # ---- 4. main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        main_path(work, report)

    print(json.dumps({"kernels": [report]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main_path(work, report):
    """Phases 4 and 5 in the scratch directory `work`."""
    t0 = time.perf_counter()
    ropts = synth.RoomDatasetOptions(num_images=20, width=1536, height=1152,
                                     focal=0.875 * 1536, seed=11,
                                     texture_res=1536)
    images, K, Rs, ts = synth.render_room_dataset(ropts)
    names = synth.write_dataset(os.path.join(work, "images"), images)
    phase(f"[render] 20 x 1536x1152 in {time.perf_counter() - t0:.3f} s")
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="[log] %(message)s")
    logging.getLogger("colmap_tpu_torch").setLevel(logging.INFO)

    opts = ar.AutomaticReconstructionOptions(
        workspace_path=os.path.join(work, "ws"),
        image_path=os.path.join(work, "images"), quality=ar.Quality.HIGH,
        camera_model="PINHOLE", single_camera=True, sparse=False,
        camera_params=",".join(map(str, [K[0, 0], K[1, 1], K[0, 2],
                                         K[1, 2]])))
    stages = {}
    torch.cuda.reset_peak_memory_stats()
    hm.launches = 0
    t0 = time.perf_counter()
    _, db = ar.run_automatic_reconstruction(opts, stage_timings=stages,
                                            device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hm.launches
    report["launches"] = launches
    peak = torch.cuda.max_memory_allocated()
    ids = {im["name"]: iid for iid, im in db.read_images().items()}
    counts = [db.num_keypoints(ids[nm]) for nm in names]
    geoms = db.read_all_two_view_geometries()
    phase(f"[main] stages s: extraction {stages['extraction']:.3f}, "
          f"matching {stages['matching']:.3f}, total {wall:.3f}")
    phase(f"[main] features per image: {counts}")
    phase(f"[main] matched pairs {db.num_matched_pairs()}, verified pairs "
          f"{len(geoms)} of {len(names) * (len(names) - 1) // 2}")
    n_blocks = sum(1 for _ in pairing.exhaustive_pairs(sorted(ids.values())))
    phase(f"[main] matcher kernel launches {launches} for {n_blocks} pair "
          f"block(s); peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)")
    if launches < n_blocks:
        fail("the main path did not launch the matcher kernel for every "
             "pair block")
    # the JAX package extracts 833 features from the first of these images
    # (CPU run); the port's CPU and GPU runs give the same count
    if min(counts) < 500:
        fail(f"too few features: {counts}")
    for nm in names:
        kp = db.read_keypoints(ids[nm])
        if not (np.isfinite(kp).all() and (kp[:, 0] >= 0).all()
                and (kp[:, 0] < 1536).all() and (kp[:, 1] >= 0).all()
                and (kp[:, 1] < 1152).all()):
            fail(f"keypoints of {nm} are not finite or leave the image")

    # ---- 5. outcome against ground truth
    cam = db.read_cameras()[db.read_images()[ids[names[0]]]["camera_id"]]
    params = torch.as_tensor(cam_models.pad_params(list(cam["params"])))

    def rays(iid):
        xy = db.read_keypoints(iid)[:, :2].astype(np.float32)
        return cam_models.cam_from_img(cam["model_id"], params,
                                       torch.as_tensor(xy))

    index = {ids[nm]: i for i, nm in enumerate(names)}
    worst = 0.0
    strong = set()
    for (a, b) in sorted(geoms):
        g = db.read_two_view_geometry(a, b)
        m = g["inlier_matches"].astype(np.int64)
        if len(m) >= 100:
            strong.update((a, b))
        pose, _, _ = pose_from_essential_matrix(
            torch.as_tensor(g["E"], dtype=torch.float32),
            rays(a)[m[:, 0]], rays(b)[m[:, 1]])
        R_rel = Rs[index[b]] @ Rs[index[a]].T
        q_gt = rot.rotmat_to_quat(torch.as_tensor(R_rel, dtype=torch.float32))
        err = float(rot.quat_angle_deg(q_gt, pose[:4]))
        worst = max(worst, err)
        if err > 1.0:
            fail(f"pair ({a}, {b}): rotation {err:.4f} deg from ground truth "
                 f"({len(m)} inliers, config {g['config']})")
    phase(f"[outcome] {len(geoms)} verified pairs, max rotation error "
          f"{worst:.6f} deg; images in a pair with >= 100 inliers: "
          f"{len(strong)}/{len(names)}")
    if len(strong) != len(names):
        fail("an image has no verified pair with >= 100 inliers")
    db.close()


if __name__ == "__main__":
    main()
