"""Drive the PyTorch / CUDA port from pixels to a sparse model on one GPU.

    python3 chip_smoke.py

Runs colmap_tpu_torch (never jax or colmap_tpu) at the size of the repo's
DSLR gate: 20 rendered 1536x1152 images, Quality.HIGH (8192 features),
one PINHOLE camera, exhaustive pairing (190 pairs in one block), then the
incremental mapper. Phases:

1. device: fails without CUDA; prints the card's name and power limit;
2. build: compiles the matcher kernel (csrc/matcher_top2.cu) with nvcc;
3. kernel against its plain twin on the card at (B=8, N=M=8192) and
   (B=190, N=M=1024) with padding rows: indices exactly equal, best /
   second / reverse best bit-equal; prints both times, the least time the
   card could take (bound_ms, from B, N and M) and the kernel's share of
   it, and at 8 x 8192^2 torch._int_mm over the same products (one call per
   pair: a yardstick of an unfused route, which the port never calls);
4. main path: run_automatic_reconstruction(sparse=True) on cuda, with the
   kernel launch counter zeroed just before it and read just after; prints
   the extraction, matching and mapping seconds, the mapper's stage
   seconds, its BA counters (calls, LM iterations, CG steps, host
   synchronizations) and the peak device memory;
5. outcome: every verified pair's relative rotation, recovered from its
   stored E and inlier matches, within 1 deg of ground truth, and every
   image in a verified pair with >= 100 inliers; the model: all 20 images
   registered, after a Sim3 alignment to the ground truth every rotation
   within 1 deg and every centre within 0.05 x the room size (the gate the
   JAX mapper is held to in tests/test_torch_frontend.py), and sparse/0
   read back; then the mapper once more on the same database, warm, its
   model held to the same gates;
6. [ba]: one bundle adjustment at the JAX bench's size (bench.py:74-90:
   500 poses, 50k points, 300k observations, SIMPLE_RADIAL, 10 LM
   iterations of 20 CG steps, no early exit): LM iterations/s and the
   top five device ops under torch.profiler (colmap_tpu_torch/bench_ba.py).

The second-to-last line is the kernel report, one JSON object: its ms,
plain_ms and bound_ms are those of the main path's shape (B=190,
N=M=1024), `shapes` holds both shapes. The last line is {"ok": true,
"device": {...}}. Any failed check exits nonzero.
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

from colmap_tpu_torch import bench_ba, cuda_build  # noqa: E402
from colmap_tpu_torch.bench_matcher import (  # noqa: E402
    bound_ms, cuda_ms, int_mm_ms, random_blocks)
from colmap_tpu_torch.controllers import automatic_reconstruction as ar  # noqa: E402
from colmap_tpu_torch.controllers.incremental_pipeline import (  # noqa: E402
    IncrementalPipeline)
from colmap_tpu_torch.estimators.similarity_transform import (  # noqa: E402
    compare_reconstructions)
from colmap_tpu_torch.features import hopper_matcher as hm  # noqa: E402
from colmap_tpu_torch.features import pairing  # noqa: E402
from colmap_tpu_torch.geometry import rotation as rot  # noqa: E402
from colmap_tpu_torch.geometry.essential import (  # noqa: E402
    pose_from_essential_matrix)
from colmap_tpu_torch.scene import reconstruction_io  # noqa: E402
from colmap_tpu_torch.scene import synthetic_images as synth  # noqa: E402
from colmap_tpu_torch.scene.reconstruction import (  # noqa: E402
    Camera, Image, Reconstruction)
from colmap_tpu_torch.sensor import models as cam_models  # noqa: E402


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(msg):
    print(msg, flush=True)


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
              "replaces": "colmap_tpu/features/pallas_matcher.py:57",
              "library_ms": None, "shapes": []}
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
        ms = cuda_ms(lambda: hm.top2_fwd_rev(b1, b2), 20)
        plain_ms = cuda_ms(lambda: hm._top2_fwd_rev_reference(b1, b2), 3)
        ms = min(ms, cuda_ms(lambda: hm.top2_fwd_rev(b1, b2), 20))
        bound, bound_by = bound_ms(B, n, n)
        shape = {"B": B, "N": n, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound, "share": bound / ms}
        if B == 8:
            shape["int_mm_ms"] = int_mm_ms(b1, b2, 5)
        report["shapes"].append(shape)
        phase(f"[kernel] B={B} N=M={n}: indices equal, best/second/rev "
              f"bit-equal; kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({bound_by}), share of bound "
              f"{bound / ms:.4f}; int_mm {shape.get('int_mm_ms')} ms; "
              f"matched {float((m_k >= 0).float().mean())}")
        if (B, n) == (190, 1024):  # the main path's shape
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=bound_by)
        del b1, b2, k, r, m_k
    report["max_abs_err"] = max_err

    # ---- 4. main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        main_path(work, report)

    # ---- 6. one bundle adjustment at the JAX bench's size
    res = bench_ba.run()
    phase(f"[ba] {res['poses']} poses, {res['points']} points, "
          f"{res['observations']} observations: {res['lm_iterations']} LM "
          f"iterations x {res['cg_steps'] // res['lm_iterations']} CG steps "
          f"in {min(res['solve_s']):.4f} s (runs {res['solve_s']}), "
          f"{res['lm_iters_per_s']:.3f} LM iterations/s, {res['syncs']} "
          f"syncs; cost {res['cost_before']:.2f} -> {res['cost_after']:.4f}; "
          f"CG Jacobian reads bound {res['cg_bytes_bound_ms']:.4f} ms")
    phase(f"[ba] profiled solve: {res['profiled_wall_ms']:.3f} ms wall, "
          f"{res['profiled_device_ms']:.3f} ms in kernels (busy "
          f"{res['profiled_device_ms'] / res['profiled_wall_ms']:.3f}); "
          f"top kernels: " + "; ".join(
              f"{o['name']} {o['ms']:.3f} ms x{o['calls']}"
              for o in res["top_device_ops"]))
    if not res["cost_after"] < 0.01 * res["cost_before"]:
        fail("bundle adjustment did not lower the cost a hundredfold")

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
        camera_model="PINHOLE", single_camera=True, sparse=True,
        camera_params=",".join(map(str, [K[0, 0], K[1, 1], K[0, 2],
                                         K[1, 2]])))
    stages = {}
    torch.cuda.reset_peak_memory_stats()
    hm.launches = 0
    t0 = time.perf_counter()
    rec, db = ar.run_automatic_reconstruction(opts, stage_timings=stages,
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
          f"matching {stages['matching']:.3f}, mapping "
          f"{stages['mapping']:.3f}, total {wall:.3f}")
    phase("[main] mapping stages s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages["mapping_stages"].items()))
    mba = stages["mapping_ba"]
    phase("[main] mapping BA: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) and not v.is_integer()
        else f"{k} {int(v)}" for k, v in sorted(mba.items())))
    phase(f"[main] BA host syncs: {int(mba['lba_syncs'])} in "
          f"{int(mba['lba_calls'])} local BAs, {int(mba['gba_syncs'])} in "
          f"{int(mba['gba_calls'])} global BAs")
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

    # the model against ground truth
    if rec is None:
        fail("the mapper returned no model")
    gt = Reconstruction()
    gt.add_camera(Camera(camera_id=1, model_id=1, width=1536, height=1152,
                         params=np.array([K[0, 0], K[1, 1], K[0, 2],
                                          K[1, 2]])))
    for i, nm in enumerate(names):
        q = rot.rotmat_to_quat(torch.as_tensor(Rs[i], dtype=torch.float32))
        gt.add_image(Image(image_id=ids[nm], name=nm, camera_id=1,
                           cam_from_world=np.concatenate(
                               [q.numpy(), ts[i]]).astype(np.float64)))
    limit = 0.05 * ropts.room_size
    n_reg = check_model("model", rec, gt, len(names), limit)
    back = reconstruction_io.read_model(os.path.join(opts.workspace_path,
                                                     "sparse", "0"))
    if (back.num_registered_images() != n_reg
            or len(back.points3D) != len(rec.points3D)):
        fail("sparse/0 does not read back as the model written")
    phase(f"[outcome] sparse/0 read back: {back.num_registered_images()} "
          f"images, {len(back.points3D)} points")

    # the mapper again on the same database, warm (the run above paid the
    # CUDA libraries' first loads)
    pipe = IncrementalPipeline(db, device="cuda")
    t0 = time.perf_counter()
    warm = pipe.run()
    torch.cuda.synchronize()
    phase(f"[main] warm mapping {time.perf_counter() - t0:.3f} s; stages s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
              pipe.stage_s.items(), key=lambda kv: -kv[1])))
    if warm is None:
        fail("the warm mapper run returned no model")
    check_model("warm model", warm, gt, len(names), limit)
    db.close()


def check_model(label, rec, gt, n_images, limit):
    """All `n_images` registered and, after a Sim3 alignment to the ground
    truth `gt`, every rotation within 1 deg and every centre within
    `limit`. Returns the registered count."""
    cmp = compare_reconstructions(rec, gt, device="cuda")
    n_reg = rec.num_registered_images()
    phase(f"[outcome] {label}: {n_reg}/{n_images} registered, "
          f"{len(rec.points3D)} points, max rotation error "
          f"{cmp['max_rotation_error_deg']:.6f} deg, max centre error "
          f"{cmp['max_center_error']:.6f} (limit {limit:.3f})")
    if n_reg != n_images:
        fail(f"{label}: only {n_reg} of {n_images} images registered")
    if cmp["max_rotation_error_deg"] > 1.0:
        fail(f"{label}: a rotation is more than 1 deg from ground truth")
    if cmp["max_center_error"] > limit:
        fail(f"{label}: a centre is more than 0.05 x room size from ground "
             "truth")
    return n_reg


if __name__ == "__main__":
    main()
