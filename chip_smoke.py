"""Drive the PyTorch / CUDA port from pixels to a sparse model and to a
dense mesh on one GPU.

    python3 chip_smoke.py

Runs colmap_tpu_torch (never jax or colmap_tpu) on six cells, its
command line, its multi-device slice and its scale run. The DSLR
cell is the repo's DSLR gate: 20 rendered 1536x1152 images, Quality.HIGH
(8192 features), one PINHOLE camera, exhaustive pairing (190 pairs in one
block), then the incremental mapper. The VIDEO cell is the JAX package's
pixels-to-model run (scripts/full_scale_run.py) at its per-frame settings
with the depth cut from 1000 frames to 100: a 640x480 orbit around a box
(seed 3, one full turn, so the last frames revisit the first),
Quality.LOW (2048 features), sequential matching with a window of 10, the
quadratic jumps and vocab-tree loop detection (a tree of branching 16 and
depth 3 trained from the database), then the mapper. The hierarchical cell
is the JAX package's hierarchical gate (HIER_GATE_r05.json,
scripts/hierarchical_timing.py) at full size: a synthetic match database
of 200 images on a circle (SIMPLE_RADIAL 1024x768, 4000 points each seen
by its 40 nearest cameras, 0.5 px noise, chained matches of overlap 10,
seed 3) mapped by the hierarchical mapper in leaves of 60 images with 50
overlap images on one worker thread (the faster setting on the card,
PERF.md section 5; the card tests run the pipeline with 3). The dense cell is the JAX bench's
PatchMatch resolution (bench.py:236) end to end: 12 rendered 640x480 room
images (focal 560, seed 11), Quality.HIGH, one SIMPLE_RADIAL camera, then
undistortion, PatchMatch stereo (photometric, then geometric), fusion and
Poisson meshing with the JAX package's defaults. The rig cell is a
4-camera capture rig (colmap_tpu_torch/bench_rig.py: SIMPLE_RADIAL
1024x768 cameras facing front, right, back and left, 125 snapshots, 500
images, 50,000 points, ~300k observations with 0.5 px noise: the JAX
bench's BA size, bench.py:74-90) refined by the rig bundle adjuster. The
prior cell is the pose-prior mapper on the port's synthetic database (100
images on its circle, SIMPLE_RADIAL 1024x768, 3000 points each seen by its
30 nearest cameras, 0.5 px noise, chained matches of overlap 10, seed 5)
with Cartesian position priors. Phases:

1. device: fails without CUDA; prints the card's name and power limit;
2. build: compiles the matcher kernel (csrc/matcher_top2.cu) with nvcc;
3. kernel against its plain twin on the card at (B=8, N=M=8192), the DSLR
   block (B=190, N=M=1024) and a VIDEO block (B=32, N=M=2048), with
   padding rows: indices exactly equal, best / second / reverse best
   bit-equal; prints both times, the least time the card could take
   (bound_ms, from B, N and M), the kernel's share of it, and
   torch._int_mm over the same products (one call per pair: a yardstick of
   an unfused route, which the port never calls);
3b. [pm-kernel]: builds the PatchMatch cost kernel
   (csrc/patch_match_cost.cu) and holds it to its plain twin on the dense
   cell's shape (640x480, 8 sources, a textured plane from
   bench_patch_match.plane_problem) in both passes, one launch of each
   kind the solver makes (`_selector`: the initial costs on both
   colours, a propagation half-iteration's 6 candidates on one colour, a
   refinement half-iteration's 2 on both colours, the last two built in
   the launch) against `_keep_better_reference` on the torch-built
   candidates and copies of the same inputs: costs 1e-4 on
   99.9% of the pixels, 1e-3 on all, the same NaN pixels, the held plane
   kept outside the launch and at NaN held costs, and the twin's kept
   candidate wherever its costs do not tie (2e-3);
   prints the twin's time and the build seconds, then the time of one
   launch of each kind (initial costs, propagation, refinement) with its
   bound; the headline is the photometric propagation launch's;
4. DSLR main path: run_automatic_reconstruction(sparse=True) on cuda, with
   the kernel launch counter zeroed just before it and read just after;
   prints the extraction, matching and mapping seconds, the mapper's stage
   seconds, its BA counters (calls, LM iterations, CG steps, host
   synchronizations) and the peak device memory;
5. DSLR outcome: every verified pair's relative rotation, recovered from
   its stored E and inlier matches, within 1 deg of ground truth, and every
   image in a verified pair with >= 100 inliers; the model: all 20 images
   registered, after a Sim3 alignment to the ground truth every rotation
   within 1 deg and every centre within 0.05 x the room size (the gate the
   JAX mapper is held to in tests/test_torch_frontend.py), and sparse/0
   read back; then the mapper once more on the same database, warm, its
   model held to the same gates;
6. [ba]: one bundle adjustment at the JAX bench's size (bench.py:74-90:
   500 poses, 50k points, 300k observations, SIMPLE_RADIAL, 10 LM
   iterations of 20 CG steps, no early exit): LM iterations/s and the
   top five device ops under torch.profiler (colmap_tpu_torch/bench_ba.py);
7. VIDEO main path: run_automatic_reconstruction(data_type=VIDEO,
   sparse=True) on cuda, the launch counter zeroed just before and read
   just after (at least one launch per pair block); prints the render,
   extraction, matching and mapping seconds, the proposed pairs (window,
   quadratic jumps, loop detection), the vocab tree's build, indexing and
   query seconds (log lines), pair blocks and descriptor-pool builds, the
   mapper's stages and BA counters and the peak device memory. Held: the
   loop is closed (a verified pair joins one of the first 10 frames to one
   of the last 10, which neither the window nor the jumps of 16/32/64
   frames span); >= 95% of all verified inlier matches within 4 px
   (Sampson) of the ground-truth epipolar geometry (the pairs' rotations
   recovered from E are printed: on this scene of planes E is ambiguous
   for many pairs, in the JAX package too, tests/test_torch_orbit_pairs.py);
   and full_scale_run.py's gates: >= 95% of frames registered, max
   rotation error <= 1 deg and max centre error <= 0.05 after a Sim3
   alignment; sparse/0 reads back;
8. hierarchical: synthesize the database, then HierarchicalPipeline on
   cuda with the launch counter zeroed just before and read just after
   (K1 is not on this path: it reads a match database); prints the leaves'
   sizes and the clustering seconds, each cluster's mapping seconds and
   registered images, the merge seconds (alignment, pose graph, fusion),
   the wall seconds, the clusters' summed mapper stages and BA counters and
   the peak device memory. Held: scripts/hierarchical_timing.py's gate, at
   least 190 of 200 images registered and, after a Sim3 alignment to the
   ground truth, every rotation within 1 deg and every centre within 0.05.
   A cluster that raises fails the phase.
9. dense: run_automatic_reconstruction(sparse=True, dense=True) on cuda,
   the launch counters of K1 and of the cost kernel zeroed just before and
   read just after (K1 runs in its sparse stage; the cost kernel once at
   init and once per half-iteration, 2 x 17 x maps launches, evaluating
   2 x 43 x H x W planes a map, or the phase fails); prints the sparse
   stages, the seconds of
   undistortion, both PatchMatch passes, fusion and meshing, PatchMatch
   seconds per map and Mpix/s per pass and the peak device memory. Held,
   in the render's frame after a Sim3 alignment of the model: all 12
   images registered within 1 deg / 0.05 x room size; every image has a
   geometric depth and normal map with >= 40% of its pixels estimated,
   whose back-projected points lie a median < 0.03 x room size from the
   room's three faces; fused.ply >= 10,000 points, >= 70% within 0.05 x
   room size of a face; meshed-poisson.ply > 500 vertices and faces with a
   median vertex distance < 0.08 x room size (tests/test_mvs.py:122-169).
10. [rig]: write the rig's model and COLMAP rig_config.json (prefixes
   cam{c}/), perturb every free rig pose by 0.5 deg and 3% of the snapshot
   spacing, the non-reference extrinsics by 0.5 deg and 2 cm and every
   point by 2 cm, then run_rig_bundle_adjustment on cuda (the launch
   counter zeroed just before and read just after: K1 is not on this
   path); prints the LM iterations, CG steps taken, host syncs, seconds
   and peak device memory. Held, after a Sim3 alignment of the image
   centres (the solver fixes 6 of the 7 gauge freedoms): final RMS
   reprojection <= 0.8 px, every recovered cam_from_rig within 0.05 deg and
   5 mm x the Sim3 scale, every image rotation within 0.1 deg. Then
   estimate_generalized_absolute_pose on 32 snapshots at once (20% of
   their observations replaced by outliers): every rig pose within 0.1 deg
   and 1% of the spacing; estimate_generalized_relative_pose on 8
   consecutive snapshot pairs at once (16,384 samples): every rotation
   within 0.5 deg;
11. [prior]: write position priors (coordinate_system 0: the true centre
   plus N(0, sigma^2 I), sigma = 1% of the spread of the true centres),
   then run_pose_prior_mapper on cuda (counter zeroed before, read after);
   prints the seconds, the prior BA's counters and the peak memory. Held
   against the ground truth with no Sim3 alignment (the priors put the
   model in that frame): >= 95 of 100 registered, every rotation within 1
   deg, every centre within 0.05 x the diameter of the true centres, the
   median |centre - prior| <= 2 sigma. Then, on that model, on the card:
   estimate_ba_covariance against estimate_pose_covariance_full_inverse
   on every sixth point (rtol 1e-2, the JAX test's bound; gauge: pose 0
   and x of pose 1), triangulate_points on the model with its points
   removed (>= 90% of them back at a mean reprojection <= 1 px) and
   register_images bringing 5 de-registered images back within 1 deg.
12. [cli] (runs inside phase 4's scratch directory, after phase 5, on its
   20 rendered images): colmap_tpu_torch.cli.main in this process with
   --device cuda: database_creator, feature_extractor (PINHOLE, one
   camera, the render's K, 8192 features), exhaustive_matcher (the launch
   counter zeroed just before and read just after: at least one launch
   per pair block), mapper, model_analyzer and model_converter to TXT;
   project_generator, then exhaustive_matcher --project_path on a copy of
   the database made before the first matcher run; feature_extractor with
   affine shapes and domain-size pooling at 768 px on two of the images,
   beside the default path on the same two, and the same command with
   --device cpu on one of them; one api.absolute_pose_estimation on the
   card. Prints each command's seconds, the launches and the peak device
   memory. Held: the CLI's model, read back from disk, passes phase 5's
   gates (20/20, 1 deg, 0.05 x room size); every image has >= 500
   features; >= 98% of the card's affine + DSP keypoints within 0.01 px
   of a CPU keypoint of the same orientation; the API pose within 0.1 deg
   and 0.01 x room size of the model's; `python -m colmap_tpu_torch
   model_analyzer` exits 0 in a subprocess, and another subprocess
   imports colmap_tpu_torch.cli and .api with neither jax nor colmap_tpu
   in sys.modules.
13. [multi] (after phase 11, on phase 4's database and phase 9's
   workspace): the direct sharded steps run on an explicit mesh of 4
   virtual shards of card 0 (`Mesh([cuda:0] * 4)`); the entry points take
   num_devices and run on the cards present, at most one shard per card
   (`make_mesh`, as JAX slices its device list), so on one card they take
   their one-device path. Prints torch.cuda.device_count(); each step
   prints its shards and distinct devices, its seconds and peak device
   memory, with the launch counters zeroed just before it:
   match_pair_blocks_sharded on phase 4's block (190 pairs padded to 192,
   N=M=1024), held to the one-shard run bit for bit and to phase 4's match
   rows, with >= 1 K1 launch on every shard thread; match_exhaustive with
   num_devices=4 on a copy of phase 4's database with its matches
   removed, held to phase 4's match rows and phase 5's pair-rotation gate,
   >= 1 launch per shard (per card); solve_distributed at the [ba] size
   (bench_ba.build_problem: 500 poses, 300k observations, 10 LM x 20 CG,
   tolerances 0) on the 4 virtual shards against the one-device solve,
   final cost within 1e-3 relative, LM it/s of both printed; the DSLR
   mapper with num_devices=4, held to phase 5's model gates, with at least
   one sharded global BA on several cards and none on one;
   run_patch_match_stereo with num_devices=2 at max_image_size 256 on
   phase 9's workspace, held to phase 9's depth gates (every map written,
   >= 40% estimated, median distance to the room < 0.03 x room size) and
   to one cost-kernel launch at init and per half-iteration (2 x 17 x
   maps) and 2 x 43 x H x W plane evaluations a map.
14. [scale]: colmap_tpu_torch.scripts.scale_run.main in this process on
   cuda, --mode incremental, at SCALE_IMAGES images with the script's
   widths (20 points per image, each seen by 40 consecutive cameras,
   chained matches of overlap 10, 0.5 px noise, seed 3; depth cut from
   1000), snapshots every 200 images; the launch counter zeroed just
   before and read just after (K1 is not on this path: it reads a match
   database). Prints the synthesis and mapping seconds, the report's
   stage_seconds (snapshots included), the BA counters and the peak
   device memory. Held: return code 0 and the script's own gates, >= 95%
   registered, rotation <= 1 deg, centre <= 0.05 after a Sim3 alignment.

The second-to-last line is the kernel report, one JSON object whose
"kernels" list holds the matcher's report and the cost kernel's (phase 3b;
its ms, plain_ms and bound_ms are the photometric pass's, `shapes` holds
both passes, `launches` is the dense cell's count (phase 9) and
`launches_by_path` holds it and phase 13's PatchMatch run's). In the
matcher's: its ms, plain_ms and bound_ms are those
of the DSLR block (B=190, N=M=1024) and `launches` the DSLR path's
count; `shapes` holds all three shapes and `launches_by_path` every
path's count (the dense cell's is its sparse stage's: fusion and meshing
are torch ops, and PatchMatch's cost kernel of phase 3b replaces no TPU
kernel; the rig and prior cells read no descriptors, so 0; the cli
path's is its first exhaustive_matcher run's; the multi path's sums its
sharded matching and its controller run, not the one-shard comparison;
the scale path reads a match database, so 0).
The last
line is {"ok": true,
"device": {...}}. Any failed check exits nonzero.
"""

import collections
import copy
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from colmap_tpu_torch import (  # noqa: E402
    api, bench_ba, bench_hierarchical, bench_patch_match, bench_rig, cli,
    cuda_build)
from colmap_tpu_torch.bench_matcher import (  # noqa: E402
    bound_ms, cuda_ms, int_mm_ms, random_blocks)
from colmap_tpu_torch.controllers import automatic_reconstruction as ar  # noqa: E402
from colmap_tpu_torch.controllers import dense_reconstruction as dense  # noqa: E402
from colmap_tpu_torch.controllers import feature_matching as fm  # noqa: E402
from colmap_tpu_torch.controllers.incremental_pipeline import (  # noqa: E402
    IncrementalPipeline, IncrementalPipelineOptions)
from colmap_tpu_torch.estimators import bundle_adjustment as ba  # noqa: E402
from colmap_tpu_torch.estimators import covariance  # noqa: E402
from colmap_tpu_torch.estimators import generalized_pose as gp  # noqa: E402
from colmap_tpu_torch.estimators.similarity_transform import (  # noqa: E402
    compare_reconstructions)
from colmap_tpu_torch.features import hopper_matcher as hm  # noqa: E402
from colmap_tpu_torch.features import matching as matching_mod  # noqa: E402
from colmap_tpu_torch.features import pairing  # noqa: E402
from colmap_tpu_torch.geometry import rigid3  # noqa: E402
from colmap_tpu_torch.geometry import rotation as rot  # noqa: E402
from colmap_tpu_torch.geometry import sim3  # noqa: E402
from colmap_tpu_torch.optim.ransac import RansacOptions  # noqa: E402
from colmap_tpu_torch.mvs import depth_map, fusion  # noqa: E402
from colmap_tpu_torch.mvs import hopper_patch_match as hpm  # noqa: E402
from colmap_tpu_torch.mvs import patch_match as pm  # noqa: E402
from colmap_tpu_torch.parallel import distributed_ba as pdba  # noqa: E402
from colmap_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from colmap_tpu_torch.parallel import sharded_matching as psm  # noqa: E402
from colmap_tpu_torch.geometry.essential import (  # noqa: E402
    pose_from_essential_matrix)
from colmap_tpu_torch.scene import reconstruction_io  # noqa: E402
from colmap_tpu_torch.scene import synthetic  # noqa: E402
from colmap_tpu_torch.scene import synthetic_images as synth  # noqa: E402
from colmap_tpu_torch.scene.database import Database  # noqa: E402
from colmap_tpu_torch.scene.reconstruction import (  # noqa: E402
    Camera, Image, Reconstruction)
from colmap_tpu_torch.sensor import models as cam_models  # noqa: E402
from colmap_tpu_torch.tools import rig_tools, sfm_tools  # noqa: E402


REPO = os.path.dirname(os.path.abspath(__file__))
VIDEO_FRAMES = 100  # the JAX package's run has 1000; cut to fit the limit
DENSE_IMAGES = 12


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(msg):
    print(msg, flush=True)


def main():
    t_start = time.perf_counter()
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
              "library_ms": None, "shapes": [], "launches_by_path": {}}
    max_err = 0.0
    for B, n, label in ((8, 8192, "ceiling"), (190, 1024, "dslr"),
                        (32, 2048, "video")):
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
        shape = {"path": label, "B": B, "N": n, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound, "share": bound / ms,
                 "int_mm_ms": int_mm_ms(b1, b2, 5)}
        report["shapes"].append(shape)
        phase(f"[kernel] {label} B={B} N=M={n}: indices equal, best/second/rev "
              f"bit-equal; kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({bound_by}), share of bound "
              f"{bound / ms:.4f}; int_mm {shape.get('int_mm_ms')} ms; "
              f"matched {float((m_k >= 0).float().mean())}")
        if label == "dslr":  # the DSLR main path's shape
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=bound_by)
        del b1, b2, k, r, m_k
    report["max_abs_err"] = max_err

    # ---- 3b. the PatchMatch cost kernel against its twin
    pm_report = patch_match_kernel()

    # phases 4 and 9 leave their database and workspace here for phase 13
    keep = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    dslr_dir = os.path.join(keep.name, "dslr")
    dense_dir = os.path.join(keep.name, "dense")
    os.makedirs(dslr_dir)
    os.makedirs(dense_dir)

    # ---- 4, 5. the DSLR main path, then 12. the command line on its images
    dslr = main_path(dslr_dir, report)

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

    # ---- 7. the VIDEO main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_video_") as work:
        video_path(work, report)

    # ---- 8. the hierarchical cell
    hierarchical_path(report)

    # ---- 9. the dense cell
    dense_cell = dense_path(dense_dir, report, pm_report)

    # ---- 10. rig BA and generalized pose
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rig_") as work:
        rig_path(work, report)

    # ---- 11. the pose-prior mapper and the SfM tools
    prior_path(report)

    # ---- 13. the multi-device slice on a mesh of shards
    multi_path(dslr, dense_cell, report, pm_report)
    keep.cleanup()

    # ---- 14. the scale run, as its script runs it
    scale_path(report)

    phase(f"[smoke] {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": [report, pm_report]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def patch_match_kernel() -> dict:
    """[pm-kernel]: build csrc/patch_match_cost.cu, then hold each kind of
    launch the solver makes (`pm._selector`: the initial planes on both
    colours; a propagation half-iteration's 6 candidates on one colour and
    a refinement half-iteration's 2 candidates on both colours, built in
    the launch from the held planes and two draws) to its twin
    `pm._keep_better_reference` on the torch-built candidates
    (`pm._candidates`) and copies of the same inputs, on the dense cell's
    shape (640x480, 8 sources, `bench_patch_match.plane_problem`: texture
    in every window, the sources' true depth maps as the geometric pass's
    input; held planes near the truth, a third random; held costs the held
    planes' own, every 97th NaN), in both passes; one launch a call, its
    built planes counted. Costs within 1e-4 on 99.9% of the launch's
    pixels, 1e-3 on all, NaN at the same pixels; every pixel holds its
    held plane or a torch-built candidate, bit for bit; pixels outside the
    launch or with a NaN held cost keep their plane and cost; and the kept
    candidate is the twin's wherever the twin's costs of the two choices
    lie more than 2e-3 apart (two costs each within 1e-3 of the twin's can
    swap their order only closer than that). Prints each check, the twin's
    time, the build seconds and, from `bench_patch_match.launch_times`,
    each kind's time and bound; the report's headline (ms, bound_ms,
    plain_ms) is the photometric propagation launch's."""
    t0 = time.perf_counter()
    hpm.build()
    build_s = cuda_build.build_seconds["patch_match_cost"]
    phase(f"[pm-kernel] patch_match_cost built in {build_s:.3f} s "
          f"({time.perf_counter() - t0:.3f} s with loading)")
    n_src, (w, h) = 8, (640, 480)
    problem, gt = bench_patch_match.plane_problem(h, w, n_src, seed=1,
                                                  geom=True)
    held_d, held_n = bench_patch_match.plane_candidates(problem, gt, seed=2)
    gen = torch.Generator(device=gt.device).manual_seed(3)
    draws = [pm.GeneratorDraws(gen, (h, w)).perturbation() for _ in range(2)]
    report = {"name": "patch_match_cost", "route": "cuda",
              "source": "colmap_tpu_torch/csrc/patch_match_cost.cu",
              "replaces": None, "library_ms": None, "build_s": build_s,
              "shapes": [], "launches_by_path": {},
              "evaluations_by_path": {}, "built_by_path": {}}
    for geom in (False, True):
        opts = pm.PatchMatchOptions(geom_consistency=geom)
        pre = pm._precompute(problem, opts)
        select = pm._selector(problem, pre, opts)
        tables = pm._twin_tables(problem, pre, opts,
                                 pm._colours(h, w, gt.device))
        held_c = torch.empty((h, w), device=gt.device)
        select.costs(None, held_d, held_n, held_c)
        held_c.view(-1)[::97] = float("nan")
        for kind, colour, scales in (("init", None, []),
                                     ("propagation", 1, [0.5, 0.25]),
                                     ("refinement", None, [0.02, 0.01])):
            report["shapes"].append(pm_launch_against_twin(
                problem, pre, opts, kind, select, colour, tables,
                draws[:len(scales)], scales, held_d, held_n, held_c))
    report["launch_kinds"] = bench_patch_match.launch_times()
    for k in report["launch_kinds"]:
        phase(f"[pm-kernel] {'geometric' if k['geometric'] else 'photometric'}"
              f" {k['kind']} launch, {k['candidates']} candidates on "
              f"{k['pixels']} pixels: {k['ms']:.4f} ms, "
              f"{k['ns_per_evaluation']:.4f} ns a plane evaluation, bound "
              f"{k['bound_ms']:.4f} ms, share of bound {k['share']:.4f}")
    head = next(k for k in report["launch_kinds"]
                if k["kind"] == "propagation" and not k["geometric"])
    twin = next(k for k in report["shapes"]
                if k["kind"] == "propagation" and k["pass"] == "photometric")
    report.update(ms=head["ms"], plain_ms=twin["plain_ms"],
                  bound_ms=head["bound_ms"], bound_by="operations")
    return report


def pm_launch_against_twin(problem, pre, opts, kind, select, colour,
                           tables, draws, scales, held_d, held_n, held_c):
    """One launch of `kind` through the solver's `select` on checkerboard
    colour `colour` (None: both) against `pm._keep_better_reference` on
    the twin's tables `tables` (both colours), the torch-built
    candidates from the held planes and `draws` at `scales`, and copies of
    the same inputs (the initial planes: the held planes as the one
    candidate and no held plane); fails on any check of
    `patch_match_kernel`, else returns the readings."""
    geom = opts.geom_consistency
    label = f"{'geometric' if geom else 'photometric'} {kind}"
    h, w = held_d.shape
    init = kind == "init"
    propagate = kind == "propagation"
    if init:
        cand_d, cand_n = held_d[None], held_n[None]
    else:
        cand_d, cand_n = pm._candidates(problem, pre.rays, held_d, held_n,
                                        draws, scales, propagate)

    def fresh():
        if init:
            return (torch.full((h, w), -1.0, device=held_d.device),)
        return held_c.clone(), held_d.clone(), held_n.clone()

    sets = tables if colour is None else tables[colour:colour + 1]

    def reference(state):
        pm._keep_better_reference(problem, pre, opts, sets, cand_d, cand_n,
                                  *state)

    got, ref = fresh(), fresh()
    before, evals, built = hpm.launches, hpm.evaluations, hpm.built
    if init:
        select.costs(colour, held_d, held_n, *got)
    else:
        select.keep_better(colour, propagate, draws, scales, *got)
    pixels = sum(int(S.idx.numel()) for S in sets)
    want = pixels * cand_d.shape[0]
    if (hpm.launches - before, hpm.evaluations - evals,
            hpm.built - built) != (1, want, 0 if init else want):
        fail(f"{label}: {hpm.launches - before} launches, "
             f"{hpm.evaluations - evals} evaluations and "
             f"{hpm.built - built} planes built for one launch of {want}")
    reference(ref)
    scratch = fresh()
    twin_ms = cuda_ms(lambda: reference(scratch), 3)
    inside = torch.zeros(h * w, dtype=torch.bool, device=held_d.device)
    for S in sets:
        inside[S.idx] = True
    inside = inside.view(h, w)
    c_got, c_ref = got[0], ref[0]
    if not torch.equal(c_got.isnan(), c_ref.isnan()):
        fail(f"{label}: the kernel's and the twin's costs are NaN at "
             f"different pixels")
    err = (c_got - c_ref).abs()[inside & ~c_got.isnan()]
    within = float((err <= 1e-4).float().mean())
    max_err = float(err.max())
    if within < 0.999 or max_err > 1e-3:
        fail(f"{label}: costs {within:.6f} within 1e-4 of the twin, max "
             f"{max_err:.3e}")
    if init:
        if not bool((c_got[~inside] == -1).all()):
            fail(f"{label}: costs written outside the launch's pixels")
        changed = swaps = 0.0
    else:
        keep = ~inside | held_c.isnan()
        # the twin's cost of each choice at each pixel, the held plane's
        # first
        choice_cost = held_c.expand(cand_d.shape[0] + 1, h, w).clone()
        for j in range(cand_d.shape[0]):
            for S in sets:
                choice_cost[j + 1].view(-1)[S.idx] = pm._set_cost_reference(
                    problem, pre, opts, S, cand_d[j].view(-1)[S.idx],
                    cand_n[j].view(-1, 3)[S.idx])
        k_got = kept_choice(got, held_d, held_n, cand_d, cand_n)
        k_ref = kept_choice(ref, held_d, held_n, cand_d, cand_n)
        if bool((k_got == -2).any()) or bool((k_ref == -2).any()):
            fail(f"{label}: a pixel holds neither its plane nor a "
                 f"candidate")
        same_cost = c_got.nan_to_num() == held_c.nan_to_num()
        if not bool(((k_got == -1) & same_cost)[keep].all()):
            fail(f"{label}: the kernel changed a pixel outside the launch "
                 f"or with a NaN held cost")
        gap = (choice_cost.gather(0, k_got[None] + 1)
               - choice_cost.gather(0, k_ref[None] + 1))[0].abs()
        wrong = (k_got != k_ref) & ~(gap <= 2e-3)
        if bool(wrong.any()):
            fail(f"{label}: the kernel kept another candidate than the twin "
                 f"at {int(wrong.sum())} pixels whose costs do not tie")
        swaps = float((k_got != k_ref)[inside].float().mean())
        changed = float((k_got != -1)[inside].float().mean())
    phase(f"[pm-kernel] {label} launch, {cand_d.shape[0]} candidates "
          f"({'given' if init else 'built in the launch'}) on "
          f"{pixels} pixels, {problem.src_images.shape[0]} sources: costs "
          f"{within:.6f} within 1e-4 of the twin, max {max_err:.3e}; plane "
          f"changed at {changed:.4f} of them, another candidate than the "
          f"twin's (a tie) at {swaps:.6f}; twin {twin_ms:.4f} ms")
    return {"pass": "geometric" if geom else "photometric", "kind": kind,
            "width": w, "height": h, "pixels": pixels,
            "candidates": cand_d.shape[0], "built": 0 if init else want,
            "sources": problem.src_images.shape[0], "plain_ms": twin_ms,
            "within_1e4": within, "max_abs_err": max_err,
            "changed": changed, "tie_swaps": swaps}


def kept_choice(state, held_d, held_n, cand_d, cand_n):
    """Per pixel, which plane `state` (cost, depth, normal) holds: -1 the
    held plane, j candidate j (the first equal), -2 none of them."""
    _, d, n = state
    k = torch.full(d.shape, -2, dtype=torch.long, device=d.device)
    for j in reversed(range(cand_d.shape[0])):
        k[(d == cand_d[j]) & (n == cand_n[j]).all(-1)] = j
    k[(d == held_d) & (n == held_n).all(-1)] = -1
    return k


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
    rec, db, stages, launches = drive("main", opts)
    report["launches"] = launches
    report["launches_by_path"]["dslr"] = launches
    ids = {im["name"]: iid for iid, im in db.read_images().items()}
    counts = [db.num_keypoints(ids[nm]) for nm in names]
    geoms = db.read_all_two_view_geometries()
    phase(f"[main] features per image: {counts}")
    phase(f"[main] matched pairs {db.num_matched_pairs()}, verified pairs "
          f"{len(geoms)} of {len(names) * (len(names) - 1) // 2}")
    n_blocks = sum(1 for _ in pairing.exhaustive_pairs(sorted(ids.values())))
    phase(f"[main] matcher kernel launches {launches} for {n_blocks} pair "
          f"block(s)")
    if launches < n_blocks:
        fail("the main path did not launch the matcher kernel for every "
             "pair block")
    # the JAX package extracts 833 features from the first of these images
    # (CPU run); the port's CPU and GPU runs give the same count
    if min(counts) < 500:
        fail(f"too few features: {counts}")
    check_keypoints(db, ids, names, 1536, 1152)

    # ---- 5. outcome against ground truth
    errors = pair_rotation_errors(db, ids, names, Rs)
    strong = set()
    for (a, b), (err, n_inl, config) in errors.items():
        if n_inl >= 100:
            strong.update((a, b))
        if err > 1.0:
            fail(f"pair ({a}, {b}): rotation {err:.4f} deg from ground truth "
                 f"({n_inl} inliers, config {config})")
    phase(f"[outcome] {len(geoms)} verified pairs, max rotation error "
          f"{max(e for e, _, _ in errors.values()):.6f} deg; images in a "
          f"pair with >= 100 inliers: {len(strong)}/{len(names)}")
    if len(strong) != len(names):
        fail("an image has no verified pair with >= 100 inliers")

    # the model against ground truth
    gt = gt_model(ids, names, K, Rs, ts, 1536, 1152)
    limit = 0.05 * ropts.room_size
    check_model("model", rec, gt, len(names), len(names), limit)
    check_read_back(rec, opts.workspace_path)

    # the mapper again on the same database, warm (the run above paid the
    # CUDA libraries' first loads)
    pipe = IncrementalPipeline(db, device="cuda")
    t0 = time.perf_counter()
    warm = pipe.run()
    torch.cuda.synchronize()
    phase(f"[main] warm mapping {time.perf_counter() - t0:.3f} s; stages s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
              pipe.stage_s.items(), key=lambda kv: -kv[1])))
    check_model("warm model", warm, gt, len(names), len(names), limit)
    db.close()

    # ---- 12. the command line and the Python API on the same images
    cli_path(work, report, names, K, Rs, ts, ropts)
    return dict(db_path=os.path.join(opts.workspace_path, "database.db"),
                names=names, ids=ids, Rs=Rs, gt=gt, limit=limit)


def _cli(args):
    """One command through colmap_tpu_torch.cli.main in this process (so
    the matcher's launch counter is readable); returns its seconds."""
    t0 = time.perf_counter()
    rc = cli.main(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rc != 0:
        fail(f"[cli] {args[0]} exited {rc}")
    phase(f"[cli] {args[0]} {secs:.3f} s")
    return secs


def _close_keypoints(a, b):
    """Share of the keypoints of `a` within 0.01 px of a keypoint of `b`
    with the same orientation (1e-2 rad), and the share of those matched
    keypoints' descriptor bytes within one level of `b`'s."""
    d2 = ((a["xy"][:, None] - b["xy"][None]) ** 2).sum(-1)
    dori = np.abs(np.angle(np.exp(1j * (a["ori"][:, None]
                                         - b["ori"][None]))))
    d2 = np.where(dori < 1e-2, d2, np.inf)
    nn = d2.argmin(1)
    close = np.sqrt(d2[np.arange(len(nn)), nn]) <= 0.01
    da = a["desc"][close].astype(int)
    db = b["desc"][nn[close]].astype(int)
    return float(close.mean()), float((np.abs(da - db) <= 1).mean())


def _db_features(path):
    from colmap_tpu_torch.features.sift import affine_to_keypoints

    db = Database(path)
    out = {}
    for iid, im in db.read_images().items():
        xy, _, ori = affine_to_keypoints(db.read_keypoints(iid))
        out[im["name"]] = {"xy": xy, "ori": ori,
                           "desc": db.read_descriptors(iid)}
    db.close()
    return out


def cli_path(work, report, names, K, Rs, ts, ropts):
    """Phase 12: the DSLR cell's 20 images through the command line on the
    card (database_creator, feature_extractor, exhaustive_matcher, mapper,
    model_analyzer, model_converter, project_generator and a matcher run
    from the project file), the SIFT variants through the command line,
    and one absolute pose through the Python API."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    image_dir = os.path.join(work, "images")
    db_path = os.path.join(work, "cli.db")
    dev = ["--device", "cuda"]
    params = ",".join(map(str, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))
    reader = ["--ImageReader.camera_model", "PINHOLE",
              "--ImageReader.single_camera", "1",
              "--ImageReader.camera_params", params]
    _cli(["database_creator", "--database_path", db_path] + dev)
    t_extract = _cli(["feature_extractor", "--database_path", db_path,
                      "--image_path", image_dir,
                      "--SiftExtraction.max_num_features", "8192"]
                     + reader + dev)
    copy_path = os.path.join(work, "cli_copy.db")
    shutil.copy(db_path, copy_path)
    hm.launches = 0
    _cli(["exhaustive_matcher", "--database_path", db_path] + dev)
    launches = hm.launches
    report["launches_by_path"]["cli"] = launches
    db = Database(db_path)
    ids = {im["name"]: iid for iid, im in db.read_images().items()}
    counts = [db.num_keypoints(ids[nm]) for nm in names]
    n_blocks = sum(1 for _ in pairing.exhaustive_pairs(sorted(ids.values())))
    phase(f"[cli] features per image: {counts}; verified pairs "
          f"{db.num_verified_pairs()}; matcher kernel launches {launches} "
          f"for {n_blocks} pair block(s)")
    db.close()
    if min(counts) < 500:
        fail(f"[cli] too few features: {counts}")
    if launches < n_blocks:
        fail("[cli] exhaustive_matcher did not launch the matcher kernel "
             "for every pair block")
    sparse = os.path.join(work, "cli_sparse")
    _cli(["mapper", "--database_path", db_path, "--output_path", sparse]
         + dev)
    model_dir = os.path.join(sparse, "0")
    _cli(["model_analyzer", "--path", model_dir] + dev)
    _cli(["model_converter", "--input_path", model_dir, "--output_path",
          os.path.join(work, "cli_txt"), "--output_type", "TXT"] + dev)
    rec = reconstruction_io.read_model(model_dir)
    txt = reconstruction_io.read_model(os.path.join(work, "cli_txt"))
    if txt.num_registered_images() != rec.num_registered_images():
        fail("[cli] the TXT model differs from the binary one")
    gt = gt_model(ids, names, K, Rs, ts, 1536, 1152)
    limit = 0.05 * ropts.room_size
    check_model("cli model", rec, gt, len(names), len(names), limit)

    # the project file written and read back for a second matcher run
    ini = os.path.join(work, "project.ini")
    _cli(["project_generator", "--output_path", ini, "--database_path",
          copy_path, "--image_path", image_dir,
          "--SiftMatching.max_ratio", "0.8"] + reader + dev)
    hm.launches = 0
    _cli(["exhaustive_matcher", "--project_path", ini] + dev)
    ini_launches = hm.launches
    db = Database(copy_path)
    n_ver = db.num_verified_pairs()
    db.close()
    phase(f"[cli] exhaustive_matcher from project.ini: {ini_launches} "
          f"kernel launches, {n_ver} verified pairs")
    if ini_launches < n_blocks or n_ver == 0:
        fail("[cli] the matcher run from the project file did not match")

    # the SIFT variants through the command line on two images at 768 px:
    # the default path, affine shape + DSP on the card, and on the CPU
    var_dir = os.path.join(work, "variant_images")
    os.makedirs(var_dir)
    for nm in names[:2]:
        shutil.copy(os.path.join(image_dir, nm), var_dir)
    one_dir = os.path.join(work, "variant_one")
    os.makedirs(one_dir)
    shutil.copy(os.path.join(image_dir, names[0]), one_dir)
    variant = ["--SiftExtraction.estimate_affine_shape", "1",
               "--SiftExtraction.domain_size_pooling", "1"]
    runs = {}
    for tag, images, extra in (("default", var_dir, dev),
                               ("affine_dsp", var_dir, variant + dev),
                               ("affine_dsp_cpu", one_dir,
                                variant + ["--device", "cpu"])):
        path = os.path.join(work, f"{tag}.db")
        secs = _cli(["feature_extractor", "--database_path", path,
                     "--image_path", images,
                     "--SiftExtraction.max_image_size", "768"]
                    + reader + extra)
        runs[tag] = (secs, _db_features(path))
    for tag, (secs, feats) in runs.items():
        phase(f"[cli] {tag} extraction at 768 px: {secs:.3f} s for "
              f"{len(feats)} images, features "
              f"{[len(f['xy']) for f in feats.values()]}")
    phase(f"[cli] default path at full size: {t_extract:.3f} s for "
          f"{len(names)} images")
    share, desc_share = _close_keypoints(runs["affine_dsp"][1][names[0]],
                                         runs["affine_dsp_cpu"][1][names[0]])
    phase(f"[cli] affine + DSP, card against CPU on {names[0]}: keypoints "
          f"{share:.4f} within 0.01 px at the same orientation, their "
          f"descriptor bytes {desc_share:.4f} within one level")
    if share < 0.98:
        fail("[cli] affine + DSP keypoints differ between card and CPU")
    if desc_share < 0.995:
        fail("[cli] affine + DSP descriptors differ between card and CPU")

    # one absolute pose through the Python API, against the CLI's model
    iid = max(rec.registered_image_ids(),
              key=lambda i: int((rec.images[i].point3D_ids >= 0).sum()))
    im = rec.images[iid]
    obs = np.nonzero(im.point3D_ids >= 0)[0]
    xyz = np.stack([rec.points3D[int(im.point3D_ids[k])].xyz for k in obs])
    t0 = time.perf_counter()
    res = api.absolute_pose_estimation(im.xys[obs], xyz,
                                       rec.cameras[im.camera_id],
                                       device="cuda")
    secs = time.perf_counter() - t0
    ang = float(rot.quat_angle_deg(
        torch.as_tensor(res["cam_from_world"][:4]),
        torch.as_tensor(im.cam_from_world[:4])))
    c_est = rigid3.projection_center(torch.as_tensor(res["cam_from_world"]))
    c_dist = float(torch.linalg.norm(
        c_est - torch.as_tensor(im.projection_center())))
    phase(f"[cli] api.absolute_pose_estimation of image {iid}: "
          f"{res['num_inliers']}/{len(obs)} inliers in {secs:.3f} s, "
          f"{ang:.6f} deg and {c_dist:.6f} from the model's pose")
    if not res["success"] or ang > 0.1 or c_dist > 0.01 * ropts.room_size:
        fail("[cli] the API pose is not the model's")

    # the module entry point and the isolation of cli / api, in subprocesses
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-m", "colmap_tpu_torch",
                          "model_analyzer", "--path", model_dir],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env=env)
    if res.returncode != 0 or "num_registered_images" not in res.stdout:
        fail(f"[cli] python -m colmap_tpu_torch model_analyzer exited "
             f"{res.returncode}: {res.stderr[-1000:]}")
    res = subprocess.run([sys.executable, "-c", (
        "import sys; import colmap_tpu_torch.cli, colmap_tpu_torch.api; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'colmap_tpu.')) or m == 'colmap_tpu']; "
        "assert not bad, bad; print('isolated')")],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    if res.returncode != 0 or "isolated" not in res.stdout:
        fail(f"[cli] cli / api import jax or colmap_tpu: {res.stderr[-1000:]}")
    peak = torch.cuda.max_memory_allocated()
    phase(f"[cli] python -m colmap_tpu_torch and the isolated import exit 0; "
          f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB); "
          f"phase {time.perf_counter() - t_phase:.3f} s")


def video_path(work, report):
    """Phase 7 in the scratch directory `work`: the VIDEO cell,
    scripts/full_scale_run.py's per-frame settings at VIDEO_FRAMES."""
    n = VIDEO_FRAMES
    t0 = time.perf_counter()
    oopts = synth.OrbitDatasetOptions(num_images=n, width=640, height=480,
                                      focal=0.875 * 640, seed=3,
                                      orbit_turns=1.0)
    images, K, Rs, ts = synth.render_orbit_dataset(oopts)
    names = synth.write_dataset(os.path.join(work, "images"), images)
    phase(f"[render] {n} x 640x480 orbit in {time.perf_counter() - t0:.3f} s")
    opts = ar.AutomaticReconstructionOptions(
        workspace_path=os.path.join(work, "ws"),
        image_path=os.path.join(work, "images"), data_type=ar.DataType.VIDEO,
        quality=ar.Quality.LOW, camera_model="PINHOLE", single_camera=True,
        sparse=True, video_overlap=10,
        camera_params=",".join(map(str, [K[0, 0], K[1, 1], K[0, 2],
                                         K[1, 2]])))
    rec, db, stages, launches = drive("video", opts)
    report["launches_by_path"]["video"] = launches
    ids = {im["name"]: iid for iid, im in db.read_images().items()}
    order = [ids[nm] for nm in names]
    stats = stages["matching_stats"]
    window = pairing.sequential_pairs(order, pairing.SequentialPairingOptions(
        overlap=10, quadratic_overlap=False))
    full = pairing.sequential_pairs(order, pairing.SequentialPairingOptions(
        overlap=10))
    counts = [db.num_keypoints(i) for i in order]
    geoms = db.read_all_two_view_geometries()
    phase(f"[video] features per frame: min {min(counts)}, max {max(counts)}")
    phase(f"[video] proposed pairs {stats['num_pairs']}: window "
          f"{len(window)}, quadratic {len(full) - len(window)}, loop "
          f"detection {stats['num_pairs'] - len(full)}; matched "
          f"{stats['num_matched_pairs']}, verified {len(geoms)}")
    phase(f"[video] matcher kernel launches {launches} for "
          f"{stats['num_blocks']} pair blocks; descriptor pool builds "
          f"{stats['pool_builds']}")
    if launches < stats["num_blocks"]:
        fail("the VIDEO path did not launch the matcher kernel for every "
             "pair block")
    check_keypoints(db, ids, names, 640, 480)
    gt = gt_model(ids, names, K, Rs, ts, 640, 480)
    check_model("video model", rec, gt, n, int(np.ceil(0.95 * n)), 0.05)
    check_read_back(rec, opts.workspace_path)

    index = {iid: i for i, iid in enumerate(order)}
    loops = [(a, b) for a, b in geoms if min(index[a], index[b]) < 10
             and max(index[a], index[b]) >= n - 10]
    phase(f"[video] verified pairs joining the first and last 10 frames: "
          f"{len(loops)}")
    if not loops:
        fail("the loop is not closed: no verified pair joins the first and "
             "last 10 frames")
    # the pairs' rotations, as the DSLR phase reads them; on this scene of
    # planes E is ambiguous for many pairs (PERF.md), so they are printed
    errors = pair_rotation_errors(db, ids, names, Rs)
    configs = collections.Counter(c for _, _, c in errors.values())
    above = collections.Counter(c for e, _, c in errors.values() if e > 1.0)
    phase(f"[video] {len(errors)} verified pairs, max rotation error "
          f"{max(e for e, _, _ in errors.values()):.6f} deg, "
          f"{sum(above.values())} above 1 deg (by config: "
          f"{dict(sorted(above.items()))} of {dict(sorted(configs.items()))})")
    # what verification promises: its inliers are true correspondences
    on = true_inliers(db, ids, names, K, Rs, ts)
    total = sum(cnt for _, cnt in on.values())
    share = sum(o for o, _ in on.values()) / total
    strong = [o / cnt for o, cnt in on.values() if cnt >= 100]
    phase(f"[video] inlier matches within 4 px of the true epipolar "
          f"geometry: {share:.6f} of {total}; "
          f"pairs with >= 100 inliers: {len(strong)}, lowest share "
          f"{min(strong):.4f}")
    if share < 0.95:
        fail(f"only {share:.4f} of the verified inlier matches lie on the "
             "true epipolar geometry")
    db.close()


def hierarchical_path(report):
    """Phase 8: the hierarchical gate on the card."""
    t0 = time.perf_counter()
    db, gt = bench_hierarchical.build_db(200, seed=3)
    phase(f"[hier] synthesized {db.num_images()} images, "
          f"{db.num_verified_pairs()} verified pairs in "
          f"{time.perf_counter() - t0:.3f} s")
    hm.launches = 0
    run, rec = bench_hierarchical.run_once(db, gt, num_workers=1,
                                           leaf_max_images=60, device="cuda")
    report["launches_by_path"]["hierarchical"] = hm.launches
    tm = run["timings"]
    phase(f"[hier] leaves {run['leaves']}; clustering "
          f"{tm['clustering']:.3f} s, caches {tm['caches']:.3f} s")
    for k, c in enumerate(run["clusters"]):
        phase(f"[hier] cluster {k}: {c['registered']}/{c['images']} "
              f"registered in {c['seconds']:.3f} s")
    phase(f"[hier] mapping (1 worker) {tm['mapping']:.3f} s; merge: "
          f"alignment {tm['align']:.3f} s, pose graph "
          f"{tm['pose_graph']:.3f} s, fusion {tm['fuse']:.3f} s; wall "
          f"{run['wall_s']:.3f} s")
    phase("[hier] mapper stages s, summed over clusters: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(run["stage_s"].items(),
                                          key=lambda kv: -kv[1])))
    ba = run["ba_stats"]
    phase(f"[hier] BA, summed over clusters: {int(ba['gba_calls'])} global "
          f"({int(ba['gba_lm_iters'])} LM iterations, "
          f"{int(ba['gba_cg_steps'])} CG steps, {int(ba['gba_syncs'])} host "
          f"syncs), {int(ba['lba_calls'])} local ({int(ba['lba_lm_iters'])} "
          f"LM iterations, {int(ba['lba_cg_steps'])} CG steps, "
          f"{int(ba['lba_syncs'])} host syncs)")
    peak = run["peak_bytes"]
    phase(f"[hier] peak device memory {peak} bytes ({peak / 2**30:.3f} GiB); "
          f"matcher kernel launches {hm.launches} (not on this path)")
    check_model("hierarchical model", rec, gt, 200, 190, 0.05)
    db.close()


def pm_calls_per_solve(opts: pm.PatchMatchOptions) -> int:
    """Cost-kernel launches in one checkerboard solve at `opts`: the
    initial costs, one a propagation half-iteration (its 4 +
    num_perturbations candidates on its colour) and one a refinement
    half-iteration (2 candidates on both colours): 17 at the defaults."""
    return 1 + 2 * opts.num_iterations + 2 * opts.num_refinement_iterations


def check_pm_launches(tag, launches, evaluations, built, maps, dense_dir,
                      pm_report):
    """The cost kernel launched once at init and once per half-iteration
    of both passes' `maps` solves each (the stereo defaults' options), and
    evaluated `bench_patch_match.cost_evaluations` (43) x H x W planes a
    solve, all but the initial H x W built in the kernel (42 x H x W; a
    job of 24 solves at 640x480: 309,657,600), H x W read from the depth
    maps in `dense_dir` (the geometric pass writes them at the size both
    passes solved); recorded as the path's counts in the kernel's
    report."""
    opts = dense.PatchMatchStereoOptions().patch_match
    want = 2 * maps * pm_calls_per_solve(opts)
    pixels = [depth_map.DepthMap.read(os.path.join(
        dense_dir, "stereo", "depth_maps", f)).data.size
        for f in sorted(os.listdir(os.path.join(dense_dir, "stereo",
                                                "depth_maps")))
        if f.endswith(".geometric.bin")]
    if len(pixels) != maps:
        fail(f"{tag}: {len(pixels)} depth maps for {maps} maps")
    want_evals = 2 * bench_patch_match.cost_evaluations(opts) * sum(pixels)
    want_built = want_evals - 2 * sum(pixels)
    pm_report["launches_by_path"][tag] = launches
    pm_report["evaluations_by_path"][tag] = evaluations
    pm_report["built_by_path"][tag] = built
    phase(f"[{tag}] PatchMatch cost kernel launches {launches} for 2 x "
          f"{maps} solves ({want} wanted), plane evaluations {evaluations} "
          f"({want_evals} wanted), planes built in the kernel {built} "
          f"({want_built} wanted)")
    if launches != want:
        fail(f"{tag}: the cost kernel launched {launches} times for {want} "
             f"half-iterations and initial costs")
    if evaluations != want_evals:
        fail(f"{tag}: the cost kernel evaluated {evaluations} planes for "
             f"{want_evals}")
    if built != want_built:
        fail(f"{tag}: the cost kernel built {built} planes for "
             f"{want_built}")


def dense_path(work, report, pm_report):
    """Phase 9 in the scratch directory `work`: the dense cell, pixels to
    a fused cloud and a Poisson mesh, with the cost kernel's launch
    counter zeroed just before and read just after."""
    t0 = time.perf_counter()
    ropts = synth.RoomDatasetOptions(num_images=DENSE_IMAGES, width=640,
                                     height=480, focal=560.0, seed=11)
    images, K, Rs, ts = synth.render_room_dataset(ropts)
    names = synth.write_dataset(os.path.join(work, "images"), images)
    phase(f"[render] {DENSE_IMAGES} x 640x480 room in "
          f"{time.perf_counter() - t0:.3f} s")
    opts = ar.AutomaticReconstructionOptions(
        workspace_path=os.path.join(work, "ws"),
        image_path=os.path.join(work, "images"), quality=ar.Quality.HIGH,
        camera_model="SIMPLE_RADIAL", single_camera=True, sparse=True,
        dense=True,
        camera_params=",".join(map(str, [K[0, 0], K[0, 2], K[1, 2], 0.0])))
    hpm.launches = hpm.evaluations = hpm.built = 0
    rec, db, st, launches = drive("dense", opts)
    pm_launches, pm_evaluations = hpm.launches, hpm.evaluations
    pm_built = hpm.built
    report["launches_by_path"]["dense"] = launches
    n_maps = st["patch_match_maps"]
    dense_dir = os.path.join(opts.workspace_path, "dense")
    check_pm_launches("dense", pm_launches, pm_evaluations, pm_built,
                      n_maps, dense_dir, pm_report)
    pm_report["launches"] = pm_launches
    pm_report["evaluations"] = pm_evaluations
    pm_report["built"] = pm_built
    ids = {im["name"]: iid for iid, im in db.read_images().items()}
    ucam = next(iter(reconstruction_io.read_model(
        os.path.join(dense_dir, "sparse")).cameras.values()))
    mpix = ucam.width * ucam.height / 1e6
    phase(f"[dense] stages s: undistortion {st['undistortion']:.3f}, "
          f"patch_match_photometric {st['patch_match_photometric']:.3f}, "
          f"patch_match_geometric {st['patch_match_geometric']:.3f}, "
          f"fusion {st['fusion']:.3f}, meshing {st['meshing']:.3f}")
    for kind in ("photometric", "geometric"):
        sec = st[f"patch_match_{kind}"]
        phase(f"[dense] PatchMatch {kind}: {n_maps} maps of "
              f"{ucam.width}x{ucam.height}, {sec / n_maps:.4f} s per map, "
              f"{n_maps * mpix / sec:.4f} Mpix/s")
    phase(f"[dense] matcher kernel launches {launches} (the sparse stage)")
    if launches < 1:
        fail("the dense cell's sparse stage did not launch the matcher "
             "kernel")

    gt = gt_model(ids, names, K, Rs, ts, 640, 480)
    check_model("dense cell's sparse model", rec, gt, len(names), len(names),
                0.05 * ropts.room_size)
    check_dense(rec, gt, dense_dir, ropts.room_size)
    db.close()
    return dict(rec=rec, gt=gt, dense_dir=dense_dir,
                room_size=ropts.room_size)


# phase 13: the virtual shards of card 0 in the direct steps, and the
# entry points' num_devices
MULTI_SHARDS = 4
MULTI_PATCH_MATCH_SIZE = 256  # phase 13's PatchMatch max_image_size


def _step(tag, t0):
    """Print a phase 13 step's seconds and peak device memory."""
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    phase(f"[multi] {tag}: {time.perf_counter() - t0:.3f} s, peak device "
          f"memory {peak} bytes ({peak / 2**30:.3f} GiB)")


def _zero_counts():
    hm.launches = 0
    hm.launches_by_thread.clear()
    torch.cuda.reset_peak_memory_stats()


def _shard_launches(mesh, what):
    """The K1 launches of each shard thread since `_zero_counts` (of the
    calling thread where the mesh is one card: the callers' one-device
    path); fails unless every shard launched."""
    per = ([hm.launches] if mesh.size == 1 else
           [hm.launches_by_thread.get(f"shard-{k}", 0)
            for k in range(mesh.size)])
    phase(f"[multi] {what}: matcher kernel launches per shard {per}")
    if min(per) < 1:
        fail(f"{what}: a shard did not launch the matcher kernel")
    return sum(per)


def _mesh_line(mesh):
    return (f"{mesh.size} shard(s) on {mesh.num_distinct} distinct "
            f"device(s) {sorted({str(d) for d in mesh.devices})}")


def multi_path(dslr, dense_cell, report, pm_report):
    """Phase 13: the multi-device slice. The direct sharded steps (sharded
    matching of phase 4's block, the pose-sharded BA at the [ba] size) run
    on an explicit mesh of MULTI_SHARDS virtual shards of card 0; the entry
    points (the matching controller, the DSLR mapper, round-robin
    PatchMatch) take `num_devices` and run on the cards present, at most
    one shard per card (one card: their one-device path)."""
    t_phase = time.perf_counter()
    mesh = pmesh.Mesh([torch.device("cuda", 0)] * MULTI_SHARDS)
    cards = pmesh.make_mesh(MULTI_SHARDS, "cuda")
    phase(f"[multi] torch.cuda.device_count() {torch.cuda.device_count()}; "
          f"direct steps: explicit mesh of {_mesh_line(mesh)}, virtual "
          f"{mesh.virtual}; entry points with num_devices={MULTI_SHARDS}: "
          f"{_mesh_line(cards)}")
    launches = 0

    # sharded matching of phase 4's block, padded to a multiple of the mesh
    db = Database(dslr["db_path"])
    img_ids = sorted(db.read_images())
    block = next(iter(pairing.exhaustive_pairs(img_ids)))
    desc = {i: db.read_descriptors(i) for i in img_ids}
    cap = 1 << max(8, int(max(len(d) for d in desc.values()) - 1)
                   .bit_length())
    B = -(-len(block) // mesh.size) * mesh.size
    d1 = np.zeros((B, cap, 128), np.uint8)
    d2 = np.zeros_like(d1)
    v1 = np.zeros((B, cap), bool)
    v2 = np.zeros_like(v1)
    for k, (a, b) in enumerate(block):
        d1[k, :len(desc[a])], v1[k, :len(desc[a])] = desc[a], True
        d2[k, :len(desc[b])], v2[k, :len(desc[b])] = desc[b], True
    _zero_counts()
    t0 = time.perf_counter()
    out = psm.match_pair_blocks_sharded(mesh, d1, d2, v1, v2)
    _step(f"match_pair_blocks_sharded, {len(block)} pairs padded to {B}, "
          f"N=M={cap}, {_mesh_line(mesh)}", t0)
    launches += _shard_launches(mesh, "sharded matching")
    one = psm.match_pair_blocks_sharded(pmesh.make_mesh(1, "cuda"), d1, d2,
                                        v1, v2)
    if not np.array_equal(out, one):
        fail("sharded matching differs from the one-shard run")
    for k, (a, b) in enumerate(block):
        want = db.read_matches(a, b)
        got = matching_mod.matches_to_pairs(out[k])
        if not np.array_equal(got, want if want is not None
                              else np.zeros((0, 2), np.uint32)):
            fail(f"sharded matching of pair ({a}, {b}) differs from "
                 "phase 4's matches")
    phase(f"[multi] sharded indices equal the one-shard run bit for bit and "
          f"phase 4's {sum(1 for p in block if db.read_matches(*p) is not None)}"
          f" matched pairs")

    # the matcher kernel against its plain twin at this path's launch
    # shapes, on the same DSLR inputs: each shard's block of the sharded
    # matcher, and the controller's last part (on several cards its parts
    # hold ceil(pairs / cards) pairs, the last one fewer; on one card it
    # is the whole block)
    per, ctrl = B // mesh.size, -(-len(block) // cards.size)
    checks = [(slice(k * per, (k + 1) * per), mesh.devices[k])
              for k in range(mesh.size)]
    checks.append((slice((cards.size - 1) * ctrl, len(block)),
                   cards.devices[-1]))
    names = ("best", "second", "idx", "rev_best", "rev_idx")
    for s, dev in checks:
        b1 = psm._prepare(d1[s], v1[s], dev)
        b2 = psm._prepare(d2[s], v2[s], dev)
        k = hm.top2_fwd_rev(b1, b2)
        r = hm._top2_fwd_rev_reference(b1, b2)
        for name, a, b in zip(names, k, r):
            if not torch.equal(a, b):
                fail(f"[multi] kernel != twin for {name} at "
                     f"B={s.stop - s.start} N=M={cap}: "
                     f"{(a != b).float().mean().item()} of entries differ")
        err = max(float((k[i] - r[i]).abs().max()) for i in (0, 1, 3))
        report["max_abs_err"] = max(report["max_abs_err"], err)
        twin = hm.select_from_top2(*r, b1.valid,
                                   matching_mod.MatchingOptions())
        if not np.array_equal(twin.cpu().numpy(), out[s]):
            fail(f"[multi] sharded matches of pairs {s.start}-{s.stop - 1} "
                 "differ from the twin's")
        del b1, b2, k, r, twin
    phase(f"[multi] kernel == twin bit for bit (all five outputs) and the "
          f"sharded matches equal the twin's, at B="
          f"{[s.stop - s.start for s, _ in checks]} N=M={cap} on the DSLR "
          f"descriptors")

    # the matching controller on a copy of phase 4's database
    copy_path = dslr["db_path"] + ".multi.db"
    shutil.copy(dslr["db_path"], copy_path)
    cdb = Database(copy_path)
    cdb.conn.execute("DELETE FROM matches")
    cdb.conn.execute("DELETE FROM two_view_geometries")
    cdb.commit()
    _zero_counts()
    t0 = time.perf_counter()
    stats = fm.match_exhaustive(
        cdb, fm.FeatureMatchingOptions(num_devices=MULTI_SHARDS),
        device="cuda")
    _step(f"match_exhaustive(num_devices={MULTI_SHARDS}), {stats.num_pairs} "
          f"pairs, {stats.num_verified_pairs} verified, {_mesh_line(cards)}",
          t0)
    launches += _shard_launches(cards, "matching controller")
    for a, b in block:
        want, got = db.read_matches(a, b), cdb.read_matches(a, b)
        if (want is None) != (got is None) or (
                want is not None and not np.array_equal(want, got)):
            fail(f"controller matches of ({a}, {b}) differ from phase 4's")
    errors = pair_rotation_errors(cdb, dslr["ids"], dslr["names"], dslr["Rs"])
    strong = {i for (a, b), (_, n_inl, _) in errors.items() if n_inl >= 100
              for i in (a, b)}
    worst = max(e for e, _, _ in errors.values())
    phase(f"[multi] controller: match rows equal phase 4's; {len(errors)} "
          f"verified pairs (phase 4: {db.num_verified_pairs()}), max rotation "
          f"error {worst:.6f} deg; images in a pair with >= 100 inliers: "
          f"{len(strong)}/{len(img_ids)}")
    if worst > 1.0 or len(strong) != len(img_ids):
        fail("the multi-device controller's verified pairs fail phase 5's "
             "gate")
    cdb.close()
    db.close()
    report["launches_by_path"]["multi"] = launches

    # the pose-sharded BA at the [ba] size against the one-device solve
    problem, _ = bench_ba.build_problem(500, 50_000, 6, 7, "cuda")
    opts = ba.BAOptions(max_iterations=10, cg_iterations=20,
                        function_tolerance=0.0, cg_tolerance=0.0,
                        refine_intrinsics=False)
    _zero_counts()
    t0 = time.perf_counter()
    single = ba.solve(problem, opts)
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    _step("one-device solve", t0)
    _zero_counts()
    t0 = time.perf_counter()
    state = pdba.solve_distributed(problem, opts, mesh)
    torch.cuda.synchronize()
    t_sharded = time.perf_counter() - t0
    _step(f"solve_distributed on {_mesh_line(mesh)}", t0)
    c1, cn = float(single.cost), float(state.cost)
    phase(f"[multi] BA {int(problem.obs_xy.shape[0])} observations, "
          f"{state.iteration} LM x 20 CG: cost {c1:.6f} (one device), "
          f"{cn:.6f} ({mesh.size} shards), rel diff {abs(cn - c1) / c1:.3e}; "
          f"LM it/s {single.iteration / t_single:.3f} (one device), "
          f"{state.iteration / t_sharded:.3f} ({mesh.size} shards)")
    if not abs(cn - c1) <= 1e-3 * c1 or state.iteration != 10:
        fail("the sharded BA's cost is not within 1e-3 of one device's")
    del problem, single, state

    # the DSLR mapper with its global BAs sharded over the cards present
    db = Database(dslr["db_path"])
    popts = IncrementalPipelineOptions()
    popts.mapper.num_devices = MULTI_SHARDS
    pipe = IncrementalPipeline(db, popts, device="cuda")
    _zero_counts()
    t0 = time.perf_counter()
    rec = pipe.run()
    _step(f"DSLR mapper, num_devices={MULTI_SHARDS}, {_mesh_line(cards)}",
          t0)
    bs = pipe.ba_stats
    phase(f"[multi] mapper BA: {int(bs['gba_sharded_calls'])} sharded of "
          f"{int(bs['gba_calls'])} global BAs, {int(bs['lba_calls'])} local; "
          f"global solve {bs['gba_solve']:.3f} s")
    check_model("multi-device mapper", rec, dslr["gt"], len(img_ids),
                len(img_ids), dslr["limit"])
    # sharded global BAs on several cards; on one card none (the mesh holds
    # the cards present, so num_devices=4 takes the one-device path)
    if cards.size > 1 and bs["gba_sharded_calls"] < 1:
        fail("the mapper ran no sharded global BA on several cards")
    if cards.size == 1 and bs["gba_sharded_calls"] != 0:
        fail("the mapper sharded its global BA on one card")
    db.close()
    del pipe

    # round-robin PatchMatch on phase 9's workspace
    ws = dense_cell["dense_dir"]
    for sub in ("depth_maps", "normal_maps"):
        for f in os.listdir(os.path.join(ws, "stereo", sub)):
            os.remove(os.path.join(ws, "stereo", sub, f))
    timings = {}
    _zero_counts()
    hpm.launches = hpm.evaluations = hpm.built = 0
    t0 = time.perf_counter()
    dense.run_patch_match_stereo(ws, dense.PatchMatchStereoOptions(
        num_devices=2, max_image_size=MULTI_PATCH_MATCH_SIZE),
        device="cuda", timings=timings)
    pm_launches, pm_evaluations = hpm.launches, hpm.evaluations
    pm_built = hpm.built
    _step(f"run_patch_match_stereo(num_devices=2) at "
          f"{MULTI_PATCH_MATCH_SIZE} px, "
          f"{_mesh_line(pmesh.make_mesh(2, 'cuda'))}: {timings['maps']} maps, "
          f"photometric {timings['photometric']:.3f} s, geometric "
          f"{timings['geometric']:.3f} s", t0)
    check_pm_launches("multi", pm_launches, pm_evaluations, pm_built,
                      timings["maps"], ws, pm_report)
    check_depth_maps(dense_cell["rec"], dense_cell["gt"], ws,
                     dense_cell["room_size"], "multi")
    phase(f"[multi] phase {time.perf_counter() - t_phase:.3f} s")


SCALE_IMAGES = 300  # phase 14's depth: the script's 1000, cut to fit


def scale_path(report):
    """Phase 14: scripts.scale_run --mode incremental on the card, in this
    process, at SCALE_IMAGES images and the script's widths."""
    from colmap_tpu_torch.scripts import scale_run

    with tempfile.TemporaryDirectory(prefix="chip_smoke_scale_") as work:
        _zero_counts()
        t0 = time.perf_counter()
        rc = scale_run.main(["--num_images", str(SCALE_IMAGES), "--mode",
                             "incremental", "--device", "cuda",
                             "--workspace", work])
        wall = time.perf_counter() - t0
        launches = hm.launches
        with open(os.path.join(work, "report.json")) as fp:
            rep = json.load(fp)
        snapshots = sorted(os.listdir(os.path.join(work, "snapshots"))) \
            if os.path.isdir(os.path.join(work, "snapshots")) else []
    report["launches_by_path"]["scale"] = launches
    phase(f"[scale] scale_run --num_images {SCALE_IMAGES} --mode incremental:"
          f" rc {rc} in {wall:.3f} s; {rep['gt_obs']} observations of "
          f"{rep['gt_points']} points; synthesis {rep['synth_s']} s, mapping "
          f"{rep['elapsed_s']} s; matcher kernel launches {launches}")
    phase("[scale] stage seconds: " + ", ".join(
        f"{k} {v}" for k, v in rep.get("stage_seconds", {}).items()))
    phase("[scale] BA: " + ", ".join(
        f"{k} {v:.3f}" if not float(v).is_integer() else f"{k} {int(v)}"
        for k, v in rep.get("ba_stats", {}).items()))
    phase(f"[scale] snapshots {snapshots}; peak device memory "
          f"{rep.get('peak_device_memory_bytes')} bytes")
    phase(f"[scale] registered {rep.get('num_registered')}/{SCALE_IMAGES}, "
          f"max rotation error {rep.get('max_rotation_error_deg')} deg, max "
          f"centre error {rep.get('max_center_error')}, images/s "
          f"{rep.get('images_per_s')}")
    if rc != 0 or not rep["ok"]:
        fail(f"scale_run failed its gates: "
             f"{rep.get('reason') or rep.get('traceback')}")
    if not (rep["num_registered"] >= 0.95 * SCALE_IMAGES
            and rep["max_rotation_error_deg"] <= 1.0
            and rep["max_center_error"] <= 0.05):
        fail("scale_run's report passes, but not the gates it states")


def reprojection_errors(rec, device) -> torch.Tensor:
    """Every observation's reprojection error (pixels) in `rec`."""
    errs = []
    by_cam = collections.defaultdict(list)
    for p in rec.points3D.values():
        for iid, f in p.track:
            im = rec.images[iid]
            if im.registered:
                by_cam[im.camera_id].append(
                    (im.cam_from_world, p.xyz, im.xys[f]))
    for cid, obs in by_cam.items():
        cam = rec.cameras[cid]
        pose, xyz, xy = (torch.as_tensor(np.stack(a), dtype=torch.float32,
                                         device=device) for a in zip(*obs))
        pc = rigid3.apply(pose, xyz)
        proj = cam_models.img_from_cam(
            cam.model_id, torch.as_tensor(cam.padded_params(), device=device),
            pc[:, :2] / pc[:, 2:])
        errs.append(torch.linalg.norm(proj - xy, dim=-1))
    return torch.cat(errs)


def rig_path(work, report, device="cuda", num_snapshots=125,
             num_points=50_000, abs_snapshots=32, rel_pairs=8):
    """Phase 10 in the scratch directory `work`: rig BA of a perturbed
    4-camera capture through run_rig_bundle_adjustment, then generalized
    absolute and relative pose on its snapshots."""
    t0 = time.perf_counter()
    scene = bench_rig.build_scene(num_snapshots=num_snapshots,
                                  num_points=num_points, seed=0)
    rec, gt = scene.reconstruction(), scene.reconstruction()
    cams = bench_rig.perturb(rec, scene, seed=1)
    config = scene.rig_config()
    for c, cfg in enumerate(config[0]["cameras"]):
        cfg["cam_from_rig_rotation"] = cams[c, :4].tolist()
        cfg["cam_from_rig_translation"] = cams[c, 4:].tolist()
    path = os.path.join(work, "rig_config.json")
    with open(path, "w") as f:
        json.dump(config, f)
    n_obs = sum(len(p.track) for p in rec.points3D.values())
    phase(f"[rig] {scene.num_snapshots} snapshots x {scene.num_cameras} "
          f"cameras, {len(rec.points3D)} points, {n_obs} observations, "
          f"built and perturbed in {time.perf_counter() - t0:.3f} s; start "
          f"RMS {float(reprojection_errors(rec, device).square().mean().sqrt()):.4f} px")
    hm.launches = 0
    stats = {}
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rig_tools.run_rig_bundle_adjustment(rec, path, device=device, stats=stats)
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    report["launches_by_path"]["rig"] = hm.launches
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    rms = float(reprojection_errors(rec, device).square().mean().sqrt())
    phase(f"[rig] rig BA: {stats['lm_iterations']} LM iterations, "
          f"{stats['cg_steps']} CG steps taken, {stats['syncs']} host syncs, "
          f"{secs:.3f} s (solve and write-back); final RMS {rms:.4f} px; "
          f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    cmp = compare_reconstructions(rec, gt, device=device)
    s = float(cmp["sim3"][0])
    # the recovered extrinsics, read from snapshot 0's images
    C = scene.num_cameras
    ref = torch.as_tensor(rec.images[1].cam_from_world)
    cam_rot, cam_trans = [], []
    for c in range(1, C):
        est = rigid3.compose(torch.as_tensor(rec.images[c + 1].cam_from_world),
                             rigid3.inverse(ref))
        true = torch.as_tensor(scene.cams_from_rig()[c])
        cam_rot.append(float(rot.quat_angle_deg(est[:4], true[:4])))
        cam_trans.append(float(torch.linalg.norm(s * est[4:] - true[4:])))
    phase(f"[rig] after a Sim3 alignment (scale {s:.6f}): image rotations "
          f"max {cmp['max_rotation_error_deg']:.6f} deg; cam_from_rig "
          f"rotations {[round(a, 6) for a in cam_rot]} deg, translations "
          f"{[round(t, 6) for t in cam_trans]} m")
    if not rms <= 0.8:
        fail(f"rig BA: final RMS reprojection {rms:.4f} px > 0.8")
    if cmp["max_rotation_error_deg"] > 0.1:
        fail("rig BA: an image rotation is more than 0.1 deg off")
    if max(cam_rot) > 0.05 or max(cam_trans) > 0.005 * s:
        fail("rig BA: a cam_from_rig is more than 0.05 deg / 5 mm off")
    rig_pose_checks(scene, device, abs_snapshots, rel_pairs)


def _snapshot_obs(scene, s):
    """(points, cameras, normalized rays) of snapshot s's noisy
    observations."""
    C = scene.num_cameras
    sel = np.nonzero(scene.obs_image // C == s)[0]
    params = torch.as_tensor(cam_models.pad_params(
        [bench_rig.FOCAL, bench_rig.WIDTH / 2, bench_rig.HEIGHT / 2,
         bench_rig.RADIAL]), dtype=torch.float64)
    rays = cam_models.cam_from_img(
        int(cam_models.CameraModelId.SIMPLE_RADIAL), params,
        torch.as_tensor(scene.obs_xy[sel])).numpy()
    return scene.obs_point[sel], scene.obs_image[sel] % C, rays


def _one_per_point(obs, rng):
    """{point: (camera, ray)}, one random observation per point."""
    out = {}
    for k in rng.permutation(len(obs[0])):
        out.setdefault(int(obs[0][k]), (int(obs[1][k]), obs[2][k]))
    return out


def _padded(rows):
    """Stack per-problem (N_b, ...) arrays, zero-padded to the longest."""
    n = max(len(r) for r in rows)
    out = np.zeros((len(rows), n) + rows[0].shape[1:], rows[0].dtype)
    for b, r in enumerate(rows):
        out[b, :len(r)] = r
    return out


def rig_pose_checks(scene, device, abs_snapshots, rel_pairs):
    """Generalized absolute pose of `abs_snapshots` snapshots at once (20%
    of their observations replaced by outliers) and generalized relative
    pose of `rel_pairs` consecutive snapshot pairs at once, each point
    taken from one random camera per snapshot. The relative pose draws
    16,384 samples, not JAX's default 2,048: a 5-point sample counts only
    when it sees one camera on each side, ~0.1% of uniform draws on 4
    cameras."""
    rng = np.random.default_rng(2)
    cams = torch.as_tensor(scene.cams_from_rig(), dtype=torch.float32,
                           device=device)
    rig_true = scene.rig_poses()
    snaps = np.linspace(0, scene.num_snapshots - 1, abs_snapshots).astype(int)
    X, U, CI, V = [], [], [], []
    for s in snaps:
        pts, cam_idx, uv = _snapshot_obs(scene, s)
        bad = rng.random(len(pts)) < 0.2
        uv[bad] += rng.normal(0, 0.1, (int(bad.sum()), 2))
        X.append(scene.points[pts].astype(np.float32))
        U.append(uv.astype(np.float32))
        CI.append(cam_idx)
        V.append(np.ones(len(pts), bool))

    def dev(a):
        return torch.as_tensor(a, device=device)

    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gp.estimate_generalized_absolute_pose(
        torch.Generator(device=device).manual_seed(0), dev(_padded(X)),
        dev(_padded(U)), dev(_padded(CI)), cams, dev(_padded(V)),
        RansacOptions(max_error=4.0 / bench_rig.FOCAL, num_samples=1024,
                      lo_iterations=2))
    est = res.rig_from_world.double().cpu()
    secs = time.perf_counter() - t0
    true = torch.as_tensor(rig_true[snaps])
    ang = rot.quat_angle_deg(est[:, :4], true[:, :4])
    dt = torch.linalg.norm(rigid3.projection_center(est)
                           - rigid3.projection_center(true), dim=-1)
    phase(f"[rig] generalized absolute pose of {len(snaps)} snapshots "
          f"(20% outliers) in {secs:.3f} s: rotation max {float(ang.max()):.6f}"
          f" deg, centre max {float(dt.max()):.6f} m (spacing "
          f"{scene.spacing}); inliers {res.num_inliers.tolist()}")
    if float(ang.max()) > 0.1 or float(dt.max()) > 0.01 * scene.spacing:
        fail("generalized absolute pose: a rig pose is more than 0.1 deg / "
             "1% of the spacing off")

    R1, R2, C1, C2, V = [], [], [], [], []
    pairs = [(s, s + 1) for s in np.linspace(
        0, scene.num_snapshots - 2, rel_pairs).astype(int)]
    for a, b in pairs:
        oa = _one_per_point(_snapshot_obs(scene, a), rng)
        ob = _one_per_point(_snapshot_obs(scene, b), rng)
        common = sorted(set(oa) & set(ob))
        R1.append(np.stack([oa[p][1] for p in common]).astype(np.float32))
        R2.append(np.stack([ob[p][1] for p in common]).astype(np.float32))
        C1.append(np.array([oa[p][0] for p in common]))
        C2.append(np.array([ob[p][0] for p in common]))
        V.append(np.ones(len(common), bool))
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gp.estimate_generalized_relative_pose(
        torch.Generator(device=device).manual_seed(1), dev(_padded(R1)),
        dev(_padded(R2)), dev(_padded(C1)), dev(_padded(C2)), cams,
        dev(_padded(V)), RansacOptions(max_error=0.05, num_samples=16384,
                                       lo_iterations=2))
    est = res.rig_from_world.double().cpu()
    secs = time.perf_counter() - t0
    true = torch.stack([rigid3.compose(torch.as_tensor(rig_true[b]),
                                       rigid3.inverse(torch.as_tensor(
                                           rig_true[a])))
                        for a, b in pairs])
    ang = rot.quat_angle_deg(est[:, :4], true[:, :4])
    phase(f"[rig] generalized relative pose of {len(pairs)} snapshot pairs "
          f"({[len(r) for r in R1]} common points, "
          f"{[int((a != b).sum()) for a, b in zip(C1, C2)]} seen by another "
          f"camera at the second position) in {secs:.3f} s: "
          f"rotation max {float(ang.max()):.6f} deg")
    if float(ang.max()) > 0.5:
        fail("generalized relative pose: a rotation is more than 0.5 deg off")


def prior_path(report, device="cuda", num_images=100, num_points=3000,
               visibility=30):
    """Phase 11: run_pose_prior_mapper on a synthetic database with
    Cartesian position priors, held to the ground truth in the priors'
    frame; then covariances, triangulation and registration on its
    model."""
    t0 = time.perf_counter()
    db = Database(":memory:")
    gt = synthetic.synthesize_dataset(synthetic.SyntheticDatasetOptions(
        num_images=num_images, num_points3D=num_points, point2D_stddev=0.5,
        match_config=synthetic.MatchConfig.CHAINED, match_overlap=10,
        point_visibility_images=visibility, seed=5), db)
    centres = {iid: gt.images[iid].projection_center()
               for iid in gt.registered_image_ids()}
    C = np.stack(list(centres.values()))
    sigma = 0.01 * float(np.std(C, axis=0).mean())
    rng = np.random.default_rng(5)
    priors = {iid: c + rng.normal(0, sigma, 3) for iid, c in centres.items()}
    for iid, p in priors.items():
        db.write_pose_prior(iid, p, coordinate_system=0)
    db.commit()
    phase(f"[prior] synthesized {db.num_images()} images, "
          f"{len(gt.points3D)} points, priors with sigma {sigma:.6f} in "
          f"{time.perf_counter() - t0:.3f} s")
    hm.launches = 0
    stats = {}
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = sfm_tools.run_pose_prior_mapper(db, device=device, stats=stats)
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    report["launches_by_path"]["prior"] = hm.launches
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if rec is None:
        fail("the pose-prior mapper returned no model")
    diameter = float(np.max(np.linalg.norm(C[:, None] - C[None], axis=-1)))
    ang, dist, to_prior = [], [], []
    for iid in rec.registered_image_ids():
        im = rec.images[iid]
        ang.append(float(rot.quat_angle_deg(
            torch.as_tensor(im.cam_from_world[:4]),
            torch.as_tensor(gt.images[iid].cam_from_world[:4]))))
        dist.append(float(np.linalg.norm(im.projection_center()
                                         - centres[iid])))
        to_prior.append(float(np.linalg.norm(im.projection_center()
                                             - priors[iid])))
    n_reg = rec.num_registered_images()
    phase(f"[prior] run_pose_prior_mapper: {n_reg}/{num_images} registered, "
          f"{len(rec.points3D)} points in {secs:.3f} s; prior BA "
          f"{stats.get('lm_iterations')} LM iterations, "
          f"{stats.get('cg_steps')} CG steps, {stats.get('syncs')} host "
          f"syncs; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)")
    phase(f"[prior] no Sim3: rotation max {max(ang):.6f} deg, centre max "
          f"{max(dist):.6f} (limit {0.05 * diameter:.4f}), median |centre - "
          f"prior| {np.median(to_prior):.6f} (limit {2 * sigma:.6f})")
    if n_reg < 0.95 * num_images:
        fail(f"prior mapper: only {n_reg} of {num_images} registered")
    if max(ang) > 1.0 or max(dist) > 0.05 * diameter:
        fail("prior mapper: a pose is off the ground truth")
    if not np.median(to_prior) <= 2 * sigma:
        fail("prior mapper: the model is not in the priors' frame")
    prior_model_checks(rec, db, gt, device)
    db.close()


def prior_model_checks(rec, db, gt, device):
    """Covariances (the Schur path against the full inverse, on every
    sixth point), known-pose triangulation and image registration on the
    prior mapper's model."""
    reg = rec.registered_image_ids()
    pids = sorted(rec.points3D)[::6]
    row = {iid: k for k, iid in enumerate(reg)}
    obs = [(row[iid], k, rec.images[iid].xys[f])
           for k, pid in enumerate(pids) for iid, f in rec.points3D[pid].track
           if iid in row]
    cam = rec.cameras[rec.images[reg[0]].camera_id]
    cam_ids = sorted(rec.cameras)
    problem = ba.make_problem(
        np.stack([rec.images[i].cam_from_world for i in reg]),
        np.stack([rec.cameras[c].padded_params() for c in cam_ids]),
        np.stack([rec.points3D[p].xyz for p in pids]),
        np.array([o[0] for o in obs]),
        np.array([cam_ids.index(rec.images[reg[o[0]]].camera_id)
                  for o in obs]),
        np.array([o[1] for o in obs]), np.stack([o[2] for o in obs]),
        fix_first_pose_and_gauge=True, device=device)
    t0 = time.perf_counter()
    est = covariance.estimate_ba_covariance(problem,
                                            camera_model_id=cam.model_id)
    t_schur = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = covariance.estimate_pose_covariance_full_inverse(problem,
                                                            cam.model_id)
    t_full = time.perf_counter() - t0
    worst = max(float(np.max(np.abs(Cp - full[p, :, p, :])
                             / (np.abs(full[p, :, p, :]) * 1e-2 + 1e-8)))
                for p, Cp in est.pose_covs.items())
    phase(f"[prior] covariance of {len(reg)} poses over {len(pids)} points "
          f"({len(obs)} observations): Schur {t_schur:.3f} s, full inverse "
          f"{t_full:.3f} s; worst |diff| / (1e-2 |full| + 1e-8) {worst:.4f}")
    if 0 in est.pose_covs or worst > 1.0:
        fail("covariance: the Schur path disagrees with the full inverse")

    bare = copy.deepcopy(rec)
    for pid in list(bare.points3D):
        bare.delete_point3D(pid)
    t0 = time.perf_counter()
    tri = sfm_tools.triangulate_points(db, bare, device=device)
    secs = time.perf_counter() - t0
    err = float(reprojection_errors(tri, device).mean())
    phase(f"[prior] triangulate_points: {len(tri.points3D)} points "
          f"(model {len(rec.points3D)}) in {secs:.3f} s, mean reprojection "
          f"{err:.4f} px")
    if len(tri.points3D) < 0.9 * len(rec.points3D) or not err <= 1.0:
        fail("triangulate_points: too few points or reprojection > 1 px")

    holes = copy.deepcopy(rec)
    gone = reg[5::20][:5]
    for iid in gone:
        holes.images[iid].cam_from_world = None
    t0 = time.perf_counter()
    back = sfm_tools.register_images(db, holes, device=device)
    secs = time.perf_counter() - t0
    ang = [float(rot.quat_angle_deg(
        torch.as_tensor(back.images[i].cam_from_world[:4]),
        torch.as_tensor(gt.images[i].cam_from_world[:4])))
        if back.images[i].registered else float("inf") for i in gone]
    phase(f"[prior] register_images: {gone} back in {secs:.3f} s, rotation "
          f"errors {[round(a, 6) for a in ang]} deg")
    if max(ang) > 1.0:
        fail("register_images: an image did not come back within 1 deg")


def check_depth_maps(rec, gt, dense_dir, s, tag, device="cuda"):
    """Phase 9's depth gates: every registered image has geometric depth
    and normal maps of one size with >= 40% of the pixels estimated, whose
    back-projected points lie within a median 0.03 x room size `s` of the
    room's faces in the render's frame (the model aligned to `gt` by Sim3).
    Maps smaller than the undistorted camera (a `max_image_size` run) are
    back-projected with its calibration scaled to their size. Returns the
    face-distance function of model-frame points."""
    urec = reconstruction_io.read_model(os.path.join(dense_dir, "sparse"))
    to_gt = torch.as_tensor(compare_reconstructions(rec, gt,
                                                    device=device)["sim3"])

    def face_distance(xyz):
        """Distance of model-frame points to the nearest room face."""
        p = sim3.apply(to_gt, torch.as_tensor(np.asarray(xyz, np.float64)))
        p = p.numpy()
        return np.minimum(np.minimum(np.abs(p[:, 2] - s), np.abs(p[:, 0] - s)),
                          np.abs(p[:, 1] - s / 2))

    # depth and normal maps of every registered image, back-projected
    points = []
    shares = []
    for iid in rec.registered_image_ids():
        im = urec.images[iid]
        paths = [os.path.join(dense_dir, "stereo", kind,
                              f"{im.name}.geometric.bin")
                 for kind in ("depth_maps", "normal_maps")]
        if not all(os.path.exists(p) for p in paths):
            fail(f"{im.name}: no geometric depth or normal map")
        depth = depth_map.DepthMap.read(paths[0]).data
        normal = depth_map.NormalMap.read(paths[1]).data
        if normal.shape != depth.shape + (3,):
            fail(f"{im.name}: normal map {normal.shape} for depth map "
                 f"{depth.shape}")
        shares.append(float((depth > 0).mean()))
        ys, xs = np.nonzero(depth > 0)
        cam = urec.cameras[im.camera_id]
        sx, sy = depth.shape[1] / cam.width, depth.shape[0] / cam.height
        fx, fy, cx, cy = cam.params[:4] * np.array([sx, sy, sx, sy])
        d = depth[ys, xs].astype(np.float64)
        Xc = np.stack([(xs + 0.5 - cx) / fx * d, (ys + 0.5 - cy) / fy * d, d],
                      -1)
        q = torch.as_tensor(im.cam_from_world[:4])
        R = rot.quat_to_rotmat(q / torch.linalg.vector_norm(q)).numpy()
        points.append((Xc - im.cam_from_world[4:7]) @ R)
    dist = face_distance(np.concatenate(points))
    phase(f"[{tag}] estimated share per depth map: min {min(shares):.4f}, "
          f"max {max(shares):.4f}; depth points' median distance to the "
          f"room {np.median(dist):.5f} (limit {0.03 * s:.3f})")
    if min(shares) < 0.4:
        fail(f"a depth map has only {min(shares):.4f} of its pixels")
    if not np.median(dist) < 0.03 * s:
        fail("the depth maps are not on the room's faces")
    return face_distance


def check_dense(rec, gt, dense_dir, s, device="cuda"):
    """The dense cell's gates in the render's frame (the model aligned to
    the ground truth `gt` by Sim3): every registered image has geometric
    depth and normal maps with >= 40% of the pixels estimated, whose
    back-projected points lie within a median 0.03 x room size `s` of the
    room's faces; fused.ply has >= 10,000 points, >= 70% within 0.05 s;
    meshed-poisson.ply has > 500 vertices and faces, median vertex
    distance < 0.08 s (tests/test_mvs.py:122-169)."""
    face_distance = check_depth_maps(rec, gt, dense_dir, s, "dense", device)
    cloud = fusion.read_ply(os.path.join(dense_dir, "fused.ply"))
    near = float((face_distance(cloud["xyz"]) < 0.05 * s).mean())
    phase(f"[dense] fused.ply: {len(cloud['xyz'])} points, {near:.4f} within "
          f"{0.05 * s:.3f} of a face")
    if len(cloud["xyz"]) < 10_000 or near < 0.7:
        fail("the fused cloud is too small or off the room's faces")

    verts, faces = read_mesh_ply(os.path.join(dense_dir, "meshed-poisson.ply"))
    med = float(np.median(face_distance(verts)))
    phase(f"[dense] meshed-poisson.ply: {len(verts)} vertices, {len(faces)} "
          f"faces, median vertex distance {med:.5f} (limit {0.08 * s:.3f})")
    if len(verts) <= 500 or len(faces) <= 500 or not med < 0.08 * s:
        fail("the Poisson mesh is too small or off the room's faces")


def read_mesh_ply(path):
    """(vertices [N, 3], faces [M, 3]) of a binary triangle-mesh PLY as
    mvs.meshing.write_mesh_ply writes it."""
    with open(path, "rb") as f:
        counts = {}
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element"):
                counts[line.split()[1]] = int(line.split()[2])
            if line == "end_header":
                break
        verts = np.frombuffer(f.read(12 * counts["vertex"]), "<f4").reshape(
            -1, 3)
        rec = np.frombuffer(f.read(), dtype=[("n", "u1"), ("v", "<i4", 3)],
                            count=counts["face"])
    return verts, rec["v"]


def drive(tag, opts):
    """run_automatic_reconstruction(opts) on the card with the matcher's
    launch counter zeroed just before and read just after; prints the
    stage seconds, BA counters and peak device memory. Returns (rec, db,
    stage timings, launches)."""
    stages = {}
    torch.cuda.reset_peak_memory_stats()
    hm.launches = 0
    t0 = time.perf_counter()
    rec, db = ar.run_automatic_reconstruction(opts, stage_timings=stages,
                                              device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hm.launches
    peak = torch.cuda.max_memory_allocated()
    phase(f"[{tag}] stages s: extraction {stages['extraction']:.3f}, "
          f"matching {stages['matching']:.3f}, mapping "
          f"{stages['mapping']:.3f}, total {wall:.3f}")
    phase(f"[{tag}] mapping stages s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages["mapping_stages"].items()))
    mba = stages["mapping_ba"]
    phase(f"[{tag}] mapping BA: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) and not v.is_integer()
        else f"{k} {int(v)}" for k, v in sorted(mba.items())))
    phase(f"[{tag}] BA host syncs: {int(mba['lba_syncs'])} in "
          f"{int(mba['lba_calls'])} local BAs, {int(mba['gba_syncs'])} in "
          f"{int(mba['gba_calls'])} global BAs")
    phase(f"[{tag}] peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    return rec, db, stages, launches


def check_keypoints(db, ids, names, width, height):
    for nm in names:
        kp = db.read_keypoints(ids[nm])
        if not (np.isfinite(kp).all() and (kp[:, 0] >= 0).all()
                and (kp[:, 0] < width).all() and (kp[:, 1] >= 0).all()
                and (kp[:, 1] < height).all()):
            fail(f"keypoints of {nm} are not finite or leave the image")


def pair_rotation_errors(db, ids, names, Rs):
    """{(a, b): (deg, inliers, config)} for every verified pair: its relative
    rotation, recovered from the stored E and inlier matches, against the
    ground truth `Rs` (world-to-camera, in the order of `names`)."""
    cam = db.read_cameras()[db.read_images()[ids[names[0]]]["camera_id"]]
    params = torch.as_tensor(cam_models.pad_params(list(cam["params"])))
    rays = {}
    for nm in names:
        xy = db.read_keypoints(ids[nm])[:, :2].astype(np.float32)
        rays[ids[nm]] = cam_models.cam_from_img(cam["model_id"], params,
                                                torch.as_tensor(xy))
    index = {ids[nm]: i for i, nm in enumerate(names)}
    out = {}
    for (a, b) in sorted(db.read_all_two_view_geometries()):
        g = db.read_two_view_geometry(a, b)
        m = g["inlier_matches"].astype(np.int64)
        pose, _, _ = pose_from_essential_matrix(
            torch.as_tensor(g["E"], dtype=torch.float32),
            rays[a][m[:, 0]], rays[b][m[:, 1]])
        R_rel = Rs[index[b]] @ Rs[index[a]].T
        q_gt = rot.rotmat_to_quat(torch.as_tensor(R_rel, dtype=torch.float32))
        out[(a, b)] = (float(rot.quat_angle_deg(q_gt, pose[:4])), len(m),
                       g["config"])
    return out


def true_inliers(db, ids, names, K, Rs, ts, max_error_px=4.0):
    """{(a, b): (on, inliers)} for every verified pair: how many of its
    inlier matches lie within `max_error_px` (Sampson distance, the
    verification's own threshold) of the ground-truth epipolar geometry."""
    Ki = np.linalg.inv(K)
    index = {ids[nm]: i for i, nm in enumerate(names)}
    out = {}
    for (a, b) in sorted(db.read_all_two_view_geometries()):
        ia, ib = index[a], index[b]
        R = Rs[ib] @ Rs[ia].T
        t = ts[ib] - R @ ts[ia]
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                       [-t[1], t[0], 0]])
        F = Ki.T @ tx @ R @ Ki
        m = db.read_two_view_geometry(a, b)["inlier_matches"].astype(np.int64)
        x1 = np.c_[db.read_keypoints(a)[m[:, 0], :2], np.ones(len(m))]
        x2 = np.c_[db.read_keypoints(b)[m[:, 1], :2], np.ones(len(m))]
        Fx1, Ftx2 = x1 @ F.T, x2 @ F
        sampson = np.sum(Fx1 * x2, 1) ** 2 / (
            Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2
            + Ftx2[:, 1] ** 2)
        out[(a, b)] = (int((sampson <= max_error_px ** 2).sum()), len(m))
    return out


def gt_model(ids, names, K, Rs, ts, width, height):
    gt = Reconstruction()
    gt.add_camera(Camera(camera_id=1, model_id=1, width=width, height=height,
                         params=np.array([K[0, 0], K[1, 1], K[0, 2],
                                          K[1, 2]])))
    for i, nm in enumerate(names):
        q = rot.rotmat_to_quat(torch.as_tensor(Rs[i], dtype=torch.float32))
        gt.add_image(Image(image_id=ids[nm], name=nm, camera_id=1,
                           cam_from_world=np.concatenate(
                               [q.numpy(), ts[i]]).astype(np.float64)))
    return gt


def check_model(label, rec, gt, n_images, min_registered, limit):
    """At least `min_registered` of `n_images` registered and, after a Sim3
    alignment to the ground truth `gt`, every rotation within 1 deg and
    every centre within `limit`."""
    if rec is None:
        fail(f"{label}: the mapper returned no model")
    cmp = compare_reconstructions(rec, gt, device="cuda")
    n_reg = rec.num_registered_images()
    phase(f"[outcome] {label}: {n_reg}/{n_images} registered, "
          f"{len(rec.points3D)} points, max rotation error "
          f"{cmp['max_rotation_error_deg']:.6f} deg, max centre error "
          f"{cmp['max_center_error']:.6f} (limit {limit:.3f})")
    if n_reg < min_registered:
        fail(f"{label}: only {n_reg} of {n_images} images registered")
    if cmp["max_rotation_error_deg"] > 1.0:
        fail(f"{label}: a rotation is more than 1 deg from ground truth")
    if cmp["max_center_error"] > limit:
        fail(f"{label}: a centre is more than {limit:.3f} from ground truth")


def check_read_back(rec, workspace):
    back = reconstruction_io.read_model(os.path.join(workspace, "sparse", "0"))
    if (back.num_registered_images() != rec.num_registered_images()
            or len(back.points3D) != len(rec.points3D)):
        fail("sparse/0 does not read back as the model written")
    phase(f"[outcome] sparse/0 read back: {back.num_registered_images()} "
          f"images, {len(back.points3D)} points")


if __name__ == "__main__":
    main()
