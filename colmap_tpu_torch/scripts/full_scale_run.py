"""North-star FULL-pipeline scale run: pixels -> SIFT -> sequential
matching (+ vocab-tree loop detection) -> incremental mapper, in one
command, at the 1000-image scale.

Port of the JAX package's scripts/full_scale_run.py. Unlike scale_run
(which synthesizes a match database and exercises the mapper alone), this
renders real frames of an orbit and runs the everything-path the
reference's AutomaticReconstructionController runs, with per-stage wall
seconds for extraction / matching / mapping and the reference-CI-style
accuracy gate against the render's ground truth.

    python -m colmap_tpu_torch.scripts.full_scale_run --num_images 1000 \\
        --workspace /tmp/full1000

The rendered frames are cached inside the workspace: re-runs with the
same workspace skip rendering. Writes <workspace>/report.json and prints
it as the last line; exit 0 iff the run met the gate. Beside the JAX
script's keys the report holds `device` (and on a card `card` and
`peak_device_memory_bytes`) and `k1_launches`, the matcher kernel's
launches (0 on the CPU, where its plain twin runs); `stage_seconds`
carries the matcher's counters (`matching_stats`: pair blocks,
descriptor-pool builds) and the mapper's stages and BA counters.
"""

import argparse
import datetime
import json
import logging
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from colmap_tpu_torch import scripts


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num_images", type=int, default=1000)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--quality", default="low",
                   help="automatic-reconstruction quality preset")
    p.add_argument("--overlap", type=int, default=10,
                   help="sequential matching temporal window; slow orbits "
                        "need ~50 so some pair passes the 16-deg init "
                        "tri-angle gate with >=100 inliers")
    p.add_argument("--workspace", default=os.path.join(
        tempfile.gettempdir(), "colmap_tpu_full_scale"))
    p.add_argument("--max_rot_deg", type=float, default=1.0)
    p.add_argument("--max_center_err", type=float, default=0.05)
    p.add_argument("--min_registered_ratio", type=float, default=0.95)
    p.add_argument("--seed", type=int, default=3)
    scripts.add_device_argument(p)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname).1s %(message)s")
    device_keys = scripts.open_device(args.device)

    from colmap_tpu_torch.geometry import rotation as rot
    from colmap_tpu_torch.scene import reconstruction_io as rio
    from colmap_tpu_torch.scene import synthetic_images as synth
    from colmap_tpu_torch.scene.reconstruction import (
        Camera,
        Image as RImage,
        Reconstruction,
    )

    os.makedirs(args.workspace, exist_ok=True)
    image_path = os.path.join(args.workspace, "images")
    gt_path = os.path.join(args.workspace, "gt_model")
    opts = synth.OrbitDatasetOptions(
        num_images=args.num_images, width=args.width, height=args.height,
        focal=0.875 * args.width, seed=args.seed)

    t0 = time.time()
    if os.path.isdir(image_path) and os.path.isdir(gt_path) and \
            len(os.listdir(image_path)) == args.num_images:
        gt = rio.read_model(gt_path)
        names = sorted(os.listdir(image_path))
        logging.info("reusing %d cached frames in %s", len(names),
                     image_path)
    else:
        images, K, Rs, ts = synth.render_orbit_dataset(opts)
        names = synth.write_dataset(image_path, images)
        gt = Reconstruction()
        gt.add_camera(Camera(camera_id=1, model_id=1, width=opts.width,
                             height=opts.height,
                             params=np.array([K[0, 0], K[1, 1],
                                              K[0, 2], K[1, 2]])))
        for i, (R, t) in enumerate(zip(Rs, ts)):
            q = rot.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32))
            gt.add_image(RImage(image_id=i + 1, name=names[i], camera_id=1,
                                cam_from_world=np.concatenate(
                                    [q.numpy(), t])))
        os.makedirs(gt_path, exist_ok=True)
        rio.write_model(gt, gt_path, ext=".bin")
    render_s = time.time() - t0
    K = gt.cameras[1].params

    report = {"ok": False, "pipeline": "full (pixels->poses)",
              # measured and reported by this script itself
              "self_reported": True,
              "produced_by": scripts.command_line(
                  "colmap_tpu_torch.scripts.full_scale_run", argv),
              "timestamp_utc": datetime.datetime.now(
                  datetime.timezone.utc).isoformat(timespec="seconds"),
              "num_images": args.num_images,
              "resolution": f"{args.width}x{args.height}",
              "render_s": round(render_s, 1)}
    report.update(device_keys)

    from colmap_tpu_torch.controllers.automatic_reconstruction import (
        AutomaticReconstructionOptions,
        DataType,
        Quality,
        run_automatic_reconstruction,
    )
    from colmap_tpu_torch.controllers.incremental_pipeline import (
        IncrementalPipelineOptions,
    )
    from colmap_tpu_torch.estimators.similarity_transform import (
        compare_reconstructions,
    )
    from colmap_tpu_torch.features import hopper_matcher

    stage_timings: dict = {}
    launches = hopper_matcher.launches
    t0 = time.time()
    try:
        rec, _db = run_automatic_reconstruction(
            AutomaticReconstructionOptions(
                workspace_path=args.workspace, image_path=image_path,
                data_type=DataType.VIDEO,
                quality=Quality[args.quality.upper()],
                camera_model="PINHOLE", single_camera=True,
                video_overlap=args.overlap,
                camera_params=",".join(str(float(v)) for v in K)),
            mapper_options=IncrementalPipelineOptions(
                snapshot_path=os.path.join(args.workspace, "snapshots"),
                snapshot_images_freq=200),
            seed=args.seed, stage_timings=stage_timings, device=args.device)
    except Exception as e:  # noqa: BLE001 - report, don't lose evidence
        report["error"] = str(e)[:500]
        report["traceback"] = traceback.format_exc()[-2000:]
        rec = None
    report["elapsed_s"] = round(time.time() - t0, 1)
    report["stage_seconds"] = stage_timings
    report["k1_launches"] = hopper_matcher.launches - launches
    report.update(scripts.peak_memory(args.device))

    if rec is None:
        report["reason"] = report.get("error", "no model")
    else:
        n_reg = rec.num_registered_images()
        report.update(
            num_registered=n_reg,
            num_points3D=len(rec.points3D),
            images_per_s=round(n_reg / max(report["elapsed_s"], 1e-9), 3),
        )
        res = compare_reconstructions(rec, gt, device=args.device)
        if res is not None:
            report["max_rotation_error_deg"] = round(
                float(res["max_rotation_error_deg"]), 4)
            report["max_center_error"] = round(
                float(res["max_center_error"]), 5)
            report["ok"] = bool(
                report["max_rotation_error_deg"] <= args.max_rot_deg
                and report["max_center_error"] <= args.max_center_err
                and n_reg >= args.min_registered_ratio * args.num_images)
        else:
            report["reason"] = "alignment to GT failed"

    with open(os.path.join(args.workspace, "report.json"), "w") as fp:
        json.dump(report, fp, indent=2)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
