"""End-to-end reconstruction accuracy gate.

Port of the JAX package's scripts/benchmark_reconstruction.py, the
equivalent of the reference CI benchmark (scripts/python/benchmark_eth3d.py
in COLMAP): run the one-click reconstruction on a dataset, align to ground
truth, and FAIL (exit 1) if any image exceeds the rotation /
projection-center error bounds or if the registered-image count
mismatches; exit 2 where the ground-truth model is missing.

Works on any local dataset laid out like ETH3D DSLR undistorted data:

    <dataset>/images/...                      (photographs)
    <dataset>/dslr_calibration_undistorted/   (GT COLMAP model: cameras.txt,
                                               images.txt, points3D.txt)

(or pass --gt_model_path explicitly; .bin models work too). Nothing is
downloaded: point it at a pre-downloaded ETH3D scene, or use --synthetic N
to render an N-image ground-truthed dataset and gate on it.

Examples:
    python -m colmap_tpu_torch.scripts.benchmark_reconstruction \\
        --dataset_path ~/eth3d/boulders --max_rot_deg 1.0 --max_center_err 0.05
    python -m colmap_tpu_torch.scripts.benchmark_reconstruction \\
        --synthetic 30 --workspace /tmp/bench_ws

Beside the JAX script's keys the report holds `device` (and on a card
`card` and `peak_device_memory_bytes`), `stage_seconds` (the stage
timings of `run_automatic_reconstruction`, with the matcher's counters)
and `k1_launches`, the matcher kernel's launches (0 on the CPU, where its
plain twin runs).
"""

import argparse
import datetime
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from colmap_tpu_torch import scripts


def load_gt(gt_path):
    from colmap_tpu_torch.scene import reconstruction_io as rio

    return rio.read_model(gt_path)


def run(args, argv):
    from colmap_tpu_torch.controllers.automatic_reconstruction import (
        AutomaticReconstructionOptions,
        Quality,
        run_automatic_reconstruction,
    )
    from colmap_tpu_torch.estimators.similarity_transform import (
        compare_reconstructions,
    )
    from colmap_tpu_torch.features import hopper_matcher

    device_keys = scripts.open_device(args.device)
    if args.workspace:
        workspace = args.workspace
    elif args.dataset_path:
        workspace = os.path.join(args.dataset_path, "ws_tpu")
    else:
        workspace = os.path.join(tempfile.gettempdir(), "colmap_tpu_bench")
    if args.synthetic:
        from colmap_tpu_torch.geometry import rotation as rot
        from colmap_tpu_torch.scene import synthetic_images as synth
        from colmap_tpu_torch.scene.reconstruction import (
            Camera, Image as RImage, Reconstruction)

        os.makedirs(workspace, exist_ok=True)
        image_path = os.path.join(workspace, "images")
        opts = synth.RoomDatasetOptions(
            num_images=args.synthetic, width=args.synthetic_width,
            height=args.synthetic_height,
            focal=0.875 * args.synthetic_width, seed=11,
            # keep texture detail near pixel scale at DSLR resolutions so
            # feature localization is texture-limited, not render-limited
            texture_res=max(512, args.synthetic_width))
        images, K, Rs, ts = synth.render_room_dataset(opts)
        synth.write_dataset(image_path, images)
        gt = Reconstruction()
        gt.add_camera(Camera(camera_id=1, model_id=1, width=opts.width,
                             height=opts.height,
                             params=np.array([K[0, 0], K[1, 1],
                                              K[0, 2], K[1, 2]])))
        for i, (R, t) in enumerate(zip(Rs, ts)):
            q = rot.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32))
            gt.add_image(RImage(image_id=i + 1, name=f"{i:04d}.png",
                                camera_id=1,
                                cam_from_world=np.concatenate(
                                    [q.numpy(), t])))
        camera_params = ",".join(map(str, [K[0, 0], K[1, 1], K[0, 2],
                                           K[1, 2]]))
        camera_model = "PINHOLE"
    else:
        image_path = os.path.join(args.dataset_path, "images")
        gt_path = args.gt_model_path or os.path.join(
            args.dataset_path, "dslr_calibration_undistorted")
        if not os.path.isdir(gt_path):
            print(f"ground-truth model not found at {gt_path}",
                  file=sys.stderr)
            return 2
        gt = load_gt(gt_path)
        # the reference benchmark passes the GT intrinsics of the first camera
        cam = gt.cameras[sorted(gt.cameras)[0]]
        camera_params = ",".join(str(float(p)) for p in cam.params)
        camera_model = cam.model_name

    stage_timings: dict = {}
    launches = hopper_matcher.launches
    t0 = time.time()
    rec, _ = run_automatic_reconstruction(AutomaticReconstructionOptions(
        workspace_path=workspace,
        image_path=image_path,
        quality=Quality[args.quality.upper()],
        camera_model=camera_model,
        camera_params=camera_params,
        single_camera=True,
        dense=False,
    ), stage_timings=stage_timings, device=args.device)
    elapsed = time.time() - t0

    if rec is None:
        print(json.dumps({"ok": False, "reason": "no model"}))
        return 1
    res = compare_reconstructions(rec, gt, device=args.device)
    n_gt = sum(1 for im in gt.images.values() if im.registered)

    report = {
        "ok": True,
        # measured and reported by this script itself
        "self_reported": True,
        "produced_by": scripts.command_line(
            "colmap_tpu_torch.scripts.benchmark_reconstruction", argv),
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "elapsed_s": round(elapsed, 1),
        "num_registered": rec.num_registered_images(),
        "num_gt_images": n_gt,
        "num_points3D": len(rec.points3D),
        "max_rotation_error_deg": None,
        "max_center_error": None,
    }
    report.update(device_keys)
    report["stage_seconds"] = stage_timings
    report["k1_launches"] = hopper_matcher.launches - launches
    report.update(scripts.peak_memory(args.device))
    if res is None:
        report.update(ok=False, reason="alignment to GT failed")
        print(json.dumps(report))
        return 1
    report["max_rotation_error_deg"] = round(
        float(res["max_rotation_error_deg"]), 4)
    report["max_center_error"] = round(float(res["max_center_error"]), 5)
    ok = (report["max_rotation_error_deg"] <= args.max_rot_deg
          and report["max_center_error"] <= args.max_center_err
          and rec.num_registered_images() >= args.min_registered_ratio * n_gt)
    report["ok"] = bool(ok)
    print(json.dumps(report), flush=True)
    if args.report_path:
        with open(args.report_path, "w") as fp:
            json.dump(report, fp, indent=2)
    return 0 if ok else 1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_path", default=None,
                   help="ETH3D-style dataset dir (images/ + GT model)")
    p.add_argument("--gt_model_path", default=None)
    p.add_argument("--workspace", default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="render an N-image ground-truthed synthetic dataset")
    p.add_argument("--synthetic_width", type=int, default=320)
    p.add_argument("--synthetic_height", type=int, default=240)
    p.add_argument("--quality", default="low",
                   choices=["low", "medium", "high", "extreme"])
    # reference CI bounds: 1.0 deg / 0.05 m
    p.add_argument("--max_rot_deg", type=float, default=1.0)
    p.add_argument("--max_center_err", type=float, default=0.05)
    p.add_argument("--min_registered_ratio", type=float, default=1.0)
    p.add_argument("--report_path", default=None,
                   help="also write the report JSON here")
    scripts.add_device_argument(p)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    if not args.synthetic and not args.dataset_path:
        p.error("pass --dataset_path or --synthetic N")
    return run(args, argv)


if __name__ == "__main__":
    sys.exit(main())
