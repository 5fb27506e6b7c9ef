"""North-star scale run: reconstruct a 1000+-image synthetic scene.

Port of the JAX package's scripts/scale_run.py. A walk-around capture with
realistic local co-visibility (point_visibility_images) and
sequential-matcher topology (CHAINED + overlap) is synthesized as a match
database, mapped either incrementally (snapshots every 200 images) or
hierarchically, and gated against ground truth.

    python -m colmap_tpu_torch.scripts.scale_run --num_images 1000 \\
        --mode hierarchical --workspace /tmp/scale1000

Writes <workspace>/report.json and prints it as the last line; exit 0 iff
the run completed and met the accuracy gate. Beside the JAX script's keys
the report holds `device` (and on a card `card` and
`peak_device_memory_bytes`), the mapper's BA counters `ba_stats` and, in
hierarchical mode, the clusters' summed `stage_seconds` and the
pipeline's `hierarchical_seconds`.
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

from colmap_tpu_torch import scripts


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num_images", type=int, default=1000)
    p.add_argument("--points_per_image", type=int, default=20)
    p.add_argument("--visibility_images", type=int, default=40,
                   help="each point is seen by ~this many consecutive cameras")
    p.add_argument("--overlap", type=int, default=10,
                   help="sequential match overlap (pairs (i, i+k), "
                        "k<=overlap)")
    p.add_argument("--noise_px", type=float, default=0.5)
    p.add_argument("--mode", choices=["incremental", "hierarchical"],
                   default="incremental")
    p.add_argument("--workspace", default=os.path.join(
        tempfile.gettempdir(), "colmap_tpu_scale"))
    p.add_argument("--max_rot_deg", type=float, default=1.0)
    p.add_argument("--max_center_err", type=float, default=0.05)
    p.add_argument("--min_registered_ratio", type=float, default=0.95)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--leaf_max_images", type=int, default=0,
                   help="hierarchical mode: max images per cluster leaf "
                        "(0 = library default; set below num_images to "
                        "force a multi-cluster split + merge)")
    p.add_argument("--db_cache", default="",
                   help="path to an on-disk database: synthesized once, "
                        "reused by later runs")
    scripts.add_device_argument(p)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname).1s %(message)s")
    device_keys = scripts.open_device(args.device)
    os.makedirs(args.workspace, exist_ok=True)

    from colmap_tpu_torch.scene import reconstruction_io as rio
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.synthetic import (
        MatchConfig,
        SyntheticDatasetOptions,
        synthesize_dataset,
    )

    t0 = time.time()
    gt_dir = args.db_cache + ".gt" if args.db_cache else ""
    if args.db_cache and os.path.exists(args.db_cache) \
            and os.path.isdir(gt_dir):
        db = Database(args.db_cache)
        gt = rio.read_model(gt_dir)
        synth_s = time.time() - t0
        logging.info("loaded cached dataset from %s in %.1fs",
                     args.db_cache, synth_s)
    else:
        db = Database(args.db_cache if args.db_cache else ":memory:")
        gt = synthesize_dataset(SyntheticDatasetOptions(
            num_images=args.num_images,
            num_points3D=args.points_per_image * args.num_images,
            point2D_stddev=args.noise_px,
            match_config=MatchConfig.CHAINED,
            match_overlap=args.overlap,
            point_visibility_images=args.visibility_images,
            seed=args.seed), db)
        if gt_dir:
            os.makedirs(gt_dir, exist_ok=True)
            rio.write_model(gt, gt_dir, ext=".bin")
        synth_s = time.time() - t0
        logging.info("synthesized %d images in %.1fs", args.num_images,
                     synth_s)
    n_obs_gt = sum(len(pt.track) for pt in gt.points3D.values())

    report = {"ok": False, "mode": args.mode,
              # measured and reported by this script itself
              "self_reported": True,
              "produced_by": scripts.command_line(
                  "colmap_tpu_torch.scripts.scale_run", argv),
              "timestamp_utc": datetime.datetime.now(
                  datetime.timezone.utc).isoformat(timespec="seconds"),
              "num_images": args.num_images,
              "gt_points": len(gt.points3D), "gt_obs": n_obs_gt,
              "synth_s": round(synth_s, 1)}
    report.update(device_keys)
    t0 = time.time()
    pipe = None
    try:
        if args.mode == "incremental":
            from colmap_tpu_torch.controllers.incremental_pipeline import (
                IncrementalPipeline,
                IncrementalPipelineOptions,
            )

            opts = IncrementalPipelineOptions(
                snapshot_path=os.path.join(args.workspace, "snapshots"),
                snapshot_images_freq=200)
            pipe = IncrementalPipeline(db, opts, device=args.device)
            rec = pipe.run()
        else:
            from colmap_tpu_torch.controllers.hierarchical_pipeline import (
                HierarchicalPipeline,
                HierarchicalPipelineOptions,
            )
            from colmap_tpu_torch.scene import scene_clustering as sc

            hopts = HierarchicalPipelineOptions()
            if args.leaf_max_images > 0:
                hopts.clustering = sc.SceneClusteringOptions(
                    leaf_max_num_images=args.leaf_max_images)
            pipe = HierarchicalPipeline(db, hopts, device=args.device)
            rec = pipe.run()
    except Exception as e:  # noqa: BLE001 - report, don't lose the evidence
        report["error"] = str(e)[:500]
        report["traceback"] = traceback.format_exc()[-2000:]
        rec = None
    report["elapsed_s"] = round(time.time() - t0, 1)
    if pipe is not None:
        report["stage_seconds"] = {
            k: round(v, 1) for k, v in sorted(pipe.stage_s.items(),
                                              key=lambda kv: -kv[1])}
        report["ba_stats"] = dict(sorted(pipe.ba_stats.items()))
        if args.mode == "hierarchical":
            report["hierarchical_seconds"] = {
                k: round(v, 1) for k, v in pipe.timings.items()}
    report.update(scripts.peak_memory(args.device))

    if rec is None:
        report["reason"] = report.get("error", "no model")
    else:
        from colmap_tpu_torch.estimators.similarity_transform import (
            compare_reconstructions,
        )

        n_reg = rec.num_registered_images()
        report.update(
            num_registered=n_reg,
            num_points3D=len(rec.points3D),
            images_per_s=round(n_reg / max(report["elapsed_s"], 1e-9), 3),
        )
        out_dir = os.path.join(args.workspace, "sparse")
        os.makedirs(out_dir, exist_ok=True)
        rio.write_model(rec, out_dir, ext=".bin")
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
