"""Time the hierarchical mapper with 1 and with 4 worker threads.

Port of scripts/hierarchical_timing.py. It builds the hierarchical gate's
synthetic database (HIER_GATE_r05.json: 200 images on a circle, 20 points
per image each seen by its 40 nearest cameras, 0.5 px noise, chained
matches of overlap 10, seed 3) with the port's synthesize_dataset, warms
the device libraries up on a 12-image scene, then maps the same database
once per worker count and prints, per run, the wall seconds, the leaves,
the registered images and the errors against the ground truth after a
Sim3 alignment (the gate: >= 95% registered, <= 1 deg, <= 0.05):

    python -m colmap_tpu_torch.bench_hierarchical [--device cuda]
        [--workers 1,4] [--out bench_hierarchical.json]

Each cluster also reports its mapping seconds.

The last line of its output is the report as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from colmap_tpu_torch.controllers.hierarchical_pipeline import (  # noqa: E402
    HierarchicalPipeline,
    HierarchicalPipelineOptions,
)
from colmap_tpu_torch.estimators.similarity_transform import (  # noqa: E402
    compare_reconstructions,
)
from colmap_tpu_torch.scene import scene_clustering as sc  # noqa: E402
from colmap_tpu_torch.scene import synthetic  # noqa: E402
from colmap_tpu_torch.scene.database import Database  # noqa: E402


def build_db(num_images: int, seed: int):
    """The gate's database and its ground-truth model."""
    db = Database(":memory:")
    gt = synthetic.synthesize_dataset(synthetic.SyntheticDatasetOptions(
        num_images=num_images, num_points3D=20 * num_images,
        point2D_stddev=0.5, match_config=synthetic.MatchConfig.CHAINED,
        match_overlap=10, point_visibility_images=40, seed=seed), db)
    return db, gt


def run_once(db, gt, num_workers: int, leaf_max_images: int, device,
             image_overlap: int = 50) -> dict:
    """One hierarchical mapping; returns its timings, counters and errors."""
    opts = HierarchicalPipelineOptions(
        clustering=sc.SceneClusteringOptions(
            leaf_max_num_images=leaf_max_images, image_overlap=image_overlap),
        num_workers=num_workers)
    pipe = HierarchicalPipeline(db, opts, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = pipe.run()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    out = dict(workers=num_workers, wall_s=time.perf_counter() - t0,
               leaves=pipe.leaf_sizes, clusters=pipe.clusters,
               timings=dict(pipe.timings), stage_s=dict(pipe.stage_s),
               ba_stats=dict(pipe.ba_stats),
               num_registered=0 if rec is None
               else rec.num_registered_images(),
               num_points=0 if rec is None else len(rec.points3D))
    if torch.device(device).type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    cmp = None if rec is None else compare_reconstructions(rec, gt,
                                                           device=device)
    out["max_rotation_error_deg"] = (None if cmp is None
                                     else cmp["max_rotation_error_deg"])
    out["max_center_error"] = None if cmp is None else cmp["max_center_error"]
    return out, rec


def gate_ok(run: dict, num_images: int) -> bool:
    return (run["num_registered"] >= 0.95 * num_images
            and run["max_rotation_error_deg"] is not None
            and run["max_rotation_error_deg"] <= 1.0
            and run["max_center_error"] <= 0.05)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num_images", type=int, default=200)
    p.add_argument("--leaf_max_images", type=int, default=60)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--workers", default="1,4")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    logging.basicConfig(level=logging.WARNING,
                        format="%(asctime)s %(levelname).1s %(message)s")

    t0 = time.perf_counter()
    db, gt = build_db(args.num_images, args.seed)
    report = dict(num_images=args.num_images,
                  leaf_max_images=args.leaf_max_images, seed=args.seed,
                  device=args.device, synthesize_s=time.perf_counter() - t0,
                  runs=[])
    # warm-up: the device libraries' first loads, on a 12-image scene
    wdb = Database(":memory:")
    wgt = synthetic.synthesize_dataset(synthetic.SyntheticDatasetOptions(
        num_cameras=1, num_images=12, num_points3D=220, point2D_stddev=0.4,
        seed=11), wdb)
    t0 = time.perf_counter()
    run_once(wdb, wgt, 1, 5, args.device, image_overlap=2)
    report["warmup_s"] = time.perf_counter() - t0

    for w in (int(x) for x in args.workers.split(",")):
        run, _ = run_once(db, gt, w, args.leaf_max_images, args.device)
        run["ok"] = gate_ok(run, args.num_images)
        report["runs"].append(run)
        print(f"[hier] workers={w}: wall {run['wall_s']:.3f} s, "
              f"{run['num_registered']}/{args.num_images} registered, "
              f"max rotation {run['max_rotation_error_deg']} deg, max centre "
              f"{run['max_center_error']}, leaves {run['leaves']}, "
              f"timings {run['timings']}", flush=True)
        for k, c in enumerate(run["clusters"]):
            print(f"[hier] workers={w} cluster {k}: {c['seconds']:.3f} s, "
                  f"{c['registered']}/{c['images']} registered", flush=True)
    walls = {r["workers"]: r["wall_s"] for r in report["runs"]}
    if 1 in walls and 4 in walls:
        report["speedup_4_over_1"] = walls[1] / walls[4]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump(report, fp, indent=1)
    print(json.dumps(report), flush=True)
    if not all(r["ok"] for r in report["runs"]):
        sys.exit(1)


if __name__ == "__main__":
    main()
