"""Time the port's paths that take Jacobians, on one GPU: the `[ba]` cell,
the DSLR cell's mapping and the hierarchical gate with 1 and 4 worker
threads.

    python colmap_tpu_torch/bench_mapping.py [--root DIR] [--parts ba,dslr,hier]
        [--out FILE]

`--root` names the checkout whose `colmap_tpu_torch` is imported (default:
the one holding this file), so that one command can time two commits in
turns, e.g. a `git archive` of the parent unpacked under `.scratch/`. The
script calls only entry points both trees have: `bench_ba.run()` (500
poses, 300k observations, 10 LM x 20 CG, LM iterations/s), the DSLR cell
of `chip_smoke.py` (20 rendered 1536x1152 images, Quality.HIGH, one PINHOLE
camera, `run_automatic_reconstruction(sparse=True)`: its extraction,
matching and mapping seconds, run once, so mapping is cold), and
`bench_hierarchical.run_once` on the 200-image gate (leaves of 60) with 1
and then 4 worker threads. Prints the card's name and power limit, one
line per part, and the report as one JSON object on the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--parts", default="ba,dslr,hier")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import colmap_tpu_torch
    from colmap_tpu_torch import bench_ba, bench_hierarchical
    from colmap_tpu_torch.controllers import automatic_reconstruction as ar
    from colmap_tpu_torch.scene import synthetic_images as synth

    if not torch.cuda.is_available():
        sys.exit("bench_mapping needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    report = dict(package=os.path.dirname(colmap_tpu_torch.__file__),
                  card=card)
    parts = args.parts.split(",")

    if "ba" in parts:
        res = bench_ba.run()
        report["ba"] = {k: res[k] for k in (
            "lm_iterations", "cg_steps", "solve_s", "lm_iters_per_s",
            "profiled_wall_ms", "profiled_device_ms", "top_device_ops")}
        print(f"[ba] {res['lm_iters_per_s']:.3f} LM iterations/s, solves "
              f"{res['solve_s']} s", flush=True)

    if "dslr" in parts:
        with tempfile.TemporaryDirectory(prefix="bench_mapping_") as work:
            ropts = synth.RoomDatasetOptions(
                num_images=20, width=1536, height=1152, focal=0.875 * 1536,
                seed=11, texture_res=1536)
            images, K, _, _ = synth.render_room_dataset(ropts)
            synth.write_dataset(os.path.join(work, "images"), images)
            opts = ar.AutomaticReconstructionOptions(
                workspace_path=os.path.join(work, "ws"),
                image_path=os.path.join(work, "images"),
                quality=ar.Quality.HIGH, camera_model="PINHOLE",
                single_camera=True, sparse=True,
                camera_params=",".join(map(str, [K[0, 0], K[1, 1], K[0, 2],
                                                 K[1, 2]])))
            stages = {}
            t0 = time.perf_counter()
            rec, db = ar.run_automatic_reconstruction(
                opts, stage_timings=stages, device="cuda")
            torch.cuda.synchronize()
            report["dslr"] = dict(
                wall_s=time.perf_counter() - t0,
                registered=rec.num_registered_images(),
                extraction_s=stages["extraction"],
                matching_s=stages["matching"], mapping_s=stages["mapping"],
                mapping_stages=stages["mapping_stages"],
                mapping_ba=stages["mapping_ba"])
            db.close()
        d = report["dslr"]
        print(f"[dslr] {d['registered']}/20 registered; extraction "
              f"{d['extraction_s']:.3f} s, matching {d['matching_s']:.3f} s, "
              f"mapping (cold) {d['mapping_s']:.3f} s", flush=True)

    if "hier" in parts:
        db, gt = bench_hierarchical.build_db(200, seed=3)
        report["hier"] = []
        for w in (1, 4):
            run, _ = bench_hierarchical.run_once(db, gt, w, 60, "cuda")
            run["ok"] = bench_hierarchical.gate_ok(run, 200)
            report["hier"].append(run)
            print(f"[hier] workers={w}: wall {run['wall_s']:.3f} s, mapping "
                  f"{run['timings']['mapping']:.3f} s, "
                  f"{run['num_registered']}/200 registered, max rotation "
                  f"{run['max_rotation_error_deg']} deg, gate {run['ok']}",
                  flush=True)
        db.close()
        walls = [r["wall_s"] for r in report["hier"]]
        report["hier_speedup_4_over_1"] = walls[0] / walls[1]

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(json.dumps(report, default=str), flush=True)


if __name__ == "__main__":
    main()
