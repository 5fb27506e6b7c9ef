"""`colmap`-compatible command-line interface.

Port of colmap_tpu/cli.py (reference: src/colmap/exe/colmap.cc:76-121):
the JAX package's 43 subcommands with the same handlers, arguments and
defaults (`gui` exits as the JAX package's does). Every subcommand also takes
`--device` (default `cuda`): device work runs there, and `--device cpu`
runs it on the CPU. Run as

    python -m colmap_tpu_torch <command> [options]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np


def _setup_logging():
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname).1s %(message)s")


def _om_parser(prog):
    from colmap_tpu_torch.controllers.option_manager import OptionManager

    om = OptionManager()
    parser = argparse.ArgumentParser(prog=prog)
    om.add_all_args(parser)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the device work (cuda, cpu)")
    return om, parser


def _open_db(om):
    from colmap_tpu_torch.scene.database import Database

    if not om.database_path:
        raise SystemExit("--database_path is required")
    return Database(om.database_path)


def _read_model(path):
    from colmap_tpu_torch.scene import reconstruction_io

    return reconstruction_io.read_model(path)


def _write_model(rec, path, ext=".bin"):
    from colmap_tpu_torch.scene import reconstruction_io

    os.makedirs(path, exist_ok=True)
    reconstruction_io.write_model(rec, path, ext=ext)


# ---------------------------------------------------------------------------
# command handlers
# ---------------------------------------------------------------------------


def run_feature_extractor(argv):
    om, parser = _om_parser("feature_extractor")
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.controllers import feature_extraction as fe

    db = _open_db(om)
    fe.run_feature_extraction(db, om.image_path, om.ImageReader,
                              om.SiftExtraction, device=args.device)
    return 0


def run_feature_importer(argv):
    om, parser = _om_parser("feature_importer")
    parser.add_argument("--import_path", required=True)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.tools import database_tools

    database_tools.import_features(_open_db(om), om.image_path,
                                   args.import_path,
                                   camera_model=om.ImageReader.camera_model,
                                   camera_params=om.ImageReader.camera_params)
    return 0


def _run_matcher(argv, strategy):
    om, parser = _om_parser(strategy)
    parser.add_argument("--vocab_tree_path", default=None)
    parser.add_argument("--match_list_path", default=None)
    parser.add_argument("--num_neighbors", type=int, default=5)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.controllers import feature_matching as fm

    db = _open_db(om)
    opts = om.FeatureMatching
    dev = args.device
    if strategy == "exhaustive_matcher":
        stats = fm.match_exhaustive(db, opts, device=dev)
    elif strategy == "sequential_matcher":
        seq = om.SequentialMatching
        if args.vocab_tree_path and not seq.vocab_tree_path:
            seq = dataclasses.replace(seq, vocab_tree_path=args.vocab_tree_path)
        stats = fm.match_sequential(db, opts, pairing=seq, device=dev)
    elif strategy == "spatial_matcher":
        stats = fm.match_spatial(db, opts, device=dev)
    elif strategy == "transitive_matcher":
        stats = fm.match_transitive(db, opts, device=dev)
    elif strategy == "vocab_tree_matcher":
        stats = fm.match_vocab_tree(db, opts, args.vocab_tree_path,
                                    args.num_neighbors, device=dev)
    elif strategy == "matches_importer":
        from colmap_tpu_torch.tools import database_tools

        database_tools.import_matches(db, args.match_list_path, device=dev)
        return 0
    logging.getLogger("colmap_tpu_torch").info(
        "matched %d pairs, verified %d", stats.num_matched_pairs,
        stats.num_verified_pairs)
    return 0


def run_mapper(argv):
    om, parser = _om_parser("mapper")
    # parsed and not read, as in the JAX package (ROADMAP queue 3)
    parser.add_argument("--input_path", default=None)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.controllers.incremental_pipeline import IncrementalPipeline

    db = _open_db(om)
    pipeline = IncrementalPipeline(db, om.Mapper, device=args.device)
    rec = pipeline.run()
    if rec is None:
        raise SystemExit("mapping failed")
    out = os.path.join(args.output_path, "0")
    _write_model(rec, out)
    return 0


def run_hierarchical_mapper(argv):
    om, parser = _om_parser("hierarchical_mapper")
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--leaf_max_num_images", type=int, default=500)
    parser.add_argument("--image_overlap", type=int, default=50)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.controllers.hierarchical_pipeline import (
        HierarchicalPipeline, HierarchicalPipelineOptions)

    opts = HierarchicalPipelineOptions(incremental=om.Mapper)
    opts.clustering.leaf_max_num_images = args.leaf_max_num_images
    opts.clustering.image_overlap = args.image_overlap
    rec = HierarchicalPipeline(_open_db(om), opts, device=args.device).run()
    if rec is None:
        raise SystemExit("mapping failed")
    _write_model(rec, os.path.join(args.output_path, "0"))
    return 0


def run_automatic_reconstructor(argv):
    om, parser = _om_parser("automatic_reconstructor")
    parser.add_argument("--workspace_path", required=True)
    parser.add_argument("--quality", default="high",
                        choices=["low", "medium", "high", "extreme"])
    parser.add_argument("--data_type", default="individual",
                        choices=["individual", "video", "internet"])
    parser.add_argument("--dense", type=int, default=0)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.controllers.automatic_reconstruction import (
        AutomaticReconstructionOptions, DataType, Quality,
        run_automatic_reconstruction)

    opts = AutomaticReconstructionOptions(
        workspace_path=args.workspace_path,
        image_path=om.image_path or os.path.join(args.workspace_path, "images"),
        quality=Quality(args.quality),
        data_type=DataType(args.data_type),
        camera_model=om.ImageReader.camera_model,
        single_camera=om.ImageReader.single_camera,
        camera_params=om.ImageReader.camera_params,
        dense=bool(args.dense))
    rec, _ = run_automatic_reconstruction(opts, om.Mapper,
                                          device=args.device)
    return 0 if rec is not None else 1


def run_point_triangulator(argv):
    om, parser = _om_parser("point_triangulator")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.tools import sfm_tools

    rec = sfm_tools.triangulate_points(_open_db(om),
                                       _read_model(args.input_path),
                                       device=args.device)
    _write_model(rec, args.output_path)
    return 0


def run_pose_prior_mapper(argv):
    om, parser = _om_parser("pose_prior_mapper")
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.tools import sfm_tools

    rec = sfm_tools.run_pose_prior_mapper(_open_db(om), om.Mapper,
                                          device=args.device)
    if rec is None:
        raise SystemExit("mapping failed")
    _write_model(rec, os.path.join(args.output_path, "0"))
    return 0


def run_image_registrator(argv):
    om, parser = _om_parser("image_registrator")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.tools import sfm_tools

    rec = sfm_tools.register_images(_open_db(om),
                                    _read_model(args.input_path),
                                    device=args.device)
    _write_model(rec, args.output_path)
    return 0


def run_point_filtering(argv):
    om, parser = _om_parser("point_filtering")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--max_reproj_error", type=float, default=4.0)
    parser.add_argument("--min_tri_angle", type=float, default=1.5)
    args = parser.parse_args(argv)
    from colmap_tpu_torch.tools import sfm_tools

    rec = _read_model(args.input_path)
    n = sfm_tools.filter_points(rec, args.max_reproj_error, args.min_tri_angle,
                                device=args.device)
    logging.getLogger("colmap_tpu_torch").info("filtered %d points", n)
    _write_model(rec, args.output_path)
    return 0


def run_color_extractor(argv):
    om, parser = _om_parser("color_extractor")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.tools import sfm_tools

    rec = _read_model(args.input_path)
    sfm_tools.extract_colors(rec, om.image_path)
    _write_model(rec, args.output_path)
    return 0


def run_bundle_adjuster(argv):
    om, parser = _om_parser("bundle_adjuster")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--BundleAdjustment.max_num_iterations", type=int,
                        default=100, dest="ba_iters")
    parser.add_argument("--BundleAdjustment.refine_focal_length", type=int,
                        default=1, dest="refine_focal")
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.tools import sfm_tools

    db = _open_db(om)
    rec = _read_model(args.input_path)
    mapper = sfm_tools._mapper_with_poses(db, rec, om.Mapper.mapper, 0,
                                          args.device)
    from colmap_tpu_torch.estimators import bundle_adjustment as ba

    # the model's own camera model (the JAX package's BAOptions default
    # projects SIMPLE_RADIAL whatever the model)
    cam0 = rec.cameras[min(rec.cameras)]
    mapper.adjust_global_bundle(
        refine_intrinsics=bool(args.refine_focal),
        ba_options=ba.BAOptions(max_iterations=min(args.ba_iters, 50),
                                camera_model_id=int(cam0.model_id)))
    _write_model(mapper.finalize(), args.output_path)
    return 0


def run_rig_bundle_adjuster(argv):
    """reference: RunRigBundleAdjuster (exe/sfm.cc) with COLMAP's
    rig_config.json format: [{"ref_camera_id": N, "cameras":
    [{"camera_id": i, "image_prefix": "...", "cam_from_rig_rotation":
    [w,x,y,z], "cam_from_rig_translation": [x,y,z]}, ...]}]."""
    om, parser = _om_parser("rig_bundle_adjuster")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--rig_config_path", required=True)
    parser.add_argument("--RigBundleAdjustment.refine_relative_poses",
                        type=int, default=1, dest="refine_rel")
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.tools.rig_tools import run_rig_bundle_adjustment

    rec = _read_model(args.input_path)
    rec = run_rig_bundle_adjustment(
        rec, args.rig_config_path,
        refine_relative_poses=bool(args.refine_rel), device=args.device)
    _write_model(rec, args.output_path)
    return 0


def run_image_undistorter(argv):
    om, parser = _om_parser("image_undistorter")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--output_type", default="COLMAP",
                        choices=["COLMAP", "PMVS", "CMP-MVS"])
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.image import undistortion as und

    rec = _read_model(args.input_path)
    if args.output_type == "PMVS":
        und.run_pmvs_undistorter(rec, om.image_path, args.output_path,
                                 om.UndistortCamera, device=args.device)
    elif args.output_type == "CMP-MVS":
        und.run_cmp_mvs_undistorter(rec, om.image_path, args.output_path,
                                    om.UndistortCamera, device=args.device)
    else:
        und.run_undistorter(rec, om.image_path, args.output_path,
                            om.UndistortCamera, device=args.device)
    return 0


def run_image_undistorter_standalone(argv):
    om, parser = _om_parser("image_undistorter_standalone")
    parser.add_argument("--input_file", required=True)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.image import undistortion as und
    from colmap_tpu_torch.scene.reconstruction import Camera
    from colmap_tpu_torch.sensor import bitmap as bitmap_mod
    from colmap_tpu_torch.sensor import models as cm

    os.makedirs(args.output_path, exist_ok=True)
    with open(args.input_file) as fp:
        for line in fp:
            parts = line.split()
            if not parts:
                continue
            name, model = parts[0], parts[1]
            params = np.array([float(v) for v in parts[4:]])
            cam = Camera(camera_id=1,
                         model_id=int(cm.MODEL_IDS_BY_NAME[model]),
                         width=int(parts[2]), height=int(parts[3]),
                         params=params)
            bmp = bitmap_mod.read_bitmap(os.path.join(om.image_path, name))
            out, _ = und.undistort_image(om.UndistortCamera, bmp.data, cam,
                                         device=args.device)
            bitmap_mod.write_bitmap(os.path.join(args.output_path, name), out)
    return 0


def run_image_rectifier(argv):
    """reference: RunImageRectifier (exe/image.cc) — rectify the stereo
    pairs listed in --stereo_pairs_list ('name1 name2' per line)."""
    om, parser = _om_parser("image_rectifier")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--stereo_pairs_list", required=True)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.image.rectification import rectify_images
    from colmap_tpu_torch.sensor import bitmap as bitmap_mod

    rec = _read_model(args.input_path)
    by_name = {im.name: im for im in rec.images.values()}
    os.makedirs(args.output_path, exist_ok=True)
    for line in open(args.stereo_pairs_list):
        parts = line.split()
        if len(parts) != 2:
            continue
        im1, im2 = by_name[parts[0]], by_name[parts[1]]
        cam1 = rec.cameras[im1.camera_id]
        cam2 = rec.cameras[im2.camera_id]

        def K_of(cam):
            fx, fy, cx, cy = cam.params[:4]
            return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

        b1 = bitmap_mod.read_bitmap(os.path.join(om.image_path, im1.name))
        b2 = bitmap_mod.read_bitmap(os.path.join(om.image_path, im2.name))
        o1, o2, info = rectify_images(b1.data, b2.data, K_of(cam1),
                                      K_of(cam2), im1.cam_from_world,
                                      im2.cam_from_world, device=args.device)
        stem1 = os.path.splitext(os.path.basename(im1.name))[0]
        stem2 = os.path.splitext(os.path.basename(im2.name))[0]
        bitmap_mod.write_bitmap(
            os.path.join(args.output_path, f"{stem1}-{stem2}_left.png"), o1)
        bitmap_mod.write_bitmap(
            os.path.join(args.output_path, f"{stem1}-{stem2}_right.png"), o2)
    return 0


def run_image_deleter(argv):
    om, parser = _om_parser("image_deleter")
    parser.add_argument("--image_ids_path", default=None)
    parser.add_argument("--image_ids", default=None)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.tools import database_tools

    ids: List[int] = []
    if args.image_ids:
        ids = [int(v) for v in args.image_ids.split(",")]
    elif args.image_ids_path:
        ids = [int(l) for l in open(args.image_ids_path) if l.strip()]
    database_tools.delete_images(_open_db(om), ids)
    return 0


def run_image_filterer(argv):
    om, parser = _om_parser("image_filterer")
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.tools import database_tools

    removed = database_tools.filter_images(_open_db(om))
    logging.getLogger("colmap_tpu_torch").info("removed %d images", len(removed))
    return 0


def run_patch_match_stereo(argv):
    om, parser = _om_parser("patch_match_stereo")
    parser.add_argument("--workspace_path", required=True)
    parser.add_argument("--num_devices", type=int, default=1,
                        help="round-robin problems over this many local "
                             "devices (0 = all; reference: comma GPU "
                             "lists, mvs/patch_match.cc:193-228)")
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.controllers import dense_reconstruction as dense
    from colmap_tpu_torch.parallel.mesh import resolve_num_devices

    num_devices = resolve_num_devices(args.num_devices, args.device)
    dense.run_patch_match_stereo(
        args.workspace_path,
        dense.PatchMatchStereoOptions(patch_match=om.PatchMatchStereo,
                                      num_devices=num_devices),
        device=args.device)
    return 0


def run_stereo_fusion(argv):
    om, parser = _om_parser("stereo_fusion")
    parser.add_argument("--workspace_path", required=True)
    parser.add_argument("--output_path", default=None)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.controllers import dense_reconstruction as dense

    dense.run_stereo_fusion(args.workspace_path, om.StereoFusion,
                            output_path=args.output_path, device=args.device)
    return 0


def run_poisson_mesher(argv):
    om, parser = _om_parser("poisson_mesher")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.controllers import dense_reconstruction as dense

    dense.run_poisson_mesher(args.input_path, args.output_path,
                             om.PoissonMeshing, device=args.device)
    return 0


def run_delaunay_mesher(argv):
    om, parser = _om_parser("delaunay_mesher")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.controllers import dense_reconstruction as dense

    dense.run_delaunay_mesher(args.input_path, args.output_path)
    return 0


def run_model_aligner(argv):
    om, parser = _om_parser("model_aligner")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--ref_images_path", default=None)
    parser.add_argument("--alignment_max_error", type=float, default=0.1)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.tools import model_tools

    rec = _read_model(args.input_path)
    positions: Dict[str, np.ndarray] = {}
    if args.ref_images_path:
        for line in open(args.ref_images_path):
            parts = line.split()
            if len(parts) >= 4:
                positions[parts[0]] = np.array([float(v) for v in parts[1:4]])
    aligned = model_tools.align_model_to_positions(
        rec, positions, max_error=args.alignment_max_error,
        device=args.device)
    if aligned is None:
        raise SystemExit("alignment failed")
    _write_model(aligned, args.output_path)
    return 0


def run_model_analyzer(argv):
    om, parser = _om_parser("model_analyzer")
    parser.add_argument("--path", required=True)
    args = parser.parse_args(argv)
    from colmap_tpu_torch.tools import model_tools

    stats = model_tools.analyze_model(_read_model(args.path))
    print(json.dumps(stats, indent=2))
    return 0


def run_model_comparer(argv):
    om, parser = _om_parser("model_comparer")
    parser.add_argument("--input_path1", required=True)
    parser.add_argument("--input_path2", required=True)
    args = parser.parse_args(argv)
    from colmap_tpu_torch.tools import model_tools

    cmp = model_tools.compare_models(_read_model(args.input_path1),
                                     _read_model(args.input_path2),
                                     device=args.device)
    if cmp is None:
        raise SystemExit("comparison failed (no common images)")
    print(json.dumps({
        "max_rotation_error_deg": cmp["max_rotation_error_deg"],
        "max_proj_center_error": cmp["max_center_error"],
        "num_common_images": len(cmp["common_images"]),
    }, indent=2))
    return 0


def run_model_converter(argv):
    om, parser = _om_parser("model_converter")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--output_type", required=True)
    args = parser.parse_args(argv)
    from colmap_tpu_torch.tools import model_tools

    model_tools.convert_model(_read_model(args.input_path), args.output_path,
                              args.output_type)
    return 0


def run_model_cropper(argv):
    om, parser = _om_parser("model_cropper")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--boundary", required=True,
                        help="x1,y1,z1,x2,y2,z2")
    args = parser.parse_args(argv)
    from colmap_tpu_torch.tools import model_tools

    v = [float(x) for x in args.boundary.split(",")]
    rec = model_tools.crop_model(_read_model(args.input_path), v[:3], v[3:])
    _write_model(rec, args.output_path)
    return 0


def run_model_merger(argv):
    om, parser = _om_parser("model_merger")
    parser.add_argument("--input_path1", required=True)
    parser.add_argument("--input_path2", required=True)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    from colmap_tpu_torch.tools import model_tools

    merged = model_tools.merge_models(_read_model(args.input_path1),
                                      _read_model(args.input_path2),
                                      device=args.device)
    if merged is None:
        raise SystemExit("merging failed")
    _write_model(merged, args.output_path)
    return 0


def run_model_orientation_aligner(argv):
    om, parser = _om_parser("model_orientation_aligner")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    from colmap_tpu_torch.tools import model_tools

    _write_model(model_tools.align_model_orientation(
        _read_model(args.input_path)), args.output_path)
    return 0


def run_model_splitter(argv):
    om, parser = _om_parser("model_splitter")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--split_type", default="parts")
    parser.add_argument("--split_params", required=True)
    args = parser.parse_args(argv)
    from colmap_tpu_torch.tools import model_tools

    parts = [int(v) for v in args.split_params.split(",")]
    subs = model_tools.split_model(_read_model(args.input_path),
                                   tuple(parts + [1] * (3 - len(parts))))
    for i, sub in enumerate(subs):
        _write_model(sub, os.path.join(args.output_path, str(i)))
    return 0


def run_model_transformer(argv):
    om, parser = _om_parser("model_transformer")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--transform", required=True,
                        help="scale,qw,qx,qy,qz,tx,ty,tz")
    args = parser.parse_args(argv)
    from colmap_tpu_torch.tools import model_tools

    t = np.array([float(v) for v in args.transform.split(",")])
    _write_model(model_tools.transform_model(_read_model(args.input_path), t),
                 args.output_path)
    return 0


def run_database_creator(argv):
    om, parser = _om_parser("database_creator")
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.tools import database_tools

    database_tools.create_database(om.database_path)
    return 0


def run_database_cleaner(argv):
    om, parser = _om_parser("database_cleaner")
    parser.add_argument("--type", default="all",
                        choices=["all", "images", "features", "matches"])
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.tools import database_tools

    database_tools.clean_database(_open_db(om), args.type)
    return 0


def run_database_merger(argv):
    om, parser = _om_parser("database_merger")
    parser.add_argument("--database_path1", required=True)
    parser.add_argument("--database_path2", required=True)
    parser.add_argument("--merged_database_path", required=True)
    args = parser.parse_args(argv)
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.tools import database_tools

    database_tools.merge_databases(Database(args.database_path1),
                                   Database(args.database_path2),
                                   Database(args.merged_database_path))
    return 0


def run_project_generator(argv):
    om, parser = _om_parser("project_generator")
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    om.parse_args(args)
    om.write(args.output_path)
    return 0


def run_vocab_tree_builder(argv):
    om, parser = _om_parser("vocab_tree_builder")
    parser.add_argument("--vocab_tree_path", required=True)
    parser.add_argument("--num_visual_words", type=int, default=4096)
    parser.add_argument("--branching", type=int, default=16)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.retrieval import visual_index as vi_mod

    depth = max(1, int(round(np.log(args.num_visual_words)
                             / np.log(args.branching))))
    vi = vi_mod.build_vocab_tree_from_database(
        _open_db(om), vi_mod.VisualIndexOptions(branching=args.branching,
                                                depth=depth),
        device=args.device)
    vi.save(args.vocab_tree_path)
    return 0


def run_vocab_tree_retriever(argv):
    om, parser = _om_parser("vocab_tree_retriever")
    parser.add_argument("--vocab_tree_path", required=True)
    parser.add_argument("--num_neighbors", type=int, default=5)
    args = parser.parse_args(argv)
    om.parse_args(args)
    from colmap_tpu_torch.retrieval import visual_index as vi_mod

    db = _open_db(om)
    vi = vi_mod.VisualIndex.load(args.vocab_tree_path, device=args.device)
    ids = sorted(db.read_images().keys())
    for iid in ids:
        d = db.read_descriptors(iid)
        if d is not None and len(d):
            vi.add_image(iid, d)
    for iid in ids:
        d = db.read_descriptors(iid)
        if d is None or len(d) == 0:
            continue
        res = vi.query(d, args.num_neighbors, exclude=iid)
        print(iid, " ".join(f"{i}:{s:.3f}" for i, s in res))
    return 0


def run_gui(argv):
    raise SystemExit(
        "gui: the Qt GUI of the reference is replaced by model exports — "
        "use `model_converter --output_type PLY` and any point-cloud viewer")


COMMANDS: Dict[str, Callable] = {
    "gui": run_gui,
    "automatic_reconstructor": run_automatic_reconstructor,
    "bundle_adjuster": run_bundle_adjuster,
    "color_extractor": run_color_extractor,
    "database_cleaner": run_database_cleaner,
    "database_creator": run_database_creator,
    "database_merger": run_database_merger,
    "delaunay_mesher": run_delaunay_mesher,
    "exhaustive_matcher": lambda a: _run_matcher(a, "exhaustive_matcher"),
    "feature_extractor": run_feature_extractor,
    "feature_importer": run_feature_importer,
    "hierarchical_mapper": run_hierarchical_mapper,
    "image_deleter": run_image_deleter,
    "image_filterer": run_image_filterer,
    "image_rectifier": run_image_rectifier,
    "image_registrator": run_image_registrator,
    "image_undistorter": run_image_undistorter,
    "image_undistorter_standalone": run_image_undistorter_standalone,
    "mapper": run_mapper,
    "matches_importer": lambda a: _run_matcher(a, "matches_importer"),
    "model_aligner": run_model_aligner,
    "model_analyzer": run_model_analyzer,
    "model_comparer": run_model_comparer,
    "model_converter": run_model_converter,
    "model_cropper": run_model_cropper,
    "model_merger": run_model_merger,
    "model_orientation_aligner": run_model_orientation_aligner,
    "model_splitter": run_model_splitter,
    "model_transformer": run_model_transformer,
    "patch_match_stereo": run_patch_match_stereo,
    "point_filtering": run_point_filtering,
    "point_triangulator": run_point_triangulator,
    "pose_prior_mapper": run_pose_prior_mapper,
    "poisson_mesher": run_poisson_mesher,
    "project_generator": run_project_generator,
    "rig_bundle_adjuster": run_rig_bundle_adjuster,
    "sequential_matcher": lambda a: _run_matcher(a, "sequential_matcher"),
    "spatial_matcher": lambda a: _run_matcher(a, "spatial_matcher"),
    "stereo_fusion": run_stereo_fusion,
    "transitive_matcher": lambda a: _run_matcher(a, "transitive_matcher"),
    "vocab_tree_builder": run_vocab_tree_builder,
    "vocab_tree_matcher": lambda a: _run_matcher(a, "vocab_tree_matcher"),
    "vocab_tree_retriever": run_vocab_tree_retriever,
}


def main(argv: Optional[List[str]] = None) -> int:
    _setup_logging()
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("colmap_tpu_torch — COLMAP on PyTorch and CUDA. Commands:")
        for name in sorted(COMMANDS):
            print(f"  {name}")
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command '{cmd}'", file=sys.stderr)
        return 1
    return COMMANDS[cmd](argv[1:]) or 0


if __name__ == "__main__":
    raise SystemExit(main())
