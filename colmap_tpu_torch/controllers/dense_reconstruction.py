"""Dense MVS controllers: patch-match stereo, fusion, meshing over a
COLMAP-layout workspace.

Port of colmap_tpu/controllers/dense_reconstruction.py (reference entry
points: RunPatchMatchStereo exe/mvs.cc:78, RunStereoFuser :136,
RunPoissonMesher :120, RunDelaunayMesher :41). Per-reference problems with
'__auto__' source selection run one after another on `device`, or round
robin over a device mesh (`num_devices`). Workspace layout
(doc/format.rst:160-188):

    workspace/
      images/               undistorted images
      sparse/               undistorted PINHOLE model
      stereo/depth_maps/<image>.{photometric,geometric}.bin
      stereo/normal_maps/<image>.{photometric,geometric}.bin
      stereo/consistency_graphs/<image>.<input_type>.bin
      fused.ply
      meshed-poisson.ply

What an operator reads: the seconds `run_patch_match_stereo` puts in its
`timings` dict, and the Chrome trace that `util.timer.trace(log_dir)`
writes around a call, where the job's spans show as ranges:
`dense.patch_match_stereo` (the job), `dense.load_workspace` (inside:
`dense.read_model`, `dense.build_model`, `dense.read_images`), one
`dense.pass` per pass (attrs `pass` and `cards`, the shards it runs on),
per problem `dense.upload`, `dense.solve` and `dense.fetch` (each with
`card`, the rank of the shard that ran it), then `dense.write_maps`;
inside each solve the solver's own (`mvs/patch_match.py`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch
from PIL import Image as PILImage

from colmap_tpu_torch.mvs import depth_map as dm
from colmap_tpu_torch.mvs import fusion as fusion_mod
from colmap_tpu_torch.mvs import meshing as meshing_mod
from colmap_tpu_torch.mvs import model as model_mod
from colmap_tpu_torch.mvs import patch_match as pm
from colmap_tpu_torch.parallel.mesh import run_shards, shard_mesh
from colmap_tpu_torch.scene import reconstruction_io
from colmap_tpu_torch.sensor import bitmap as bitmap_mod
from colmap_tpu_torch.util import timer

logger = logging.getLogger("colmap_tpu_torch")


@dataclasses.dataclass
class PatchMatchStereoOptions:
    patch_match: pm.PatchMatchOptions = dataclasses.field(
        default_factory=pm.PatchMatchOptions)
    max_num_src_images: int = 8
    geom_consistency: bool = True  # second pass like the reference default
    max_image_size: int = -1
    # problems round robin over this many shards (0 = every local card;
    # reference: one worker thread per GPU, mvs/patch_match.cc:193-228)
    num_devices: int = 1


def _load_workspace(workspace_path: str, max_image_size: int = -1):
    """(MVS model, images by id) of the undistorted workspace, optionally
    downscaled to max_image_size (reference: Workspace options
    max_image_size, mvs/workspace.h: stereo runs at the reduced
    resolution, with the calibration scaled to match)."""
    with timer.span("dense.read_model"):
        rec = reconstruction_io.read_model(
            os.path.join(workspace_path, "sparse"))
    with timer.span("dense.build_model"):
        model = model_mod.build_model(rec)
    images = {}
    with timer.span("dense.read_images"):
        for iid, im in model.images.items():
            path = os.path.join(workspace_path, "images", im.name)
            data = bitmap_mod.read_bitmap(path).data
            if max_image_size > 0 and max(data.shape[:2]) > max_image_size:
                s = max_image_size / max(data.shape[:2])
                nh = max(int(round(data.shape[0] * s)), 1)
                nw = max(int(round(data.shape[1] * s)), 1)
                data = np.asarray(PILImage.fromarray(
                    (data * 255).astype(np.uint8)).resize(
                        (nw, nh), PILImage.BILINEAR), np.float32) / 255.0
                # continuous pixel coords scale exactly: K' = diag(sx, sy, 1) K
                sy, sx = nh / im.height, nw / im.width
                im.K = np.diag([sx, sy, 1.0]) @ im.K
                im.width, im.height = nw, nh
            images[iid] = data
    return model, images


def _suffix_path(workspace_path: str, kind: str, name: str, suffix: str) -> str:
    return os.path.join(workspace_path, "stereo", kind, f"{name}.{suffix}.bin")


def run_patch_match_stereo(workspace_path: str,
                           options: PatchMatchStereoOptions = PatchMatchStereoOptions(),
                           seed: int = 0, device="cuda",
                           timings: Optional[dict] = None
                           ) -> Dict[int, np.ndarray]:
    """Compute photometric (+ geometric) depth/normal maps for all images.

    The draws come from one torch.Generator on `device` seeded with
    `seed`. With `options.num_devices` > 1 (0 = every local card) the
    problems go round robin over a mesh of that many shards, at most one
    per card present on `cuda` (problem k of the sorted images to shard k
    mod n, as the JAX package spreads them over its devices), each shard
    on its own thread with a generator seeded seed + rank. `timings`, when
    a dict, gets the job's seconds from its spans: each pass
    ("photometric", "geometric"), the workspace load ("load") and the map
    writes ("write"), and the number of maps per pass ("maps")."""
    with timer.span("dense.patch_match_stereo"):
        return _patch_match_stereo(workspace_path, options, seed, device,
                                   {} if timings is None else timings)


def _patch_match_stereo(workspace_path: str, options: PatchMatchStereoOptions,
                        seed: int, device, spent: dict
                        ) -> Dict[int, np.ndarray]:
    mesh = shard_mesh(options.num_devices, device)
    with timer.span("dense.load_workspace") as load:
        model, images = _load_workspace(workspace_path,
                                        options.max_image_size)
    spent["load"] = load.seconds
    devices = mesh.devices if mesh is not None else (device,)
    generators = []
    for k, dev in enumerate(devices):
        generators.append(torch.Generator(device=dev))
        generators[-1].manual_seed(seed + k)
    order = sorted(model.images.items())

    def solve_part(geom: bool, prior: Dict[int, np.ndarray], rank: int):
        """The problems of shard `rank` on its device."""
        dev, generator = devices[rank], generators[rank]
        on_card = torch.device(dev).type == "cuda"
        kind = "geometric" if geom else "photometric"
        depths, normals = {}, {}
        po = dataclasses.replace(options.patch_match, geom_consistency=geom)

        def put(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                   device=dev)

        for ref_id, im in order[rank::len(devices)]:
            with timer.span("dense.upload", image_id=ref_id, card=rank):
                srcs = model.src_images(ref_id, options.max_num_src_images)
                if not srcs:
                    logger.warning("image %d has no source images", ref_id)
                    continue
                dmin, dmax = model.depth_ranges[ref_id]
                R_ref, t_ref = im.R, im.t
                R_rel = np.stack([model.images[s].R @ R_ref.T for s in srcs])
                t_rel = np.stack([model.images[s].t - R_rel[i] @ t_ref
                                  for i, s in enumerate(srcs)])
                src_depths = None
                if geom:
                    src_depths = put(np.stack(
                        [prior.get(s, np.zeros_like(images[s]))
                         for s in srcs]))
                problem = pm.PatchMatchProblem(
                    ref_image=put(images[ref_id]),
                    src_images=put(np.stack([images[s] for s in srcs])),
                    K_ref=put(im.K),
                    K_src=put(np.stack([model.images[s].K for s in srcs])),
                    R_rel=put(R_rel),
                    t_rel=put(t_rel),
                    depth_min=put(np.float32(dmin)),
                    depth_max=put(np.float32(dmax)),
                    src_depths=src_depths,
                )
                draws = pm.GeneratorDraws(generator, images[ref_id].shape)
            with timer.span("dense.solve", image_id=ref_id, card=rank,
                            sources=len(srcs), **{"pass": kind}):
                depth, normal, _ = pm.patch_match(draws, problem, po)
                if on_card:
                    torch.cuda.synchronize(dev)
            with timer.span("dense.fetch", image_id=ref_id, card=rank):
                depths[ref_id] = depth.cpu().numpy()
                normals[ref_id] = normal.cpu().numpy()
                logger.info("patch-match %s (%s): %.0f%% estimated",
                            im.name, "geom" if geom else "photo",
                            100.0 * float((depths[ref_id] > 0).mean()))
        return depths, normals

    def solve_all(geom: bool, prior: Dict[int, np.ndarray]):
        kind = "geometric" if geom else "photometric"
        with timer.span("dense.pass", cards=len(devices),
                        **{"pass": kind}) as p:
            if mesh is None:
                depths, normals = solve_part(geom, prior, 0)
            else:
                depths, normals = {}, {}
                for d, nm in run_shards(
                        mesh, lambda g: solve_part(geom, prior, g.rank)):
                    depths.update(d)
                    normals.update(nm)
        spent[kind] = p.seconds
        return depths, normals

    depths, normals = solve_all(False, {})
    spent["maps"] = len(depths)
    if options.geom_consistency:
        depths, normals = solve_all(True, depths)

    suffix = "geometric" if options.geom_consistency else "photometric"
    with timer.span("dense.write_maps") as write:
        for ref_id, im in model.images.items():
            if ref_id not in depths:
                continue
            dm.DepthMap(depths[ref_id]).write(
                _suffix_path(workspace_path, "depth_maps", im.name, suffix))
            dm.NormalMap(normals[ref_id]).write(
                _suffix_path(workspace_path, "normal_maps", im.name, suffix))
    spent["write"] = write.seconds
    return depths


def run_stereo_fusion(workspace_path: str,
                      options: fusion_mod.StereoFusionOptions = fusion_mod.StereoFusionOptions(),
                      input_type: str = "geometric",
                      output_path: Optional[str] = None,
                      max_image_size: int = -1,
                      device="cuda") -> Dict[str, np.ndarray]:
    """Fuse depth/normal maps into fused.ply (reference: RunStereoFuser).

    max_image_size must match the stereo run so the scaled calibration
    lines up with the stored depth-map resolution."""
    model, images = _load_workspace(workspace_path, max_image_size)
    depths, normals = {}, {}
    for iid, im in model.images.items():
        p = _suffix_path(workspace_path, "depth_maps", im.name, input_type)
        if not os.path.exists(p):
            p = _suffix_path(workspace_path, "depth_maps", im.name, "photometric")
        if not os.path.exists(p):
            continue
        depths[iid] = dm.DepthMap.read(p).data
        normals[iid] = dm.NormalMap.read(
            p.replace("depth_maps", "normal_maps")).data
    graphs: Dict[int, fusion_mod.ConsistencyGraph] = {}
    cloud = fusion_mod.fuse(model, depths, normals, images, options,
                            consistency_out=graphs, device=device)
    cg_dir = os.path.join(workspace_path, "stereo", "consistency_graphs")
    os.makedirs(cg_dir, exist_ok=True)
    for iid, g in graphs.items():
        name = model.images[iid].name
        os.makedirs(os.path.dirname(os.path.join(cg_dir, name)) or cg_dir,
                    exist_ok=True)
        g.write(os.path.join(cg_dir, f"{name}.{input_type}.bin"))
    out = output_path or os.path.join(workspace_path, "fused.ply")
    fusion_mod.write_ply(out, cloud["xyz"], cloud["normal"], cloud["color"])
    logger.info("fused %d points -> %s", len(cloud["xyz"]), out)
    return cloud


def run_poisson_mesher(input_ply: str, output_ply: str,
                       options: meshing_mod.PoissonMeshingOptions = meshing_mod.PoissonMeshingOptions(),
                       device="cuda"):
    """reference: RunPoissonMesher (exe/mvs.cc:120)."""
    cloud = fusion_mod.read_ply(input_ply)
    verts, faces = meshing_mod.poisson_mesh(
        cloud["xyz"], cloud.get("normal", np.zeros_like(cloud["xyz"])),
        options, device=device)
    meshing_mod.write_mesh_ply(output_ply, verts, faces)
    logger.info("meshed %d vertices / %d faces -> %s",
                len(verts), len(faces), output_ply)
    return verts, faces


def run_delaunay_mesher(workspace_path: str, output_ply: str,
                        input_ply: Optional[str] = None):
    """reference: RunDelaunayMesher (exe/mvs.cc:41), dense variant; host
    scipy."""
    cloud = fusion_mod.read_ply(
        input_ply or os.path.join(workspace_path, "fused.ply"))
    rec = reconstruction_io.read_model(os.path.join(workspace_path, "sparse"))
    model = model_mod.build_model(rec)
    centers = np.stack([im.center() for im in model.images.values()])
    # subsample for the tetrahedralization
    xyz = cloud["xyz"]
    if len(xyz) > 20000:
        sel = np.random.default_rng(0).choice(len(xyz), 20000, replace=False)
        xyz = xyz[sel]
    verts, faces = meshing_mod.delaunay_mesh(xyz, centers)
    meshing_mod.write_mesh_ply(output_ply, verts, faces)
    return verts, faces
