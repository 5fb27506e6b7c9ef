"""Multi-view depth/normal fusion into a dense point cloud.

Port of colmap_tpu/mvs/fusion.py (reference: src/colmap/mvs/fusion.h:53-153,
StereoFusion::Run :145, Fuse :377-530). As in the JAX module, the
reference's per-pixel BFS becomes dense consistency checks: for one
reference image every pixel is projected into all its source views at once
(bilinear depth lookups, relative depth, normal angle and visited gates,
torch ops on `device`), and the fused point is the mean over the consistent
support set. Marking the consumed source pixels stays a host visited mask
updated per reference image. PLY IO is the JAX module's, byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from colmap_tpu_torch.mvs.consistency_graph import ConsistencyGraph

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class StereoFusionOptions:
    """Mirrors StereoFusionOptions (reference: mvs/fusion.h:53)."""

    max_reproj_error: float = 2.0
    max_depth_error: float = 0.01  # relative
    max_normal_error_deg: float = 10.0
    min_num_pixels: int = 3  # fused track size incl. the reference pixel
    max_num_images: int = 20  # sources checked per reference


def _mat3_rows(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """X @ M for points X [..., 3] and a 3x3 M, elementwise."""
    return torch.stack([X[..., 0] * M[0, c] + X[..., 1] * M[1, c]
                        + X[..., 2] * M[2, c] for c in range(3)], -1)


@torch.no_grad()
def _fuse_one(ref_depth, ref_normal, K_ref, R_ref, t_ref,
              src_depths, src_normals, K_src, R_src, t_src,
              src_visited, max_rel_depth, min_cos):
    """Consistency + fusion for one reference image against S sources.

    All rotations/translations are world->cam. Returns per pixel:
      xyz_mean [H,W,3] (world), normal_mean, count [H,W],
      proj coords into each src [S,H,W,2], consistent [S,H,W].
    """
    h, w = ref_depth.shape
    dev = ref_depth.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    Kinv = torch.linalg.inv(K_ref)
    pix = torch.stack([xs.to(_F32) + 0.5, ys.to(_F32) + 0.5,
                       torch.ones((h, w), dtype=_F32, device=dev)], -1)
    rays = _mat3_rows(pix, Kinv.T)
    Xc = ref_depth[..., None] * rays  # ref cam frame
    Xw = _mat3_rows(Xc - t_ref, R_ref)  # world: R^T (Xc - t)
    n_w = _mat3_rows(ref_normal, R_ref)  # normal to world

    oks, Xw_hats, n_hats, projs = [], [], [], []
    for sd, sn, Ks, Rs, ts, visited in zip(src_depths, src_normals, K_src,
                                           R_src, t_src, src_visited):
        Xs = _mat3_rows(Xw, Rs.T) + ts  # src cam frame
        z = Xs[..., 2]
        p = _mat3_rows(Xs, Ks.T)
        pz = torch.where(torch.abs(p[..., 2]) < 1e-9,
                         torch.full_like(z, 1e-9), p[..., 2])
        sx = p[..., 0] / pz
        sy = p[..., 1] / pz
        # bilinear depth sample over the valid (> 0) taps
        hs, ws_ = sd.shape
        x0 = torch.floor(sx - 0.5).to(torch.int64)
        y0 = torch.floor(sy - 0.5).to(torch.int64)
        fx = sx - 0.5 - x0
        fy = sy - 0.5 - y0
        inb = (sx >= 0.5) & (sx <= ws_ - 0.5) & (sy >= 0.5) & (sy <= hs - 0.5)
        flat = sd.reshape(-1)
        zero = torch.zeros((), dtype=_F32, device=dev)

        def tap(yi, xi, wgt):
            v = flat.take(yi.clamp(0, hs - 1) * ws_ + xi.clamp(0, ws_ - 1))
            return (torch.where(v > 0, v * wgt, zero),
                    torch.where(v > 0, wgt, zero))

        v00, w00 = tap(y0, x0, (1 - fy) * (1 - fx))
        v01, w01 = tap(y0, x0 + 1, (1 - fy) * fx)
        v10, w10 = tap(y0 + 1, x0, fy * (1 - fx))
        v11, w11 = tap(y0 + 1, x0 + 1, fy * fx)
        wsum = w00 + w01 + w10 + w11
        d_s = torch.where(wsum > 0.5, (v00 + v01 + v10 + v11)
                          / torch.clamp(wsum, min=1e-9), zero)

        # nearest-pixel normal + visited lookup
        xi = torch.round(sx - 0.5).to(torch.int64).clamp(0, ws_ - 1)
        yi = torch.round(sy - 0.5).to(torch.int64).clamp(0, hs - 1)
        n_s_w = _mat3_rows(sn.reshape(-1, 3)[yi * ws_ + xi], Rs)
        vis = visited.reshape(-1)[yi * ws_ + xi]

        rel_err = torch.abs(z - d_s) / torch.clamp(d_s, min=1e-9)
        cosang = torch.sum(n_w * n_s_w, -1)
        oks.append(inb & (z > 0) & (d_s > 0) & (rel_err < max_rel_depth)
                   & (cosang > min_cos) & (~vis) & (ref_depth > 0))

        # the src surface point (world) for averaging
        q = _mat3_rows(torch.stack([sx, sy, torch.ones_like(sx)], -1),
                       torch.linalg.inv(Ks).T)
        Xw_hats.append(_mat3_rows(q * d_s[..., None] - ts, Rs))
        n_hats.append(n_s_w)
        projs.append(torch.stack([sx, sy], -1))

    ok = torch.stack(oks)
    cnt = ok.sum(0)
    okf = ok[..., None].to(_F32)
    xyz_sum = Xw + torch.sum(torch.stack(Xw_hats) * okf, 0)
    n_sum = n_w + torch.sum(torch.stack(n_hats) * okf, 0)
    xyz_mean = xyz_sum / (cnt + 1).to(_F32)[..., None]
    n_norm = n_sum / torch.clamp(
        torch.sqrt(torch.sum(n_sum * n_sum, -1, keepdim=True)), min=1e-9)
    return xyz_mean, n_norm, cnt, torch.stack(projs), ok


def fuse(model, depth_maps: Dict[int, np.ndarray],
         normal_maps: Dict[int, np.ndarray],
         images: Optional[Dict[int, np.ndarray]] = None,
         options: StereoFusionOptions = StereoFusionOptions(),
         consistency_out: Optional[Dict[int, ConsistencyGraph]] = None,
         device="cuda") -> Dict[str, np.ndarray]:
    """Fuse per-image depth/normal maps into a point cloud.

    model: mvs.model.MVSModel. Returns dict with xyz [N,3], normal [N,3],
    color [N,3] uint8. When `consistency_out` is a dict, it is filled with
    per-reference ConsistencyGraphs (reference: mvs/consistency_graph.h).
    """
    min_cos = float(np.cos(np.radians(options.max_normal_error_deg)))
    ids = [i for i in model.images if i in depth_maps]
    visited = {i: np.zeros(depth_maps[i].shape, bool) for i in ids}

    def dev(a, dtype=_F32):
        # a copy: maps read from disk are read-only numpy views
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    all_xyz: List[np.ndarray] = []
    all_normal: List[np.ndarray] = []
    all_color: List[np.ndarray] = []

    for ref_id in ids:
        im = model.images[ref_id]
        srcs = [s for s in model.src_images(ref_id, options.max_num_images)
                if s in depth_maps]
        if not srcs:
            continue
        # pad sources to a common shape (usually identical)
        hs = max(depth_maps[s].shape[0] for s in srcs)
        ws = max(depth_maps[s].shape[1] for s in srcs)

        def pad2(a):
            out = np.zeros((hs, ws) + a.shape[2:], a.dtype)
            out[: a.shape[0], : a.shape[1]] = a
            return out

        ref_active = depth_maps[ref_id] * (~visited[ref_id])
        xyz, nrm, cnt, proj, ok = (t.cpu().numpy() for t in _fuse_one(
            dev(ref_active), dev(normal_maps[ref_id]),
            dev(im.K), dev(im.R), dev(im.t),
            dev(np.stack([pad2(depth_maps[s]) for s in srcs])),
            dev(np.stack([pad2(normal_maps[s]) for s in srcs])),
            dev(np.stack([model.images[s].K for s in srcs])),
            dev(np.stack([model.images[s].R for s in srcs])),
            dev(np.stack([model.images[s].t for s in srcs])),
            dev(np.stack([pad2(visited[s]) for s in srcs]), torch.bool),
            options.max_depth_error, min_cos))

        accept = (cnt + 1) >= options.min_num_pixels
        accept &= ref_active > 0
        if consistency_out is not None:
            consistency_out[ref_id] = ConsistencyGraph.from_masks(
                ok & accept[None], srcs)
        yy, xx = np.nonzero(accept)
        if len(yy) == 0:
            continue
        all_xyz.append(xyz[yy, xx])
        all_normal.append(nrm[yy, xx])
        if images is not None and ref_id in images:
            g = images[ref_id][yy, xx]
            g8 = (np.clip(g, 0, 1) * 255).astype(np.uint8) if g.dtype != np.uint8 else g
            all_color.append(np.stack([g8] * 3, -1) if g8.ndim == 1 else g8)
        else:
            all_color.append(np.full((len(yy), 3), 128, np.uint8))

        # mark consumed pixels in the source views
        visited[ref_id][yy, xx] = True
        for si, s in enumerate(srcs):
            m = ok[si] & accept
            py = np.clip(np.round(proj[si, ..., 1] - 0.5).astype(int), 0,
                         depth_maps[s].shape[0] - 1)
            px = np.clip(np.round(proj[si, ..., 0] - 0.5).astype(int), 0,
                         depth_maps[s].shape[1] - 1)
            visited[s][py[m], px[m]] = True

    if not all_xyz:
        return {"xyz": np.zeros((0, 3), np.float32),
                "normal": np.zeros((0, 3), np.float32),
                "color": np.zeros((0, 3), np.uint8)}
    return {"xyz": np.concatenate(all_xyz).astype(np.float32),
            "normal": np.concatenate(all_normal).astype(np.float32),
            "color": np.concatenate(all_color)}


def write_ply(path: str, xyz: np.ndarray, normal: Optional[np.ndarray] = None,
              color: Optional[np.ndarray] = None):
    """Binary little-endian PLY with optional normals/colors
    (reference: util/ply.cc WriteBinaryPlyPoints)."""
    n = len(xyz)
    props = ["property float x", "property float y", "property float z"]
    if normal is not None:
        props += ["property float nx", "property float ny", "property float nz"]
    if color is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n")
    dt = [("xyz", "<f4", 3)] + ([("n", "<f4", 3)] if normal is not None else [])
    if color is not None:
        dt.append(("c", "u1", 3))
    rec = np.zeros(n, dtype=dt)
    rec["xyz"] = xyz
    if normal is not None:
        rec["n"] = normal
    if color is not None:
        rec["c"] = color
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        props = []
        n = 0
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                props.append(tuple(line.split()[1:]))
            elif line == "end_header":
                break
        dt = [(name, "<f4" if typ == "float" else "u1") for typ, name in props]
        rec = np.frombuffer(f.read(), dtype=dt, count=n)
    out = {"xyz": np.stack([rec["x"], rec["y"], rec["z"]], -1)}
    if "nx" in rec.dtype.names:
        out["normal"] = np.stack([rec["nx"], rec["ny"], rec["nz"]], -1)
    if "red" in rec.dtype.names:
        out["color"] = np.stack([rec["red"], rec["green"], rec["blue"]], -1)
    return out
