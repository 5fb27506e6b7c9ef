"""Surface meshing from fused point clouds.

Port of colmap_tpu/mvs/meshing.py (reference: src/colmap/mvs/meshing.h:37-122,
PoissonMeshing and Delaunay meshing). The Poisson path is the JAX module's:
oriented points are splatted trilinearly onto a regular grid
(`index_put_(accumulate=True)` on `device`), and the screened Poisson
equation (Laplacian - screen) chi = div V is solved in the Fourier domain
with `torch.fft` (cuFFT on the card), where the 7-point Laplacian is
diagonal. The iso-surface is extracted on the host by naive surface nets;
`surface_nets`, `delaunay_mesh` and `write_mesh_ply` are host copies of the
JAX module's (numpy / scipy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from scipy import ndimage


@dataclasses.dataclass(frozen=True)
class PoissonMeshingOptions:
    """Counterpart of PoissonMeshingOptions (reference: mvs/meshing.h:43):
    depth -> grid resolution 2^depth capped by `max_grid`, point_weight ->
    screening weight, trim -> density trim threshold."""

    depth: int = 7
    point_weight: float = 1.0
    trim: float = 4.0  # min splat density (points per occupied cell region)
    max_grid: int = 256
    padding: float = 0.08


def _splat_points(xyz_u: np.ndarray, vals: np.ndarray, n: int,
                  device="cuda") -> torch.Tensor:
    """Trilinear scatter of per-point values onto an [n,n,n] (+channels)
    grid on `device`; xyz_u in [0, 1]."""
    p = np.clip(xyz_u * (n - 1), 0, n - 1.000001)
    p0 = np.floor(p).astype(np.int32)
    f = (p - p0).astype(np.float32)
    grid = torch.zeros((n, n, n) + vals.shape[1:], dtype=torch.float32,
                       device=device)
    tvals = torch.as_tensor(np.asarray(vals, np.float32), device=device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (np.abs(1 - dx - f[:, 0]) * np.abs(1 - dy - f[:, 1])
                     * np.abs(1 - dz - f[:, 2])).astype(np.float32)
                idx = tuple(torch.as_tensor(np.minimum(p0[:, a] + d, n - 1),
                                            dtype=torch.int64, device=device)
                            for a, d in enumerate((dx, dy, dz)))
                tw = torch.as_tensor(w, device=device)
                grid.index_put_(idx, tw * tvals if vals.ndim == 1
                                else tw[:, None] * tvals, accumulate=True)
    return grid


def _poisson_solve_fft(divV: torch.Tensor, screen: float) -> torch.Tensor:
    """Solve (lap - screen) chi = divV with DFT eigenvalues of the
    7-point Laplacian stencil."""
    n = divV.shape[0]
    k = torch.fft.fftfreq(n, dtype=torch.float32, device=divV.device) \
        * (2 * np.pi)
    eig1 = 2 * (torch.cos(k) - 1.0)  # eigenvalues of the 1D [1 -2 1] stencil
    lam = eig1[:, None, None] + eig1[None, :, None] + eig1[None, None, :]
    rhs = torch.fft.fftn(divV)
    denom = lam - screen
    denom = torch.where(torch.abs(denom) < 1e-9,
                        torch.full_like(denom, -1e-9), denom)
    return torch.fft.ifftn(rhs / denom).real


def poisson_mesh(xyz: np.ndarray, normal: np.ndarray,
                 options: PoissonMeshingOptions = PoissonMeshingOptions(),
                 device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Screened-Poisson surface reconstruction; returns (vertices, faces)."""
    n = min(2 ** options.depth, options.max_grid)
    lo = xyz.min(0)
    hi = xyz.max(0)
    span = float(np.max(hi - lo)) or 1.0
    pad = options.padding * span
    origin = lo - pad
    scale = span + 2 * pad
    u = (xyz - origin) / scale

    # normalize normals; splat the vector field V and point density
    nn = normal / np.maximum(np.linalg.norm(normal, axis=1, keepdims=True), 1e-9)
    V = _splat_points(u, nn.astype(np.float32), n, device)
    dens = _splat_points(u, np.ones(len(u), np.float32), n, device)

    # divergence of V (central differences), cell size h = 1/n
    h = 1.0 / n
    div = torch.zeros((n, n, n), dtype=torch.float32, device=V.device)
    div[1:-1] += (V[2:, :, :, 0] - V[:-2, :, :, 0]) / (2 * h)
    div[:, 1:-1] += (V[:, 2:, :, 1] - V[:, :-2, :, 1]) / (2 * h)
    div[:, :, 1:-1] += (V[:, :, 2:, 2] - V[:, :, :-2, 2]) / (2 * h)
    div *= h * h  # match the stencil eigenvalue scaling

    screen = float(np.float32(options.point_weight * 1e-2))
    chi = _poisson_solve_fft(div, screen).cpu().numpy()

    # iso level: mean of chi at the sample points (standard Poisson choice)
    pi = np.clip((u * (n - 1)).astype(int), 0, n - 1)
    iso = float(np.mean(chi[pi[:, 0], pi[:, 1], pi[:, 2]]))
    field = chi - iso

    # trim: only mesh near observed points (reference: trimmer threshold)
    support = ndimage.grey_dilation(dens.cpu().numpy(), size=5) \
        > (options.trim * 0.05)
    field = np.where(support, field, np.abs(field) + 1e-3)  # no crossings

    verts, faces = surface_nets(field)
    if len(verts) == 0:
        return verts, faces
    verts = verts / (n - 1) * scale + origin
    return verts.astype(np.float32), faces


def surface_nets(field: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Naive surface nets: dual-contour the zero level set of field.

    One vertex per cell containing a sign change (at the mean of edge
    crossings); one quad (two triangles) per grid edge with a sign change,
    connecting the 4 adjacent cell vertices. Fully vectorized numpy.
    """
    f = np.asarray(field, np.float32)
    nx, ny, nz = f.shape
    inside = f < 0

    # cells: (nx-1, ny-1, nz-1); corner offsets
    corners = np.array([(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)])
    cvals = np.stack([f[c[0]:c[0] + nx - 1, c[1]:c[1] + ny - 1, c[2]:c[2] + nz - 1]
                      for c in corners])  # [8, X, Y, Z]
    csign = cvals < 0
    crossing = csign.any(0) & (~csign.all(0))
    cid = -np.ones(crossing.shape, np.int64)
    xs, ys, zs = np.nonzero(crossing)
    cid[xs, ys, zs] = np.arange(len(xs))

    # vertex position: average of edge crossing points within the cell
    edges = []
    for a in range(8):
        for b in range(a + 1, 8):
            if np.sum(np.abs(corners[a] - corners[b])) == 1:
                edges.append((a, b))
    pos_sum = np.zeros((len(xs), 3), np.float64)
    cnt = np.zeros(len(xs), np.float64)
    base = np.stack([xs, ys, zs], -1).astype(np.float64)
    for a, b in edges:
        va = cvals[a][xs, ys, zs]
        vb = cvals[b][xs, ys, zs]
        m = (va < 0) != (vb < 0)
        t = va / np.where(np.abs(va - vb) < 1e-12, 1e-12, va - vb)
        pt = corners[a] + t[:, None] * (corners[b] - corners[a])
        pos_sum[m] += pt[m]
        cnt[m] += 1
    verts = base + pos_sum / np.maximum(cnt, 1)[:, None]

    # faces: for each axis-aligned grid edge with a sign change, connect the
    # 4 cells sharing it
    faces = []
    for axis in range(3):
        sl = [slice(0, None)] * 3
        sl[axis] = slice(1, None)
        v1 = f[tuple(sl)]
        sl[axis] = slice(0, -1)
        v0 = f[tuple(sl)]
        cross = (v0 < 0) != (v1 < 0)
        flip = v0 < 0  # orientation
        # the edge at (x, y, z) along `axis` borders 4 cells: offsets in the
        # two perpendicular axes of -1 and 0
        axes_p = [a for a in range(3) if a != axis]
        ex, ey, ez = np.nonzero(cross)
        E = np.stack([ex, ey, ez], -1)
        ids = []
        valid = np.ones(len(E), bool)
        for (da, db) in ((0, 0), (-1, 0), (-1, -1), (0, -1)):
            c = E.copy()
            c[:, axes_p[0]] += da
            c[:, axes_p[1]] += db
            okc = ((c >= 0).all(1) & (c[:, 0] < cid.shape[0])
                   & (c[:, 1] < cid.shape[1]) & (c[:, 2] < cid.shape[2]))
            idx = np.full(len(E), -1, np.int64)
            idx[okc] = cid[c[okc, 0], c[okc, 1], c[okc, 2]]
            valid &= idx >= 0
            ids.append(idx)
        q = np.stack(ids, -1)[valid]
        fl = flip[ex, ey, ez][valid]
        q_f = np.where(fl[:, None], q[:, ::-1], q)
        faces.append(np.stack([q_f[:, 0], q_f[:, 1], q_f[:, 2]], -1))
        faces.append(np.stack([q_f[:, 0], q_f[:, 2], q_f[:, 3]], -1))
    faces = np.concatenate(faces) if faces else np.zeros((0, 3), np.int64)
    return verts.astype(np.float32), faces


def write_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(faces)}\n"
              "property list uchar int vertex_index\nend_header\n")
    with open(path, "wb") as fp:
        fp.write(header.encode())
        fp.write(np.asarray(verts, "<f4").tobytes())
        rec = np.zeros(len(faces), dtype=[("n", "u1"), ("v", "<i4", 3)])
        rec["n"] = 3
        rec["v"] = faces
        fp.write(rec.tobytes())


def delaunay_mesh(xyz: np.ndarray, cam_centers: np.ndarray,
                  visibility: Optional[np.ndarray] = None,
                  max_side_ratio: float = 10.0) -> Tuple[np.ndarray, np.ndarray]:
    """Delaunay-based meshing (reference: SparseDelaunayMeshing,
    mvs/meshing.cc:169 — CGAL Delaunay + s-t cut on visibility rays).

    Simplified s-t formulation: tetrahedralize the points, mark cells
    crossed by camera->point rays as outside-weighted, solve max-flow on
    the cell adjacency graph (scipy), and emit the cut faces.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import maximum_flow
    from scipy.spatial import Delaunay

    tri = Delaunay(xyz)
    n_cells = len(tri.simplices)
    centroids = xyz[tri.simplices].mean(1)

    # visibility votes: for each point, walk samples along each camera ray
    # and vote the containing cells "outside"; the cell just behind the
    # point votes "inside"
    outside_votes = np.zeros(n_cells + 1, np.float64)  # +1 = infinite cell
    inside_votes = np.zeros(n_cells + 1, np.float64)
    n_samp = 8
    for c in cam_centers:
        ts = np.linspace(0.05, 0.95, n_samp)
        for t in ts:
            samples = c[None, :] * (1 - t) + xyz * t
            cells = tri.find_simplex(samples)
            np.add.at(outside_votes, np.where(cells < 0, n_cells, cells), 1.0)
        behind = xyz + (xyz - c[None, :]) * 0.02
        cells_b = tri.find_simplex(behind)
        np.add.at(inside_votes, np.where(cells_b < 0, n_cells, cells_b), 1.0)

    # graph: source = outside evidence, sink = inside evidence; smooth over
    # shared facets
    SCALE = 16.0
    rows, cols, caps = [], [], []
    lam = 1.0
    for ci, nbrs in enumerate(tri.neighbors):
        for nb in nbrs:
            j = nb if nb >= 0 else n_cells
            rows.append(ci)
            cols.append(j)
            caps.append(lam)
    n_nodes = n_cells + 3  # cells + inf cell + source + sink
    SRC, SNK = n_cells + 1, n_cells + 2
    for ci in range(n_cells + 1):
        if outside_votes[ci] > 0:
            rows.append(SRC)
            cols.append(ci)
            caps.append(float(outside_votes[ci]))
        if inside_votes[ci] > 0:
            rows.append(ci)
            cols.append(SNK)
            caps.append(float(inside_votes[ci]))
    # infinite cell strongly outside
    rows.append(SRC)
    cols.append(n_cells)
    caps.append(1e6)
    cap_int = np.maximum((np.asarray(caps) * SCALE).astype(np.int64), 1)
    g = coo_matrix((cap_int, (rows, cols)), shape=(n_nodes, n_nodes)).tocsr()
    res = maximum_flow(g, SRC, SNK)
    # cells reachable from source in the residual graph = outside
    residual = g - res.flow
    from scipy.sparse.csgraph import breadth_first_order

    reach = np.zeros(n_nodes, bool)
    order = breadth_first_order(residual > 0, SRC, return_predecessors=False)
    reach[order] = True
    outside = reach[: n_cells + 1]

    # faces between outside/inside cells
    faces = []
    face_idx = [(1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)]
    for ci, nbrs in enumerate(tri.neighbors):
        for fi, nb in enumerate(nbrs):
            nb_out = outside[nb] if nb >= 0 else outside[n_cells]
            if outside[ci] and not nb_out:
                tetra = tri.simplices[ci]
                faces.append(tetra[list(face_idx[fi])])
    faces = np.asarray(faces, np.int64) if faces else np.zeros((0, 3), np.int64)
    return xyz.astype(np.float32), faces
