"""Render-mesh embedding: drive the ORIGINAL render surface from the sim mesh.

The reference's mesh pipeline preserves the render mesh through
tetrahedralization -- its native plugin's second stage maps every render
vertex into the tet mesh and remaps UV/color attributes by barycentric
weights (Assets/Hanzzz/Tetrahedralizer/Scripts/Tetrahedralizer.cs:335-353,
MeshVertexDataMapper.cs:1-239).  Our voxel tetrahedralizer
(core/tetrahedralize.py) discards the input surface, so this module is
its equivalent here: compute, once at init, a (tet id, 4 barycentric
weights) pair per render vertex, then *skin* the render surface from
simulated tet corners every frame.  Attributes (UVs, colors, the triangle
list) never leave the render mesh, so any closed textured mesh round-trips
with its appearance intact.

Points outside every tet (the voxel mesh can shrink past thin features) are
attached to the nearest tet by unclamped affine coordinates, which
extrapolates linearly -- same behavior as barycentric extrapolation in the
reference mapper.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeshEmbedding:
    """Per-render-vertex attachment into a sim tet mesh.

    tet_id : (N,) int32   containing (or nearest) tet per render vertex
    bary   : (N, 4) f32   barycentric weights w.r.t. that tet's corners
    inside : (N,) bool    True if the vertex was inside its tet (diagnostic)
    """

    tet_id: np.ndarray
    bary: np.ndarray
    inside: np.ndarray

    @property
    def inside_fraction(self) -> float:
        return float(self.inside.mean()) if len(self.inside) else 1.0


def _barycentric(p, a, b, c, d):
    """Affine coordinates of points p w.r.t. tets (a,b,c,d).  Vectorized:
    p (N,3), corners (N,3) -> (N,4).  Degenerate tets yield w=(1,0,0,0)."""
    m = np.stack([b - a, c - a, d - a], axis=-1)           # (N,3,3)
    rhs = (p - a)[..., None]                               # (N,3,1)
    det = np.linalg.det(m)
    ok = np.abs(det) > 1e-18
    sol = np.zeros((len(p), 3), np.float64)
    if ok.any():
        sol[ok] = np.linalg.solve(m[ok], rhs[ok])[..., 0]
    w0 = 1.0 - sol.sum(-1)
    return np.concatenate([w0[:, None], sol], axis=1), ok


def embed_mesh(render_vertices: np.ndarray, sim_vertices: np.ndarray,
               tets: np.ndarray, chunk: int = 4096) -> MeshEmbedding:
    """Attach every render vertex to a sim tet (containing if possible,
    else nearest-centroid) with barycentric weights.

    O(N * T / chunk) vectorized NumPy; runs once at init, off the hot path.
    """
    rp = np.asarray(render_vertices, np.float64).reshape(-1, 3)
    sp = np.asarray(sim_vertices, np.float64)
    tt = np.asarray(tets, np.int64).reshape(-1, 4)
    n = len(rp)
    if len(tt) == 0 or n == 0:
        return MeshEmbedding(np.zeros(n, np.int32),
                             np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32),
                             np.zeros(n, bool))

    corners = sp[tt]                                       # (T,4,3)
    cent = corners.mean(axis=1)                            # (T,3)
    lo = corners.min(axis=1)
    hi = corners.max(axis=1)

    tet_id = np.zeros(n, np.int32)
    bary = np.zeros((n, 4), np.float32)
    inside = np.zeros(n, bool)

    for s in range(0, n, chunk):
        p = rp[s:s + chunk]                                # (M,3)
        m = len(p)
        # candidate tets via AABB test (vector over tets, loop over chunk
        # kept on the tet axis: broadcast (M,1,3) vs (T,3))
        in_box = ((p[:, None, :] >= lo[None] - 1e-9)
                  & (p[:, None, :] <= hi[None] + 1e-9)).all(-1)  # (M,T)
        # nearest centroid as fallback
        d2 = ((p[:, None, :] - cent[None]) ** 2).sum(-1)   # (M,T)
        nearest = d2.argmin(axis=1)

        best = np.full(m, -1, np.int64)
        best_w = np.zeros((m, 4), np.float64)
        # examine AABB candidates in slabs to bound memory
        for i in range(m):
            cand = np.flatnonzero(in_box[i])
            if len(cand):
                w, ok = _barycentric(
                    np.repeat(p[i:i + 1], len(cand), 0),
                    corners[cand, 0], corners[cand, 1],
                    corners[cand, 2], corners[cand, 3])
                w = np.where(ok[:, None], w, -1.0)
                margin = w.min(axis=1)
                j = margin.argmax()
                if margin[j] >= -1e-6:
                    best[i] = cand[j]
                    best_w[i] = w[j]
        hit = best >= 0
        miss = ~hit
        if miss.any():
            nb = nearest[miss]
            w, ok = _barycentric(p[miss], corners[nb, 0], corners[nb, 1],
                                 corners[nb, 2], corners[nb, 3])
            best[miss] = nb
            best_w[miss] = np.where(ok[:, None], w,
                                    np.array([1.0, 0, 0, 0]))
        tet_id[s:s + chunk] = best.astype(np.int32)
        bary[s:s + chunk] = best_w.astype(np.float32)
        inside[s:s + chunk] = hit

    return MeshEmbedding(tet_id=tet_id, bary=bary, inside=inside)


def skin_positions(sim_positions, tets, embedding: MeshEmbedding):
    """Render-vertex positions from sim positions: x_r = sum_i w_i * x[t_i].

    Works on NumPy arrays or torch tensors (pure indexing + weighted sum;
    a tensor stays on its device), so it can run device-side after a step
    or host-side at export."""
    tt = np.asarray(tets, np.int64)[np.asarray(embedding.tet_id, np.int64)]
    w = embedding.bary
    x = sim_positions
    if isinstance(x, np.ndarray):
        return (x[tt] * np.asarray(w, x.dtype)[..., None]).sum(axis=1)
    idx = torch.as_tensor(tt).to(x.device)
    wt = torch.as_tensor(np.asarray(w), dtype=x.dtype).to(x.device)
    return (x[idx] * wt[..., None]).sum(dim=1)


def embed_topology(render_vertices, render_triangles, topo,
                   render_uvs: Optional[np.ndarray] = None):
    """Convenience: embedding + a skinning closure for a Topology.

    Returns (embedding, skin) where skin(x) -> (N,3) render positions.
    """
    emb = embed_mesh(render_vertices, topo.vertices, topo.tets)

    def skin(x):
        return skin_positions(x, topo.tets, emb)

    return emb, skin
