"""CSR adjacency builders and their padded, degree-bucketed forms (NumPy,
host side).

The outputs of ``softbodysim_tpu/core/adjacency.py`` (the reference's
BuildEdgeAdjacency / BuildTetAdjacency / BuildTriAdjacency,
SoftBodySolver.cs:1082-1212: counting pass, prefix sum, fill in constraint
order), array-equal; the CSR fill is one stable sort instead of a Python
loop, so a 600k-constraint mesh takes milliseconds.  ``combine_topologies``
merges bodies into one scene.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .topology import Topology, build_topology


def _csr(num_particles: int, cons: np.ndarray):
    """(offsets (V+1,), flat (N*arity,)) -- each vertex's incidences as
    flat indices ``arity * constraint + role``, in constraint order."""
    flat_v = cons.ravel()
    counts = np.bincount(flat_v, minlength=num_particles)
    offsets = np.zeros(num_particles + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, np.argsort(flat_v, kind="stable")


def build_edge_adjacency(num_particles: int, edges: np.ndarray):
    """Returns (offsets (V+1,), other (2E,), edge_index (2E,))."""
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    offsets, flat = _csr(num_particles, edges)
    return offsets, edges.ravel()[flat ^ 1], flat >> 1


def build_tet_adjacency(num_particles: int, tets: np.ndarray):
    """Returns (offsets (V+1,), tet_index (4T,), role (4T,))."""
    tets = np.asarray(tets, np.int64).reshape(-1, 4)
    offsets, flat = _csr(num_particles, tets)
    return offsets, flat >> 2, flat & 3


def build_tri_adjacency(num_particles: int, tris: np.ndarray):
    """Returns (offsets (V+1,), tri_index (3S,))."""
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    offsets, flat = _csr(num_particles, tris)
    return offsets, flat // 3


def csr_to_padded(offsets: np.ndarray, *values: np.ndarray,
                  fill: int = 0) -> Tuple[np.ndarray, ...]:
    """CSR -> dense (V, max_degree) arrays + mask."""
    v = len(offsets) - 1
    deg = np.diff(offsets)
    dmax = int(deg.max()) if v else 0
    mask = np.arange(dmax)[None, :] < deg[:, None]
    outs = []
    for val in values:
        out = np.full((v, dmax), fill, val.dtype)
        out[mask] = val
        outs.append(out)
    return (*outs, mask)


def _padded(num_particles: int, verts: np.ndarray, cols):
    """Scatter the incidence columns ``cols`` of the flat vertex list
    ``verts`` into (V, Dmax) rows, stable by flat position."""
    order = np.argsort(verts, kind="stable")
    sv = verts[order]
    deg = np.bincount(verts, minlength=num_particles)
    dmax = int(deg.max())
    row_start = np.zeros(num_particles + 1, np.int64)
    np.cumsum(deg, out=row_start[1:])
    pos = np.arange(len(verts)) - row_start[sv]
    outs = []
    for col in cols:
        out = np.zeros((num_particles, dmax), np.int32)
        out[sv, pos] = col[order]
        outs.append(out)
    mask = np.zeros((num_particles, dmax), bool)
    mask[sv, pos] = True
    return (*outs, mask)


def _empty_padded(num_particles: int):
    return (np.zeros((num_particles, 1), np.int32),
            np.zeros((num_particles, 1), np.int32),
            np.zeros((num_particles, 1), bool))


def padded_edge_adjacency(num_particles: int, edges: np.ndarray):
    """(other (V,D), edge_idx (V,D), mask (V,D)), D = max degree; rows by
    endpoint role, then edge index (the K_EdgeGather walk,
    SoftBodyCompute.compute:243-274)."""
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    e_count = len(edges)
    if e_count == 0:
        return _empty_padded(num_particles)
    endpoints = np.concatenate([edges[:, 0], edges[:, 1]])
    others = np.concatenate([edges[:, 1], edges[:, 0]])
    eidx = np.tile(np.arange(e_count, dtype=np.int64), 2)
    return _padded(num_particles, endpoints, (others, eidx))


def padded_tet_adjacency(num_particles: int, tets: np.ndarray):
    """(tet_idx (V,D), role (V,D), mask (V,D)) -- the K_VolumeGather walk
    (SoftBodyCompute.compute:294-370)."""
    tets = np.asarray(tets, np.int64).reshape(-1, 4)
    t_count = len(tets)
    if t_count == 0:
        return _empty_padded(num_particles)
    tidx = np.repeat(np.arange(t_count, dtype=np.int64), 4)
    role = np.tile(np.arange(4, dtype=np.int64), t_count)
    return _padded(num_particles, tets.ravel(), (tidx, role))


def degree_buckets(deg: np.ndarray, quantiles=(0.5, 0.75, 0.9)):
    """Degree caps for bucketed padded adjacency: vertices bucketed by
    degree, each bucket padded to its own cap."""
    deg = np.asarray(deg)
    if deg.size == 0 or deg.max() == 0:
        return [1]
    caps = sorted({max(1, int(np.ceil(np.quantile(deg, q))))
                   for q in quantiles})
    dmax = int(deg.max())
    return [c for c in caps if c < dmax] + [dmax]


def bucket_vertices(deg: np.ndarray, caps):
    """Partition vertex ids by degree cap: (buckets, pos), buckets[i] the
    ids with caps[i-1] < deg <= caps[i] (ascending) and pos the row of
    each vertex in the bucket-concatenated order."""
    deg = np.asarray(deg)
    assign = np.searchsorted(caps, deg, side="left")
    buckets = [np.nonzero(assign == i)[0] for i in range(len(caps))]
    order = (np.concatenate(buckets) if len(deg)
             else np.zeros((0,), np.int64))
    pos = np.empty(len(deg), np.int64)
    pos[order] = np.arange(len(deg))
    return buckets, pos


def bucketize_padded(padded_arrays, mask: np.ndarray, deg: np.ndarray,
                     quantiles=(0.5, 0.75, 0.9)):
    """Slice (V, Dmax) padded arrays into per-degree-bucket views:
    (list of (vertex_ids, [arrays (Nb, Db)], mask_b), pos)."""
    caps = degree_buckets(deg, quantiles)
    buckets, pos = bucket_vertices(deg, caps)
    out = []
    for cap, vids in zip(caps, buckets):
        if len(vids) == 0:
            continue
        out.append((vids, [a[vids, :cap] for a in padded_arrays],
                    mask[vids, :cap]))
    return out, pos


def combine_topologies(topologies: Sequence[Topology]
                       ) -> Tuple[Topology, List[slice]]:
    """Merge bodies into one scene topology with offset indices: (merged,
    slices), slices[i] selecting body i's particles.  The colourings are
    rebuilt over the merged constraint lists (``merge_topologies`` keeps
    the bodies' own colours instead)."""
    verts, edges, tets, tris, slices = [], [], [], [], []
    off = 0
    for t in topologies:
        n = t.num_particles
        slices.append(slice(off, off + n))
        verts.append(t.vertices)
        if t.num_edges:
            edges.append(t.edges.astype(np.int64) + off)
        if t.num_tets:
            tets.append(t.tets.astype(np.int64) + off)
        if len(t.surface_tris):
            tris.append(t.surface_tris.astype(np.int64) + off)
        off += n

    def cat(parts, width):
        return (np.concatenate(parts, axis=0) if parts
                else np.zeros((0, width), np.int64))

    merged = build_topology(np.concatenate(verts, axis=0), cat(tets, 4),
                            edges=cat(edges, 2), surface_tris=cat(tris, 3),
                            orient=False)     # bodies are already oriented
    return merged, slices
