"""Host-side topology building: unique edges, boundary surface, orientation
and greedy graph colouring (pure NumPy, off the hot path).

A copy of ``softbodysim_tpu/core/topology.py``: the port cannot import the
JAX package, and topologies built (and merged) here must compare
array-equal with the JAX ones.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ColorGroups:
    """Padded colour groups for one constraint family.

    idx  : (C, K) int32 -- constraint ids per colour, padded with 0
    mask : (C, K) bool  -- True where a real constraint
    order: (N,)  int64  -- constraint ids in colour-major sweep order
    """

    idx: np.ndarray
    mask: np.ndarray
    order: np.ndarray

    @property
    def num_colors(self) -> int:
        return self.idx.shape[0]


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static simulation topology (host-side NumPy)."""

    vertices: np.ndarray       # (V, 3) f32 rest positions
    edges: np.ndarray          # (E, 2) i32 unique undirected edges
    tets: np.ndarray           # (T, 4) i32 positively-oriented tets
    surface_tris: np.ndarray   # (S, 3) i32 outward-wound boundary triangles
    edge_rest: np.ndarray      # (E,) f32 rest lengths
    tet_rest_vol: np.ndarray   # (T,) f32 SIGNED rest volumes
    edge_colors: ColorGroups
    tet_colors: ColorGroups

    @property
    def num_particles(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def num_tets(self) -> int:
        return int(self.tets.shape[0])


def orient_tets_positive(vertices: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """Swap (b, c) of any tet with negative signed volume."""
    tets = np.asarray(tets, np.int64).reshape(-1, 4)
    v = np.asarray(vertices, np.float32)
    if tets.shape[0] > 4096:            # native fast path, bit-identical
        from .native import native_orient

        out = native_orient(v, tets)
        if out is not None:
            return out.astype(np.int64)
    tets = tets.copy()
    p = v[tets]
    vol = np.einsum(
        "ti,ti->t",
        np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
        p[:, 3] - p[:, 0],
    ) / 6.0
    neg = vol < 0.0
    b = tets[neg, 1].copy()
    tets[neg, 1] = tets[neg, 2]
    tets[neg, 2] = b
    return tets


def build_edges_and_surface(
    vertices: np.ndarray, tets: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Unique sorted-pair edges + outward-wound boundary triangles of a tet
    list, in deterministic (lexicographic) order."""
    tets = np.asarray(tets, np.int64).reshape(-1, 4)
    v = np.asarray(vertices, np.float32)

    a, b, c, d = tets[:, 0], tets[:, 1], tets[:, 2], tets[:, 3]
    pairs = np.concatenate(
        [np.stack([a, b], 1), np.stack([a, c], 1), np.stack([a, d], 1),
         np.stack([b, c], 1), np.stack([b, d], 1), np.stack([c, d], 1)],
        axis=0)
    pairs.sort(axis=1)
    edges = np.unique(pairs, axis=0).astype(np.int32)

    # faces with their designated opposite vertex
    faces = np.concatenate(
        [np.stack([a, b, c, d], 1), np.stack([a, d, b, c], 1),
         np.stack([a, c, d, b], 1), np.stack([b, d, c, a], 1)],
        axis=0)
    keys = np.sort(faces[:, :3], axis=1)
    _, first_idx, inv, counts = np.unique(
        keys, axis=0, return_index=True, return_inverse=True,
        return_counts=True)
    boundary = counts[inv[first_idx]] == 1
    btris = faces[first_idx][boundary]  # (S, 4): i0, i1, i2, opp

    if btris.size:
        p0, p1, p2, po = (v[btris[:, k]] for k in range(4))
        n = np.cross(p1 - p0, p2 - p0)
        s = np.einsum("ti,ti->t", n, po - p0)
        flip = s > 0.0
        i1 = btris[flip, 1].copy()
        btris[flip, 1] = btris[flip, 2]
        btris[flip, 2] = i1
        tris = btris[:, :3]
        tris = tris[np.lexsort((tris[:, 2], tris[:, 1], tris[:, 0]))]
    else:
        tris = np.zeros((0, 3), np.int64)
    return edges, tris.astype(np.int32)


def greedy_color(constraints: np.ndarray, num_vertices: int) -> np.ndarray:
    """Greedy colouring in ascending constraint order: each constraint takes
    the smallest colour unused among its vertices' coloured constraints."""
    cons = np.asarray(constraints, np.int64)
    n = cons.shape[0]
    colors = np.zeros(n, np.int32)
    last_used = [[] for _ in range(num_vertices)]
    for i in range(n):
        used = set()
        for vtx in cons[i]:
            used.update(last_used[vtx])
        col = 0
        while col in used:
            col += 1
        colors[i] = col
        for vtx in cons[i]:
            last_used[vtx].append(col)
    return colors


def color_groups(constraints: np.ndarray, num_vertices: int,
                 colors: Optional[np.ndarray] = None) -> ColorGroups:
    """Colour constraints and pack them into padded (C, K) groups."""
    cons = np.asarray(constraints, np.int64)
    n = cons.shape[0]
    if n == 0:
        return ColorGroups(idx=np.zeros((1, 1), np.int32),
                           mask=np.zeros((1, 1), bool),
                           order=np.zeros((0,), np.int64))
    if colors is None:
        from .native import native_greedy_color

        colors = native_greedy_color(cons, num_vertices)
    if colors is None:
        colors = greedy_color(cons, num_vertices)
    num_colors = int(colors.max()) + 1
    groups = [np.nonzero(colors == c)[0] for c in range(num_colors)]
    k = max(len(g) for g in groups)
    idx = np.zeros((num_colors, k), np.int32)
    mask = np.zeros((num_colors, k), bool)
    for ci, g in enumerate(groups):
        idx[ci, : len(g)] = g
        mask[ci, : len(g)] = True
    return ColorGroups(idx=idx, mask=mask, order=np.concatenate(groups))


def build_topology(vertices: np.ndarray, tets: np.ndarray,
                   edges: Optional[np.ndarray] = None,
                   surface_tris: Optional[np.ndarray] = None, *,
                   orient: bool = True) -> Topology:
    """Orientation, edges and surface (derived where not given, e.g. an
    asset's stored lists or a cloth's edges), fp32 rest quantities in the
    reference's operation order, and colouring of a tet mesh."""
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    tets = np.asarray(tets, np.int64).reshape(-1, 4)
    if orient:
        tets = orient_tets_positive(vertices, tets)

    edge_colors_pre = tet_colors_pre = None
    if (edges is None or surface_tris is None) and tets.size:
        from .native import native_build_topology

        nat = native_build_topology(vertices, tets)
        if nat is not None:
            n_edges, n_surface, ecol, tet_colors_pre = nat
            if edges is None:
                edges, edge_colors_pre = n_edges, ecol
            if surface_tris is None:
                surface_tris = n_surface
    if edges is None or surface_tris is None:
        d_edges, d_tris = build_edges_and_surface(vertices, tets)
        edges = d_edges if edges is None else edges
        surface_tris = d_tris if surface_tris is None else surface_tris
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    surface_tris = np.asarray(surface_tris, np.int64).reshape(-1, 3)

    # rest lengths and SIGNED rest volumes: fp32, dot = (xx+yy)+zz, then
    # one fp32 sqrt / divide
    d = vertices[edges[:, 1]] - vertices[edges[:, 0]]
    edge_rest = np.sqrt(
        (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    ).astype(np.float32)
    p = vertices[tets]
    cr = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    e3 = p[:, 3] - p[:, 0]
    tet_rest_vol = (
        ((cr[:, 0] * e3[:, 0] + cr[:, 1] * e3[:, 1]) + cr[:, 2] * e3[:, 2])
        / np.float32(6.0)
    ).astype(np.float32)

    nv = vertices.shape[0]
    return Topology(
        vertices=vertices,
        edges=edges.astype(np.int32),
        tets=tets.astype(np.int32),
        surface_tris=surface_tris.astype(np.int32),
        edge_rest=edge_rest,
        tet_rest_vol=tet_rest_vol,
        edge_colors=color_groups(edges, nv, colors=edge_colors_pre),
        tet_colors=color_groups(tets, nv, colors=tet_colors_pre),
    )


def _merge_color_groups(parts_cg, parts_offsets) -> ColorGroups:
    """Union same-index colours across vertex-disjoint parts: the merged
    family is validly coloured with max_parts(num_colors) colours, and each
    part's sweep order within a colour is kept (parts in list order)."""
    num_colors = max(cg.num_colors for cg in parts_cg)
    per_color = []
    for c in range(num_colors):
        rows = [cg.idx[c][cg.mask[c]].astype(np.int64) + off
                for cg, off in zip(parts_cg, parts_offsets)
                if c < cg.num_colors]
        per_color.append(np.concatenate(rows) if rows
                         else np.zeros((0,), np.int64))
    k = max(1, max(len(g) for g in per_color))
    idx = np.zeros((num_colors, k), np.int32)
    mask = np.zeros((num_colors, k), bool)
    for ci, g in enumerate(per_color):
        idx[ci, : len(g)] = g
        mask[ci, : len(g)] = True
    live = [g for g in per_color if len(g)]
    order = np.concatenate(live) if live else np.zeros((0,), np.int64)
    return ColorGroups(idx=idx, mask=mask, order=order)


def merge_topologies(parts: Sequence[Topology]
                     ) -> Tuple[Topology, np.ndarray]:
    """Disjoint union of topologies: a multi-body scene as one sim mesh,
    bodies as vertex ranges of one particle table (no constraint crosses a
    body boundary, so each body's physics is its own).  Returns (merged,
    vertex_offsets), vertex_offsets[i] body i's first vertex id (length
    len(parts) + 1)."""
    parts = list(parts)
    if not parts:
        raise ValueError("merge_topologies needs at least one part")
    counts = np.array([[p.num_particles, p.num_edges, p.num_tets]
                       for p in parts], np.int64)
    offs = np.zeros((len(parts) + 1, 3), np.int64)
    np.cumsum(counts, axis=0, out=offs[1:])
    voffs = offs[:, 0]

    def cat(field, shift):
        return np.concatenate(
            [np.asarray(getattr(p, field), np.int64) + voffs[i] if shift
             else np.asarray(getattr(p, field))
             for i, p in enumerate(parts)], axis=0)

    merged = Topology(
        vertices=cat("vertices", False).astype(np.float32),
        edges=cat("edges", True).astype(np.int32),
        tets=cat("tets", True).astype(np.int32),
        surface_tris=cat("surface_tris", True).astype(np.int32),
        edge_rest=cat("edge_rest", False).astype(np.float32),
        tet_rest_vol=cat("tet_rest_vol", False).astype(np.float32),
        edge_colors=_merge_color_groups([p.edge_colors for p in parts],
                                        offs[:-1, 1]),
        tet_colors=_merge_color_groups([p.tet_colors for p in parts],
                                       offs[:-1, 2]),
    )
    return merged, voffs
