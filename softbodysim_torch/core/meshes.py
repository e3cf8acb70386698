"""Procedural simulation meshes (NumPy; same generators as
``softbodysim_tpu/core/meshes.py``, so topologies compare array-equal):
tet cubes and balls, a single tet, and an edges-only cloth patch; and
minimal OBJ readers, with or without texture coordinates."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .topology import Topology, build_topology


def tet_cube(nx: int = 4, ny: int = 4, nz: int = 4, size: float = 1.0,
             center=(0.0, 0.0, 0.0)) -> Topology:
    """Axis-aligned box of (nx, ny, nz) cells, each split into 5 tets with
    alternating parity so faces are conforming."""
    xs = np.linspace(-0.5, 0.5, nx + 1) * size + center[0]
    ys = np.linspace(-0.5, 0.5, ny + 1) * size + center[1]
    zs = np.linspace(-0.5, 0.5, nz + 1) * size + center[2]
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    # 5-tet decomposition; mirror on odd-parity cells to share diagonals
    even = np.array(
        [(0, 1, 2, 4), (1, 3, 2, 7), (1, 4, 5, 7), (2, 4, 7, 6),
         (1, 2, 4, 7)], np.int64)
    odd = np.array(
        [(0, 1, 3, 5), (0, 3, 2, 6), (0, 5, 4, 6), (3, 5, 6, 7),
         (0, 3, 5, 6)], np.int64)

    ci, cj, ck = np.meshgrid(
        np.arange(nx, dtype=np.int64), np.arange(ny, dtype=np.int64),
        np.arange(nz, dtype=np.int64), indexing="ij")
    ci, cj, ck = ci.ravel(), cj.ravel(), ck.ravel()
    corners = np.stack(
        [vid(ci, cj, ck), vid(ci, cj, ck + 1),
         vid(ci, cj + 1, ck), vid(ci, cj + 1, ck + 1),
         vid(ci + 1, cj, ck), vid(ci + 1, cj, ck + 1),
         vid(ci + 1, cj + 1, ck), vid(ci + 1, cj + 1, ck + 1)], axis=1)
    pattern = np.where(
        (((ci + cj + ck) % 2) == 0)[:, None, None], even[None], odd[None])
    tets = np.take_along_axis(
        corners[:, None, :], pattern.reshape(-1, 5, 4), axis=2).reshape(-1, 4)
    return build_topology(verts, tets)


def single_tet(scale: float = 1.0) -> Topology:
    """One regular-ish tetrahedron -- the minimal end-to-end scene."""
    verts = np.array(
        [[0, 0, 0], [1, 0, 0], [0.5, 0, np.sqrt(3) / 2],
         [0.5, np.sqrt(2.0 / 3.0), np.sqrt(3) / 6]],
        np.float32,
    ) * scale
    return build_topology(verts, np.array([[0, 1, 2, 3]], np.int64))


def tet_ball(subdivisions: int = 1, radius: float = 0.5,
             center=(0.0, 0.0, 0.0)) -> Topology:
    """Icosphere surface tetrahedralized by fanning every surface triangle
    to the centre vertex."""
    verts, faces = icosphere(subdivisions)
    verts = verts * radius + np.asarray(center, np.float32)
    centroid = np.asarray(center, np.float32).reshape(1, 3)
    all_verts = np.concatenate([verts, centroid], axis=0).astype(np.float32)
    tets = np.concatenate(
        [faces, np.full((len(faces), 1), len(verts), np.int64)], axis=1)
    return build_topology(all_verts, tets)


def icosphere(subdivisions: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere (vertices, faces) via midpoint subdivision."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)

    for _ in range(subdivisions):
        cache = {}
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key in cache:
                return cache[key]
            m = (vlist[a] + vlist[b]) / 2.0
            m /= np.linalg.norm(m)
            vlist.append(m)
            cache[key] = len(vlist) - 1
            return cache[key]

        new_faces = []
        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return verts.astype(np.float32), faces


def cloth_patch(nx: int = 64, ny: int = 64, size: float = 1.0,
                bending: bool = True, pinned_corners: bool = True,
                height: float = 1.0):
    """Cloth patch: an (nx+1) x (ny+1) particle grid in the XZ plane at
    ``height`` with structural, shear and (optionally) bending distance
    constraints and no tets.  Returns (Topology, pinned corner ids)."""
    xs = np.linspace(-0.5, 0.5, nx + 1) * size
    zs = np.linspace(-0.5, 0.5, ny + 1) * size
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    verts = np.stack([gx, np.full_like(gx, height), gz],
                     axis=-1).reshape(-1, 3).astype(np.float32)

    def vid(i, j):
        return i * (ny + 1) + j

    edges = []
    for i in range(nx + 1):
        for j in range(ny + 1):
            if i < nx:
                edges.append([vid(i, j), vid(i + 1, j)])
            if j < ny:
                edges.append([vid(i, j), vid(i, j + 1)])
            if i < nx and j < ny:
                edges.append([vid(i, j), vid(i + 1, j + 1)])      # shear
                edges.append([vid(i + 1, j), vid(i, j + 1)])      # shear
            if bending and i < nx - 1:
                edges.append([vid(i, j), vid(i + 2, j)])
            if bending and j < ny - 1:
                edges.append([vid(i, j), vid(i, j + 2)])
    tris = []
    for i in range(nx):
        for j in range(ny):
            tris.append([vid(i, j), vid(i, j + 1), vid(i + 1, j)])
            tris.append([vid(i + 1, j), vid(i, j + 1), vid(i + 1, j + 1)])

    topo = build_topology(verts, np.zeros((0, 4), np.int64),
                          edges=np.asarray(edges, np.int64),
                          surface_tris=np.asarray(tris, np.int64),
                          orient=False)
    pinned = (np.asarray([vid(0, 0), vid(0, ny), vid(nx, 0), vid(nx, ny)],
                         np.int64)
              if pinned_corners else np.zeros((0,), np.int64))
    return topo, pinned


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ loader: vertices + triangulated faces (fan)."""
    verts, faces = [], []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def load_obj_uv(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OBJ loader with texture coordinates: (verts, faces, uvs), uvs a
    per-vertex (V, 2) table.  The first ``vt`` referenced by a vertex wins
    (OBJ's per-corner vt indices collapsed per vertex: a seam keeps one
    side); a vertex never referenced with a ``vt`` gets (0, 0)."""
    verts, vts, faces = [], [], []
    uv_of = {}
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("vt "):
                p = line.split()
                vts.append([float(p[1]), float(p[2])])
            elif line.startswith("f "):
                corners = []
                for tok in line.split()[1:]:
                    sub = tok.split("/")
                    vi = int(sub[0]) - 1
                    corners.append(vi)
                    if len(sub) > 1 and sub[1]:
                        uv_of.setdefault(vi, int(sub[1]) - 1)
                for k in range(1, len(corners) - 1):
                    faces.append([corners[0], corners[k], corners[k + 1]])
    verts = np.asarray(verts, np.float32)
    vts = (np.asarray(vts, np.float32) if vts
           else np.zeros((0, 2), np.float32))
    uvs = np.zeros((len(verts), 2), np.float32)
    for vi, ti in uv_of.items():
        if 0 <= ti < len(vts):
            uvs[vi] = vts[ti]
    return verts, np.asarray(faces, np.int64), uvs
