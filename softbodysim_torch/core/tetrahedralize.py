"""Closed render mesh -> simulation-ready tetrahedral mesh (host NumPy).

The counterpart of ``softbodysim_tpu/core/tetrahedralize.py``, with the
same results: a voxel tetrahedralizer (cell-centre parity ray casts ->
conforming 5-tet cells), run by the native library (``native/softtopo.cpp``,
``core/native.py::native_voxelize``) when it loads and by the vectorized
NumPy version otherwise, then by default made surface-conforming
(``snap_to_surface``: boundary vertices projected onto the input surface
with a tet-quality clamp and a first-order volume match).  Host code: no
tensor and no device is involved.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .topology import Topology, build_topology


def voxelize_numpy(vertices: np.ndarray, triangles: np.ndarray,
                   cell: float) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy fallback voxel tetrahedralizer (same semantics as the native
    st_voxelize): returns (verts (V,3) f32, tets (T,4) i32)."""
    v = np.asarray(vertices, np.float64).reshape(-1, 3)
    tri = np.asarray(triangles, np.int64).reshape(-1, 3)
    if len(v) == 0 or len(tri) == 0 or cell <= 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 4), np.int32)

    lo = v.min(axis=0)
    hi = v.max(axis=0)
    nx, ny, nz = [max(1, int(np.ceil((hi[k] - lo[k]) / cell)))
                  for k in range(3)]

    # cell centers
    cy = lo[1] + (np.arange(ny) + 0.5) * cell
    cz = lo[2] + (np.arange(nz) + 0.5) * cell
    cx = lo[0] + (np.arange(nx) + 0.5) * cell

    p0 = v[tri[:, 0]]
    p1 = v[tri[:, 1]]
    p2 = v[tri[:, 2]]
    d0 = p1 - p0
    d1 = p2 - p0
    det = d0[:, 1] * d1[:, 2] - d0[:, 2] * d1[:, 1]       # (F,)
    ok = np.abs(det) > 1e-18

    inside = np.zeros((nx, ny, nz), bool)
    # per (y, z) ray: barycentric test in the yz plane, solve x crossings
    for j in range(ny):
        wy = cy[j] - p0[:, 1]
        for k in range(nz):
            wz = cz[k] - p0[:, 2]
            safe_det = np.where(ok, det, 1.0)
            u = (wy * d1[:, 2] - wz * d1[:, 1]) / safe_det
            w = (d0[:, 1] * wz - d0[:, 2] * wy) / safe_det
            hit = ok & (u >= 0) & (w >= 0) & (u + w <= 1)
            if not hit.any():
                continue
            xs = np.sort(p0[hit, 0] + u[hit] * d0[hit, 0] + w[hit] * d1[hit, 0])
            crossings_after = len(xs) - np.searchsorted(xs, cx)
            inside[:, j, k] = (crossings_after % 2) == 1

    ii, jj, kk = np.nonzero(inside)
    if len(ii) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 4), np.int32)

    # shared grid vertex ids
    def corner_key(i, j, k):
        return (i.astype(np.int64) * (ny + 2) + j) * (nz + 2) + k

    corners = np.stack([
        corner_key(ii + di, jj + dj, kk + dk)
        for di in (0, 1) for dj in (0, 1) for dk in (0, 1)
    ], axis=1)  # (C, 8) ordered c000,c001,c010,c011,c100,c101,c110,c111
    uniq, inv = np.unique(corners, return_inverse=True)
    inv = inv.reshape(corners.shape)

    gi = uniq // ((ny + 2) * (nz + 2))
    rem = uniq % ((ny + 2) * (nz + 2))
    gj = rem // (nz + 2)
    gk = rem % (nz + 2)
    verts = np.stack([lo[0] + gi * cell, lo[1] + gj * cell,
                      lo[2] + gk * cell], axis=1).astype(np.float32)

    even = np.array([[0, 1, 2, 4], [1, 3, 2, 7], [1, 4, 5, 7],
                     [2, 4, 7, 6], [1, 2, 4, 7]])
    odd = np.array([[0, 1, 3, 5], [0, 3, 2, 6], [0, 5, 4, 6],
                    [3, 5, 6, 7], [0, 3, 5, 6]])
    parity = (ii + jj + kk) % 2
    tets = np.where(
        (parity == 0)[:, None, None],
        inv[:, even],          # (C, 5, 4)
        inv[:, odd])
    return verts, tets.reshape(-1, 4).astype(np.int32)


def closest_point_on_triangles(points: np.ndarray, p0: np.ndarray,
                               p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Closest point on each of F triangles for each of P query points.
    Returns (P, F, 3)."""
    return _closest_point_core(points[:, None, :],
                               p0[None], p1[None], p2[None])


def closest_point_on_triangles_perpoint(points: np.ndarray, p0: np.ndarray,
                                        p1: np.ndarray,
                                        p2: np.ndarray) -> np.ndarray:
    """Per-point candidate sets: p0/p1/p2 are (P, K, 3).  Returns (P, K, 3)."""
    return _closest_point_core(points[:, None, :], p0, p1, p2)


def _closest_point_core(q: np.ndarray, a: np.ndarray, b: np.ndarray,
                        c: np.ndarray) -> np.ndarray:
    """Branchless vectorized form of the classic region-test (Ericson RTCD
    5.1.5): barycentric clamp against all seven Voronoi regions, selected
    by masks.  Shapes broadcast: q (P,1,3), a/b/c (1,F,3) or (P,K,3).
    """
    ab = b - a
    ac = c - a
    ap = q - a

    d1 = np.sum(ab * ap, axis=-1)
    d2 = np.sum(ac * ap, axis=-1)
    bp = q - b
    d3 = np.sum(ab * bp, axis=-1)
    d4 = np.sum(ac * bp, axis=-1)
    cp = q - c
    d5 = np.sum(ab * cp, axis=-1)
    d6 = np.sum(ac * cp, axis=-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    eps = 1e-30
    # edge BC parameter
    w_bc = np.clip((d4 - d3) / np.where(
        np.abs((d4 - d3) + (d5 - d6)) > eps, (d4 - d3) + (d5 - d6), 1.0),
        0.0, 1.0)
    # interior barycentrics
    denom = np.where(np.abs(va + vb + vc) > eps, va + vb + vc, 1.0)
    v_in = vb / denom
    w_in = vc / denom

    # region masks, in Ericson's order of precedence
    m_a = (d1 <= 0) & (d2 <= 0)                                  # vertex A
    m_b = (d3 >= 0) & (d4 <= d3)                                 # vertex B
    m_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)                     # edge AB
    m_c = (d6 >= 0) & (d5 <= d6)                                 # vertex C
    m_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)                     # edge AC
    m_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)           # edge BC

    t_ab = np.clip(d1 / np.where(np.abs(d1 - d3) > eps, d1 - d3, 1.0), 0, 1)
    t_ac = np.clip(d2 / np.where(np.abs(d2 - d6) > eps, d2 - d6, 1.0), 0, 1)

    v = v_in
    w = w_in
    # apply in reverse precedence so earlier (higher-priority) regions win
    v = np.where(m_bc, 1.0 - w_bc, v)
    w = np.where(m_bc, w_bc, w)
    v = np.where(m_ac, 0.0, v)
    w = np.where(m_ac, t_ac, w)
    v = np.where(m_c, 0.0, v)
    w = np.where(m_c, 1.0, w)
    v = np.where(m_ab, t_ab, v)
    w = np.where(m_ab, 0.0, w)
    v = np.where(m_b, 1.0, v)
    w = np.where(m_b, 0.0, w)
    v = np.where(m_a, 0.0, v)
    w = np.where(m_a, 0.0, w)

    return a + v[..., None] * ab + w[..., None] * ac


def project_to_surface(points: np.ndarray, surf_v: np.ndarray,
                       surf_tri: np.ndarray,
                       chunk: int = 512, k_cand: int = 48) -> np.ndarray:
    """Closest point on a triangle mesh for each query point (P, 3).

    Exact: a centroid-distance lower bound prunes to the ``k_cand``
    nearest candidate triangles per point; any point whose best exact
    distance exceeds the tightest excluded lower bound falls back to the
    full triangle set (rare).
    """
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    sv = np.asarray(surf_v, np.float64).reshape(-1, 3)
    st = np.asarray(surf_tri, np.int64).reshape(-1, 3)
    p0, p1, p2 = sv[st[:, 0]], sv[st[:, 1]], sv[st[:, 2]]
    nf = len(st)
    out = np.empty_like(pts)

    centroid = (p0 + p1 + p2) / 3.0
    rad = np.sqrt(np.maximum.reduce([
        np.sum((p - centroid) ** 2, axis=1) for p in (p0, p1, p2)]))

    use_prune = nf > k_cand
    for s in range(0, len(pts), chunk):
        q = pts[s:s + chunk]                                   # (p, 3)
        if use_prune:
            dc = np.sqrt(np.maximum(
                np.sum((q[:, None] - centroid[None]) ** 2, axis=2), 0.0))
            lb = np.maximum(dc - rad[None], 0.0)               # (p, F)
            idx = np.argpartition(lb, k_cand - 1, axis=1)[:, :k_cand]
            cand = closest_point_on_triangles_perpoint(
                q, p0[idx], p1[idx], p2[idx])                  # (p, K, 3)
            d2 = np.sum((cand - q[:, None]) ** 2, axis=2)
            best = np.argmin(d2, axis=1)
            best_d = np.sqrt(d2[np.arange(len(q)), best])
            res = cand[np.arange(len(q)), best]
            # exactness check: lower bound of the best *excluded* triangle
            excl_min = np.partition(lb, k_cand - 1, axis=1)[:, k_cand - 1:]
            excl_min = excl_min.min(axis=1)
            redo = best_d > excl_min + 1e-12
            if redo.any():
                qq = q[redo]
                cand_f = closest_point_on_triangles(qq, p0, p1, p2)
                d2f = np.sum((cand_f - qq[:, None]) ** 2, axis=2)
                res[redo] = cand_f[np.arange(len(qq)),
                                   np.argmin(d2f, axis=1)]
            out[s:s + chunk] = res
        else:
            cand = closest_point_on_triangles(q, p0, p1, p2)
            d2 = np.sum((cand - q[:, None]) ** 2, axis=2)
            out[s:s + chunk] = cand[np.arange(len(q)),
                                    np.argmin(d2, axis=1)]
    return out


def mesh_volume(vertices: np.ndarray, triangles: np.ndarray) -> float:
    """Signed volume enclosed by a triangle mesh (divergence theorem;
    positive for outward-wound closed surfaces)."""
    v = np.asarray(vertices, np.float64).reshape(-1, 3)
    t = np.asarray(triangles, np.int64).reshape(-1, 3)
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    return float(np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6.0)


def tets_volume(vertices: np.ndarray, tets: np.ndarray) -> float:
    """Total unsigned tet volume."""
    v = np.asarray(vertices, np.float64).reshape(-1, 3)
    t = np.asarray(tets, np.int64).reshape(-1, 4)
    p = v[t]
    vol = np.einsum(
        "ti,ti->t", np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
        p[:, 3] - p[:, 0]) / 6.0
    return float(np.abs(vol).sum())


def _tet_signed_vols(x: np.ndarray, t: np.ndarray) -> np.ndarray:
    p = x[t]
    return np.einsum(
        "ti,ti->t", np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
        p[:, 3] - p[:, 0])


def _backtrack_scale(x: np.ndarray, delta: np.ndarray, t: np.ndarray,
                     sgn: np.ndarray, floor: np.ndarray) -> np.ndarray:
    """Largest per-vertex scale in {1, 0.5^k, 0} such that EVERY tet of
    ``x + scale*delta`` keeps ``sgn*vol >= floor``.

    Shrinking one vertex's scale can re-violate a neighboring tet that
    passed at the previous scales, so after the halving rounds the
    zero-out runs to a fixed point.  Termination: a tet whose four
    vertices all have scale 0 evaluates at exactly ``x``, where
    ``sgn*vol = |vols0| >= quality_min*|vols0|`` holds by construction —
    so every remaining violation has a nonzero scale to zero."""
    scale = np.ones(len(x))
    for _ in range(8):
        vols = sgn * _tet_signed_vols(x + scale[:, None] * delta, t)
        bad = vols < floor
        if not bad.any():
            return scale
        scale[np.unique(t[bad].reshape(-1))] *= 0.5
        scale[scale < 1e-3] = 0.0
    for _ in range(len(x)):
        vols = sgn * _tet_signed_vols(x + scale[:, None] * delta, t)
        bad = vols < floor
        if not bad.any():
            return scale
        scale[np.unique(t[bad].reshape(-1))] = 0.0
    return np.zeros(len(x))   # unreachable; absolute safety


def snap_to_surface(verts: np.ndarray, tets: np.ndarray,
                    surf_v: np.ndarray, surf_tri: np.ndarray,
                    *, quality_min: float = 0.05,
                    iters: int = 8, smooth: float = 0.5,
                    volume_match: bool = True) -> np.ndarray:
    """Deform a voxel tet mesh so its boundary conforms to an input surface.

    Iterative relax-and-project: each outer iteration moves boundary
    vertices a partial step toward their closest point on the surface
    (re-projected every iteration), relaxes interior vertices toward their
    edge-neighbor average so the lattice follows the boundary, then
    backtracks per-vertex wherever an incident tet's signed volume would
    drop below ``quality_min`` of its pre-snap value.

    This closes the voxel tetrahedralizer's conformity gap to the
    reference's body-fitted constrained-Delaunay plugin
    (Tetrahedralizer.cs:131-220, consumed at SoftBodyTetMeshAsset.cs:25-81):
    after snapping, the tet-mesh boundary interpolates the true input
    surface instead of the voxel hull, so collision happens against (a
    piecewise-linear approximation of) the real shape and the enclosed
    volume matches the input mesh closely.  Interior vertices keep a
    well-conditioned (smoothly graded) lattice.

    Returns new vertex positions (V, 3) f32; topology is unchanged.
    """
    v = np.asarray(verts, np.float64).reshape(-1, 3)
    t = np.asarray(tets, np.int64).reshape(-1, 4)
    if len(t) == 0 or len(v) == 0:
        return np.asarray(v, np.float32).reshape(-1, 3)

    from .topology import build_edges_and_surface

    edges, btris = build_edges_and_surface(v.astype(np.float32), t)
    bset = np.unique(np.asarray(btris, np.int64).reshape(-1))
    if len(bset) == 0:
        return v.astype(np.float32)
    is_boundary = np.zeros(len(v), bool)
    is_boundary[bset] = True
    interior = ~is_boundary

    e0 = np.asarray(edges[:, 0], np.int64)
    e1 = np.asarray(edges[:, 1], np.int64)
    deg = np.zeros(len(v))
    np.add.at(deg, e0, 1.0)
    np.add.at(deg, e1, 1.0)
    deg = np.maximum(deg, 1.0)

    vols0 = _tet_signed_vols(v, t)
    sgn = np.where(vols0 >= 0, 1.0, -1.0)
    floor = quality_min * np.abs(vols0)

    x = v.copy()
    for it in range(iters):
        step = 1.0 if it == iters - 1 else 0.5
        prop = x.copy()
        target = project_to_surface(x[bset], surf_v, surf_tri)
        prop[bset] = x[bset] + step * (target - x[bset])
        if interior.any() and smooth > 0.0:
            nsum = np.zeros_like(prop)
            np.add.at(nsum, e0, prop[e1])
            np.add.at(nsum, e1, prop[e0])
            avg = nsum / deg[:, None]
            prop[interior] += smooth * (avg[interior] - prop[interior])

        # per-vertex backtrack of this iteration's delta against quality
        delta = prop - x
        scale = _backtrack_scale(x, delta, t, sgn, floor)
        x = x + scale[:, None] * delta

    if volume_match:
        # First-order volume compensation: a pure closest-point snap
        # *inscribes* the piecewise-linear boundary, systematically losing
        # O(h^2 * curvature) volume on convex detail.  Pushing boundary
        # vertices a uniform distance along their (area-weighted) normals
        # changes enclosed volume by ~= offset * area; two Newton rounds
        # center the PL surface on the true one and match the enclosed
        # volume to the input mesh.
        vol_ref = abs(mesh_volume(surf_v, surf_tri))
        bt = np.asarray(btris, np.int64)
        for _ in range(3):
            fa = np.cross(x[bt[:, 1]] - x[bt[:, 0]], x[bt[:, 2]] - x[bt[:, 0]])
            area = 0.5 * float(np.linalg.norm(fa, axis=1).sum())
            nrm = np.zeros_like(x)
            for k in range(3):
                np.add.at(nrm, bt[:, k], fa)
            nlen = np.linalg.norm(nrm, axis=1, keepdims=True)
            nrm = nrm / np.maximum(nlen, 1e-30)
            vol_now = tets_volume(x, t)
            if area <= 0.0 or abs(vol_now - vol_ref) / max(vol_ref, 1e-30) \
                    < 1e-3:
                break
            offset = (vol_ref - vol_now) / area
            delta = np.zeros_like(x)
            delta[bset] = offset * nrm[bset]
            scale = _backtrack_scale(x, delta, t, sgn, floor)
            x = x + scale[:, None] * delta

    return x.astype(np.float32)


def tetrahedralize(vertices: np.ndarray, triangles: np.ndarray,
                   cell: Optional[float] = None,
                   resolution: int = 12) -> Tuple[np.ndarray, np.ndarray]:
    """(verts, tets) for a closed mesh.  ``cell`` defaults to
    max_extent / resolution.  The native library when it loads, else
    ``voxelize_numpy``."""
    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    tri = np.asarray(triangles, np.int64).reshape(-1, 3)
    if cell is None:
        extent = float((v.max(axis=0) - v.min(axis=0)).max()) if len(v) else 1.0
        cell = extent / max(1, resolution)

    from .native import native_voxelize

    out = native_voxelize(v, tri, cell)
    if out is None:
        out = voxelize_numpy(v, tri, cell)
    return out


def topology_from_mesh(vertices: np.ndarray, triangles: np.ndarray,
                       cell: Optional[float] = None,
                       resolution: int = 12, *,
                       snap: bool = True,
                       quality_min: float = 0.05) -> Topology:
    """Full pipeline: closed render mesh -> Topology (the
    TryCreateFromMesh equivalent).

    ``snap=True`` (default) projects the tet-mesh boundary onto the input
    surface (surface-conforming, like the reference's body-fitted plugin
    output); ``snap=False`` keeps the raw voxel hull."""
    verts, tets = tetrahedralize(vertices, triangles, cell=cell,
                                 resolution=resolution)
    if len(tets) == 0:
        raise ValueError(
            "tetrahedralization produced no tets (mesh not closed, or "
            "resolution too coarse)")
    if snap:
        verts = snap_to_surface(verts, tets, vertices, triangles,
                                quality_min=quality_min)
    return build_topology(verts, tets)


def topology_from_obj(path: str, cell: Optional[float] = None,
                      resolution: int = 12, *, snap: bool = True) -> Topology:
    from .meshes import load_obj

    verts, faces = load_obj(path)
    return topology_from_mesh(verts, faces, cell=cell, resolution=resolution,
                              snap=snap)
