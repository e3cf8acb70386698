"""Vertex-triangle surface collision (soft-soft, triangle level).

The counterpart of ``softbodysim_tpu/solver/surface_collide.py`` (plain
tensor ops, on either device; XLA ops in the JAX package, no Pallas kernel
behind it).  Every particle is tested against the SURFACE TRIANGLES near
it, its own body's and other bodies' in a merged mesh: triangle centroids
hash into a power-of-two table with the particle hash of
``solver/spatial.py``; per particle the 27 neighbour cells give a window of
at most ``max_per_cell`` candidate triangles; closest point on the triangle
(Ericson's region test, branchless) and an inverse-mass-weighted PBD
contact:

    C = h - dist,   grad_p = n,   grad_ck = -bary_k n
    s = C / (w_p + sum_k w_k bary_k^2)
    dx_p = +w_p s n,   dx_ck = -w_k bary_k s n

Both sides move; a particle's own triangles are masked out by corner id.

Deterministic corner reactions: the reactions scatter onto the triangles'
corners, which a float scatter-add on the card sums in a different order
on every run.  Here each reaction is cut (toward zero) to a multiple of
2^-40 m and the three corner scatters add int64 values
(``core/fixed.py::FixedSum``); integer addition is associative, so the
sums are the same bits in any order, run to run, graphed or eager, on
either device.  The cut (< 1e-12 m per reaction) is far below float32's
resolution of the positions, and the total is rounded once to float32 and
added to the particle-side sum; a reaction that is not finite makes its
corner's sum NaN, as a float scatter would.
Integers carry no gradient: when gradients are on and the positions or
inverse masses require grad, the stage also sums the reactions as floats
and adds ``flt - flt.detach()``, exactly 0 in the forward, so the value
stays the integer sum's bit for bit and the gradient is the float
scatter-add's, the JAX package's.

Memory: the candidate tensors are (rows, offsets, max_per_cell[, 3]); the
27 offsets go in chunks under ``spatial.CANDIDATE_BUDGET`` entries, as in
the self stage (one chunk at a cap of 8 up to ~150k rows).  The particle
side sums each chunk over its offsets and window at once, then the chunks
in order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.fixed import FixedSum
from .spatial import (_cell_hash, _next_pow2, _query_rows, cells_of,
                      device_scalar, dropped, neighbour_windows,
                      offset_chunks)

def closest_point_triangle(p, a, b, c):
    """Closest point on triangle(s) to point(s), all (..., 3); returns
    (closest (..., 3), bary (..., 3)).  Ericson, Real-Time Collision
    Detection 5.1.5, branchless: the face solution, then the six edge and
    vertex regions override it."""
    closest, (u, v, w) = _closest_point(p, a, b, c)
    return closest, torch.stack([u, v, w], -1)


def _closest_point(p, a, b, c):
    """``closest_point_triangle`` with the barycentrics as three (...)
    tensors: each region's override selects per component, so no (..., 3)
    candidate tensor is stacked (stacking them took a quarter of the
    surface stage's device time at 110k particles on an H100)."""
    def dot(x, y):
        return (x * y).sum(-1)

    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot(ab, ap)
    d2 = dot(ac, ap)
    bp = p - b
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)
    cp = p - c
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb_ = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def safe(den):
        return torch.where(den.abs() < 1e-20, 1.0, den)

    denom_f = safe(va + vb_ + vc)
    v_f = vb_ / denom_f
    w_f = vc / denom_f

    reg_a = (d1 <= 0.0) & (d2 <= 0.0)
    reg_b = (d3 >= 0.0) & (d4 <= d3)
    reg_c = (d6 >= 0.0) & (d5 <= d6)
    v_ab = d1 / safe(d1 - d3)
    reg_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    w_ac = d2 / safe(d2 - d6)
    reg_ac = (vb_ <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    w_bc = (d4 - d3) / safe((d4 - d3) + (d5 - d6))
    reg_bc = (va <= 0.0) & ((d4 - d3) >= 0.0) & ((d5 - d6) >= 0.0)

    u, v, w = 1.0 - v_f - w_f, v_f, w_f
    for reg, bu, bv, bw in ((reg_bc, 0.0, 1.0 - w_bc, w_bc),
                            (reg_ac, 1.0 - w_ac, 0.0, w_ac),
                            (reg_ab, 1.0 - v_ab, v_ab, 0.0),
                            (reg_c, 0.0, 0.0, 1.0),
                            (reg_b, 0.0, 1.0, 0.0),
                            (reg_a, 1.0, 0.0, 0.0)):
        u = torch.where(reg, bu, u)
        v = torch.where(reg, bv, v)
        w = torch.where(reg, bw, w)
    closest = u[..., None] * a + v[..., None] * b + w[..., None] * c
    return closest, (u, v, w)


def surface_collision_deltas(p, inv_mass, tris, thickness, cell_size,
                             max_per_cell, return_overflow: bool = False,
                             own_offset=None, own_count: int = None,
                             copies: int = 1):
    """Per-particle AND per-triangle-corner contact deltas.

    p (N, 3), inv_mass (N,), tris (T, 3) surface triangles into p (a tensor
    on p's device, or an array).  Returns the (N, 3) summed deltas (vertex
    pushes + corner reactions).

    Own-slice mode (``own_offset`` / ``own_count``): the triangle hash
    covers all of p but only vertices [own_offset, own_offset + own_count)
    are queried; returns ``(vertex_deltas (own_count, 3), corner_reactions
    (N, 3))``.  ``copies``: the rows, and the triangles, are that many
    disjoint copies, each hashed alone (``solver/spatial.py``).  Under
    autograd the corner reactions carry the float scatter's gradient
    (module docstring)."""
    n = p.shape[0]
    dev = p.device
    tris = torch.as_tensor(np.asarray(tris, np.int64)).to(dev) \
        if not isinstance(tris, torch.Tensor) else tris.to(dev, torch.int64)
    tris = tris.reshape(-1, 3)
    nt = tris.shape[0]
    if copies < 1 or n % copies or nt % copies:
        raise ValueError(f"{n} rows / {nt} triangles are not {copies} "
                         "equal copies")
    per_copy = n // copies
    table_size = _next_pow2(2 * max(per_copy, nt // copies))

    a = p[tris[:, 0]]
    b = p[tris[:, 1]]
    c = p[tris[:, 2]]
    cent = (a + b + c) / device_scalar(3.0, dev)
    key = _cell_hash(cells_of(cent, cell_size), table_size)
    copy_q = None
    if copies > 1:
        key = key + (tris[:, 0] // per_copy) * table_size
    order = torch.argsort(key, stable=True)
    sorted_key = key[order].contiguous()

    own_ids = _query_rows(n, own_offset, own_count, dev)
    pq, wq = p[own_ids], inv_mass[own_ids]
    if copies > 1:
        copy_q = own_ids // per_copy
    start, end, dup = neighbour_windows(cells_of(pq, cell_size), copy_q,
                                        sorted_key, table_size)

    m = int(max_per_cell)
    slot = torch.arange(m, device=dev)
    h = float(thickness)
    vertex_deltas = torch.zeros_like(pq)
    corner_sum = FixedSum(n, 3, dev, grad=torch.is_grad_enabled() and (
        p.requires_grad or inv_mass.requires_grad))
    for lo, hi in offset_chunks(len(own_ids), m):
        cand_pos = start[:, lo:hi, None] + slot            # (Nq, k, M)
        valid = (cand_pos < end[:, lo:hi, None]) & ~dup[:, lo:hi, None]
        ta = tris[order[cand_pos.clamp(0, nt - 1)]]        # (Nq, k, M, 3)
        own = (ta == own_ids[:, None, None, None]).any(-1)

        pi = pq[:, None, None, :]
        closest, bary = _closest_point(pi, p[ta[..., 0]], p[ta[..., 1]],
                                       p[ta[..., 2]])
        d = pi - closest
        dist2 = (d * d).sum(-1)
        dist = torch.sqrt(dist2.clamp_min(1e-18))
        hit = valid & ~own & (dist < h) & (dist2 > 1e-16)
        nrm = d / dist[..., None]

        wp = wq[:, None, None]
        wk = [inv_mass[ta[..., k]] for k in range(3)]
        denom = (wp + wk[0] * bary[0] ** 2 + wk[1] * bary[1] ** 2
                 + wk[2] * bary[2] ** 2)
        s = torch.where(hit & (denom > 0.0),
                        (h - dist) / torch.where(denom == 0.0, 1.0, denom),
                        0.0)
        vertex_deltas = vertex_deltas + (nrm * (s * wp)[..., None]).sum(
            (1, 2))
        for k in range(3):            # corner reactions, as integers
            contrib = -nrm * (s * (wk[k] * bary[k]))[..., None]
            corner_sum.add(ta[..., k].reshape(-1), contrib.reshape(-1, 3))
    corners = corner_sum.total()

    if own_offset is not None:
        if return_overflow:
            return vertex_deltas, corners, dropped(start, end, dup, m)
        return vertex_deltas, corners
    deltas = vertex_deltas + corners
    if not return_overflow:
        return deltas
    return deltas, dropped(start, end, dup, m)


class SurfaceCollision:
    """``fn(p_world, inv_mass) -> positions`` with the static parameters
    bound: the triangles (a device tensor), thickness, cell, cap and
    copies.  Rows with w == 0 are returned unchanged."""

    def __init__(self, tris, thickness: float, cell: float,
                 max_per_cell: int, copies: int = 1, device=None):
        self.tris = torch.as_tensor(
            np.asarray(tris, np.int64).reshape(-1, 3)).to(device)
        self.thickness = float(thickness)
        self.cell = float(cell)
        self.max_per_cell = int(max_per_cell)
        self.copies = int(copies)

    def deltas(self, pw, inv_mass, return_overflow=False):
        return surface_collision_deltas(
            pw, inv_mass, self.tris, self.thickness, self.cell,
            self.max_per_cell, return_overflow, copies=self.copies)

    def __call__(self, pw, inv_mass):
        delta = self.deltas(pw, inv_mass)
        return torch.where((inv_mass > 0.0)[:, None], pw + delta, pw)


def make_surface_collision_fn(params, tris, *, copies: int = 1,
                              device=None) -> SurfaceCollision:
    """Bind statics (the JAX function of the same name); returns
    fn(p_world, inv_mass) -> corrected positions."""
    return SurfaceCollision(tris, params.surface_thickness,
                            params.surface_collision_cell,
                            params.surface_collision_max_per_cell, copies,
                            device)


def suggested_cell_size(vertices, tris, thickness) -> float:
    """Centroid hashing covers a contact only if the triangle's
    circumradius + thickness fits in one cell; size cells off the rest
    mesh."""
    v = np.asarray(vertices)
    t = np.asarray(tris, np.int64).reshape(-1, 3)
    if len(t) == 0:
        return max(2.0 * thickness, 1e-3)
    cent = v[t].mean(axis=1)
    r = np.linalg.norm(v[t] - cent[:, None, :], axis=-1).max()
    return float(r + thickness) * 1.05
