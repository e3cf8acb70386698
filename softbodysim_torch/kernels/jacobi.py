"""PyTorch wrappers of the CUDA Jacobi pass kernels (``csrc/jacobi.cu``),
each with its plain PyTorch version beside it.

* ``jacobi_edge_pass`` -- replaces ``softbodysim_tpu/kernels/jacobi.py::
  _edge_pass_kernel``: one distance gather + apply stage.
* ``jacobi_tet_pass``  -- replaces ``_tet_pass_kernel``: one volume gather +
  apply stage.
* ``jacobi_edge_pass_collide`` / ``jacobi_tet_pass_collide`` -- the same
  passes with the collide stage (``softbodysim_tpu/kernels/collide.py::
  _collide_kernel``, here ``collide.collide``) fused into them: each row
  the pass writes gets the ground plane and the colliders before its
  store.  The pass step runs them as the last pass of each iteration.
* ``jacobi_edge_accumulate`` / ``jacobi_tet_accumulate`` -- the passes'
  accumulate-only mode (the TPU kernels built with ``apply=False``,
  ``make_jacobi_pass`` :421-461): per row the raw (delta xyz, count) as one
  float4, nothing applied.  The kernel-sharded Jacobi step
  (``solver/jacobi_pass_sharded.py``) runs them over a rank's own and
  ghost rows and applies after the ghost rows' sums are sent home.  Their
  plain versions are ``edge_jacobi_deltas`` / ``tet_jacobi_deltas``.

All are one launch of one CTA per spatial vertex tile
(``jacobi_plan.tile_plan``; the plans below hold each family's tiles on
the device): no intermediate table of positions in device memory, no
atomics on positions, a fixed summation order per vertex.  A plan with
heavy vertices (``jacobi_plan``) adds a small table of partial sums that
the launch's last CTA reduces.

Both read the snapshot ``xin`` and write ``xout``, two distinct (V, 4) f32
tables of rows x, y, z, inverse mass in public vertex order; the caller
swaps them (a pass that wrote the table it reads would be Gauss-Seidel).
The plain versions are the segment formulation: the per-constraint math
defined here (``edge_jacobi_deltas``, ``tet_jacobi_deltas``, each a
scatter into (delta, count), the deltas in int64 fixed point so a run
repeats its bits on the card too) then ``apply_delta``; the solver's
segment and gather backends import that math from here.  A wrapper runs its
plain version for tables on the CPU and launches its kernel for tables on
a CUDA device, raising if the launch is refused; ``<wrapper>.launches``
counts the kernel launches and nothing else (``kernels.count_launch``).
``k`` and ``omega`` are floats or 0-dim float32 tensors on the tables'
device: the kernel reads a tensor's value when it runs, so a CUDA graph
that captured the launch follows the tensor.  ``cnt_out`` (optional, (V,)
int32) receives each particle's constraint count.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..collide.primitives import cross3, dot3
from ..core.fixed import index_sum
from ..core.state import f32, resolve_device
from . import collide as kc
from . import count_launch, jacobi_plan
from .sweep import _check, _lib, _ptr, _raise_on, _stream


# --------------------------------------------------------------------------
# Per-constraint math (the plain versions' body; the solver's segment
# backend and gather forms share it)
# --------------------------------------------------------------------------

EPS_LEN2 = f32(1e-18)
EPS_SQRT = f32(1e-30)
EPS_WSUM = f32(1e-20)


def edge_jacobi_deltas(x_pred, inv_mass, edges, edge_rest, stiffness, nv):
    """Per-particle (delta (V, 3), count (V,) int32) from all distance
    constraints.  Per edge (a, b): w = wa + wb; skip w == 0 or
    len^2 < 1e-18; lambda = -k * ((len - rest) / w); contribution
    n * (lambda * wa) to a and -n * (lambda * wb) to b; each valid edge
    counts for both endpoints (SoftBodySolver.cs:408-429).  ``stiffness``:
    a scalar or an (E,) tensor.  The deltas are summed in int64 fixed
    point (``core/fixed.py``): the same bits on every run, on either
    device."""
    ends, ws = x_pred[edges], inv_mass[edges]          # (E, 2, 3), (E, 2)
    w = ws[:, 0] + ws[:, 1]
    d = ends[:, 0] - ends[:, 1]
    len2 = dot3(d, d)
    valid = (w != 0.0) & (len2 >= EPS_LEN2)
    length = torch.sqrt(len2.clamp_min(EPS_SQRT))
    n = d / length[:, None]
    lam = torch.where(
        valid, -stiffness * ((length - edge_rest)
                             / torch.where(w == 0.0, 1.0, w)), 0.0)
    contrib = n[:, None, :] * (lam[:, None] * ws)[:, :, None]
    contrib[:, 1].neg_()                      # -n * (lambda * wb), exactly
    delta = index_sum(nv, ((edges.reshape(-1), contrib.reshape(-1, 3)),))
    vi = valid.to(torch.int32)
    cnt = torch.zeros(nv, dtype=torch.int32, device=x_pred.device)
    cnt.index_add_(0, edges[:, 0], vi)
    cnt.index_add_(0, edges[:, 1], vi)
    return delta, cnt


def _tet_gradients(pa, pb, pc, pd):
    """Role gradients g_a..g_d (each (T, 3)) and the signed volume."""
    ga = cross3(pd - pb, pc - pb) / 6.0
    gb = cross3(pc - pa, pd - pa) / 6.0
    gc = cross3(pd - pa, pb - pa) / 6.0
    gd = cross3(pb - pa, pc - pa) / 6.0
    vol = dot3(cross3(pb - pa, pc - pa), pd - pa) / 6.0
    return (ga, gb, gc, gd), vol


def tet_lambda(ps, ws, tet_rest_vol, stiffness):
    """(role gradients, lambda, valid) per tet from its four corners'
    positions ``ps`` (each (T, 3)) and inverse masses ``ws`` (each
    (T,))."""
    gs, vol = _tet_gradients(*ps)
    wsum = ws[0] * dot3(gs[0], gs[0])
    for r in range(1, 4):
        wsum = wsum + ws[r] * dot3(gs[r], gs[r])
    valid = (((ws[0] + ws[1]) + ws[2]) + ws[3] != 0.0) & (wsum >= EPS_WSUM)
    lam = torch.where(
        valid, -stiffness * ((vol - tet_rest_vol)
                             / torch.where(wsum == 0.0, 1.0, wsum)), 0.0)
    return gs, lam, valid


def tet_jacobi_deltas(x_pred, inv_mass, tets, tet_rest_vol, stiffness, nv):
    """Per-particle (delta, count) from all volume constraints: role
    gradient * (lambda * w_role); a corner counts only when its tet is
    valid and its w != 0 (SoftBodySolver.cs:461-515).  The deltas are
    summed in int64 fixed point, as ``edge_jacobi_deltas``'."""
    ws = inv_mass[tets]                       # each corner gathered at once
    gs, lam, valid = tet_lambda(x_pred[tets].unbind(1), ws.unbind(1),
                                tet_rest_vol, stiffness)
    contrib = torch.stack(gs, 1) * (lam[:, None] * ws)[:, :, None]
    idx = tets.reshape(-1)
    delta = index_sum(nv, ((idx, contrib.reshape(-1, 3)),))
    cnt = torch.zeros(nv, dtype=torch.int32, device=x_pred.device)
    cnt.index_add_(0, idx, (valid[:, None] & (ws != 0.0)).to(
        torch.int32).reshape(-1))
    return delta, cnt


def apply_delta(x_pred, inv_mass, delta, cnt, omega):
    """x += (omega / cnt) * delta for free particles with cnt > 0
    (SoftBodySolver.cs:521-527); omega: a float or a 0-dim tensor."""
    ok = (cnt > 0) & (inv_mass != 0.0)
    cntf = cnt.to(x_pred.dtype).clamp_min(1.0)
    scale = (omega if isinstance(omega, torch.Tensor)
             else torch.full_like(cntf, f32(omega))) / cntf
    return torch.where(ok[:, None], x_pred + scale[:, None] * delta, x_pred)


class Tiles(NamedTuple):
    """A family's tile plan (``jacobi_plan.tile_plan``) on one device: what
    the CUDA pass reads.  Per listed constraint (tile-major) its record of
    local rows and slots, its rest value and, with a per-constraint
    stiffness table, its k; the heavy vertices' tables, and the pass's
    scratch for them (the partials, and the ticket of the CTA that sums
    them, 0 between launches)."""

    num_tiles: int
    max_rows: int
    max_cons: int
    max_slots: int
    smem_bytes: int
    row_ptr: torch.Tensor          # (n+1,) int32
    rows: torch.Tensor             # (sum R,) int32 global vertex ids
    own_ptr: torch.Tensor          # (n+1,) int32
    slot_end: torch.Tensor         # (sum owned,) int16
    con_ptr: torch.Tensor          # (n+1,) int32
    rec: torch.Tensor              # (L, 2 * arity) int16
    rest: torch.Tensor             # (L,) f32
    k: Optional[torch.Tensor]      # (L,) f32
    part_ptr: torch.Tensor         # (n+1,) int32
    part_end: torch.Tensor         # (P,) int16
    part_dst: torch.Tensor         # (P,) int32
    heavy: torch.Tensor            # (H,) int32
    heavy_ptr: torch.Tensor        # (H+1,) int32
    partials: torch.Tensor         # (P, 4) f32 scratch, heavy-major
    ticket: torch.Tensor           # (1,) int32 scratch


class EdgePassPlan(NamedTuple):
    """The distance constraints of one topology on one device."""

    num_particles: int
    edges: torch.Tensor            # (E, 2) int32, the plain version's
    rest: torch.Tensor             # (E,) f32
    k: Optional[torch.Tensor]      # (E,) f32 per-constraint stiffness
    tiles: Tiles


class TetPassPlan(NamedTuple):
    """The volume constraints of one topology on one device."""

    num_particles: int
    tets: torch.Tensor             # (T, 4) int32
    rest: torch.Tensor             # (T,) f32
    k: Optional[torch.Tensor]      # (T,) f32 per-constraint stiffness
    tiles: Tiles


def _t(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a)).to(device, dtype)


def _k_array(k, n):
    if k is None:
        return None
    k = np.asarray(k, np.float32).reshape(-1)
    if k.shape[0] != n:
        raise ValueError(f"per-constraint stiffness: {k.shape[0]} values "
                         f"for {n} constraints")
    return k


def device_tiles(tp: jacobi_plan.TilePlan, rest, k, device) -> Tiles:
    """A host tile plan on ``device``, with each listed constraint's rest
    value and (``k``: the family's per-constraint table) stiffness."""
    i32 = torch.int32
    return Tiles(
        num_tiles=tp.num_tiles, max_rows=tp.max_rows, max_cons=tp.max_cons,
        max_slots=tp.max_slots, smem_bytes=tp.smem_bytes,
        row_ptr=_t(tp.row_ptr, i32, device), rows=_t(tp.rows, i32, device),
        own_ptr=_t(tp.own_ptr, i32, device),
        slot_end=_t(tp.slot_end, torch.int16, device),
        con_ptr=_t(tp.con_ptr, i32, device),
        rec=_t(tp.rec, torch.int16, device),
        rest=_t(rest[tp.cons], torch.float32, device),
        k=None if k is None else _t(k[tp.cons], torch.float32, device),
        part_ptr=_t(tp.part_ptr, i32, device),
        part_end=_t(tp.part_end, torch.int16, device),
        part_dst=_t(tp.part_dst, i32, device),
        heavy=_t(tp.heavy, i32, device),
        heavy_ptr=_t(tp.heavy_ptr, i32, device),
        partials=torch.zeros((len(tp.part_dst), 4), dtype=torch.float32,
                             device=device),
        ticket=torch.zeros(1, dtype=i32, device=device))


def edge_pass_plan(num_particles: int, edges, edge_rest, k=None,
                   device=None, *, vertices,
                   smem_budget: int = jacobi_plan.SMEM_LIMIT,
                   tiles: Optional[jacobi_plan.TilePlan] = None
                   ) -> EdgePassPlan:
    """The edge tables and their tile plan on ``device`` (default: the
    card); ``vertices``: the rest positions the tiles are cut from;
    ``smem_budget``: a tile's shared memory, at most (``tile_plan``);
    ``tiles``: the host tile plan, when the caller already cut it."""
    dev = resolve_device(device)
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    rest = np.asarray(edge_rest, np.float32).reshape(-1)
    k = _k_array(k, len(edges))
    if tiles is None:
        tiles = jacobi_plan.tile_plan(num_particles, edges, vertices,
                                      smem_budget=smem_budget)
    return EdgePassPlan(
        num_particles=num_particles, edges=_t(edges, torch.int32, dev),
        rest=_t(rest, torch.float32, dev),
        k=None if k is None else _t(k, torch.float32, dev),
        tiles=device_tiles(tiles, rest, k, dev))


def tet_pass_plan(num_particles: int, tets, tet_rest_vol, k=None,
                  device=None, *, vertices,
                  smem_budget: int = jacobi_plan.SMEM_LIMIT,
                  tiles: Optional[jacobi_plan.TilePlan] = None
                  ) -> TetPassPlan:
    """The tet tables and their tile plan on ``device``."""
    dev = resolve_device(device)
    tets = np.asarray(tets, np.int64).reshape(-1, 4)
    rest = np.asarray(tet_rest_vol, np.float32).reshape(-1)
    k = _k_array(k, len(tets))
    if tiles is None:
        tiles = jacobi_plan.tile_plan(num_particles, tets, vertices,
                                      smem_budget=smem_budget)
    return TetPassPlan(
        num_particles=num_particles, tets=_t(tets, torch.int32, dev),
        rest=_t(rest, torch.float32, dev),
        k=None if k is None else _t(k, torch.float32, dev),
        tiles=device_tiles(tiles, rest, k, dev))


def ctas_per_sm(plan) -> int:
    """CTAs of the plan's pass kernel that one SM of the current CUDA
    device holds at once (the occupancy API at the plan's shared
    memory); 0 if one CTA does not fit."""
    arity = plan.tiles.rec.shape[1] // 2
    n = _lib().sbs_jacobi_ctas_per_sm(arity, plan.tiles.smem_bytes)
    if n < 0:
        raise RuntimeError(f"sbs_jacobi_ctas_per_sm: CUDA error {-n}")
    return n


# --------------------------------------------------------------------------
# Checks
# --------------------------------------------------------------------------

def _check_pass(plan, xin, xout, cnt_out) -> torch.device:
    if not isinstance(xin, torch.Tensor) or xin.dim() != 2:
        raise ValueError("xin must be a (V, 4) tensor")
    dev = xin.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    shape = (plan.num_particles, 4)
    _check(xin, "xin", torch.float32, shape, dev)
    _check(xout, "xout", torch.float32, shape, dev)
    if xin.data_ptr() == xout.data_ptr():
        raise ValueError("xout must not be xin: a pass reads one snapshot")
    if cnt_out is not None:
        _check(cnt_out, "cnt_out", torch.int32, (plan.num_particles,), dev)
    return dev


def _check_tiles(tiles: Tiles, v: int, arity: int, dev) -> None:
    n, L = tiles.num_tiles, tiles.rest.shape[0]
    h, P = tiles.heavy.shape[0], tiles.part_dst.shape[0]
    i32 = torch.int32
    for name in ("row_ptr", "own_ptr", "con_ptr", "part_ptr"):
        _check(getattr(tiles, name), f"tiles.{name}", i32, (n + 1,), dev)
    _check(tiles.rows, "tiles.rows", i32, (tiles.rows.shape[0],), dev)
    _check(tiles.slot_end, "tiles.slot_end", torch.int16, (v - h,), dev)
    _check(tiles.rec, "tiles.rec", torch.int16, (L, 2 * arity), dev)
    _check(tiles.part_end, "tiles.part_end", torch.int16, (P,), dev)
    _check(tiles.part_dst, "tiles.part_dst", i32, (P,), dev)
    _check(tiles.heavy, "tiles.heavy", i32, (h,), dev)
    _check(tiles.heavy_ptr, "tiles.heavy_ptr", i32, (h + 1,), dev)
    _check(tiles.partials, "tiles.partials", torch.float32, (P, 4), dev)
    _check(tiles.ticket, "tiles.ticket", i32, (1,), dev)
    _check(tiles.rest, "tiles.rest", torch.float32, (L,), dev)
    if tiles.k is not None:
        _check(tiles.k, "tiles.k", torch.float32, (L,), dev)


def _check_edge_plan(plan: EdgePassPlan, dev) -> None:
    v, e = plan.num_particles, plan.rest.shape[0]
    _check(plan.edges, "plan.edges", torch.int32, (e, 2), dev)
    _check(plan.rest, "plan.rest", torch.float32, (e,), dev)
    if plan.k is not None:
        _check(plan.k, "plan.k", torch.float32, (e,), dev)
    _check_tiles(plan.tiles, v, 2, dev)


def _check_tet_plan(plan: TetPassPlan, dev) -> None:
    v, t = plan.num_particles, plan.rest.shape[0]
    _check(plan.tets, "plan.tets", torch.int32, (t, 4), dev)
    _check(plan.rest, "plan.rest", torch.float32, (t,), dev)
    if plan.k is not None:
        _check(plan.k, "plan.k", torch.float32, (t,), dev)
    _check_tiles(plan.tiles, v, 4, dev)


def _stiffness(plan, k):
    """k, or the per-constraint table times k (the scalar multiplies)."""
    return k if plan.k is None else plan.k * k


def _scalar(v, name: str, dev) -> torch.Tensor:
    """A step scalar as a 0-dim float32 tensor on ``dev`` (a float is
    filled in by a kernel: no host-to-device copy waits)."""
    if not isinstance(v, torch.Tensor):
        return torch.full((), f32(v), dtype=torch.float32, device=dev)
    if v.device != dev or v.dtype != torch.float32 or v.dim() != 0:
        raise ValueError(f"{name}: a float or a 0-dim float32 tensor on "
                         f"{dev}, got {v.dtype} {tuple(v.shape)} on "
                         f"{v.device}")
    return v


def _write(xin, xout, x_new, cnt, cnt_out) -> None:
    xout[:, :3] = x_new
    xout[:, 3] = xin[:, 3]
    if cnt_out is not None:
        cnt_out.copy_(cnt)


# --------------------------------------------------------------------------
# Edge pass
# --------------------------------------------------------------------------

def jacobi_edge_pass_plain(plan: EdgePassPlan, xin: torch.Tensor,
                           xout: torch.Tensor, k, omega,
                           cnt_out: Optional[torch.Tensor] = None) -> None:
    x, w = xin[:, :3], xin[:, 3]
    delta, cnt = edge_jacobi_deltas(x, w, plan.edges.long(), plan.rest,
                                    _stiffness(plan, k), plan.num_particles)
    _write(xin, xout, apply_delta(x, w, delta, cnt, float(omega)), cnt,
           cnt_out)


def _launch(plan, arity, xin, xout, k, omega, cnt_out, name, packed=None,
            ground=None, accumulate=False) -> None:
    """One launch of the tiled pass kernel: one CTA per tile; with
    ``packed`` (and ``ground``) the variant with the collide stage; with
    ``accumulate`` the accumulate-only variant (xout: the sums, counts)."""
    t, dev = plan.tiles, xin.device
    ground = ground or kc.XPBD_GROUND
    (gpx, gpy, gpz), (gnx, gny, gnz) = ground.point, ground.normal
    f = ctypes.c_float
    rc = _lib().sbs_jacobi_pass(
        arity, _ptr(xin), _ptr(xout), _ptr(t.row_ptr), _ptr(t.rows),
        _ptr(t.own_ptr), _ptr(t.slot_end), _ptr(t.con_ptr), _ptr(t.rec),
        _ptr(t.rest), _ptr(t.k), t.num_tiles, t.smem_bytes, _ptr(k),
        _ptr(omega), _ptr(cnt_out), _ptr(t.part_ptr), _ptr(t.part_end),
        _ptr(t.part_dst), _ptr(t.partials), _ptr(t.heavy),
        _ptr(t.heavy_ptr), t.heavy.shape[0], _ptr(t.ticket),
        _ptr(packed), 0 if packed is None else packed.shape[0],
        int(ground.enabled), f(gpx), f(gpy), f(gpz), f(gnx), f(gny), f(gnz),
        f(ground.radius), int(accumulate), _stream(dev))
    _raise_on(rc, name)


def _pass(plan, arity, fn, plain, xin, xout, k, omega, cnt_out, packed=None,
          ground=None) -> None:
    """Checks, then ``plain`` for tables on the CPU or one launch of the
    kernel of ``arity`` (with the collide stage when ``packed`` is given),
    counted as ``fn``'s."""
    dev = _check_pass(plan, xin, xout, cnt_out)
    (_check_edge_plan if arity == 2 else _check_tet_plan)(plan, dev)
    k, omega = _scalar(k, "k", dev), _scalar(omega, "omega", dev)
    if packed is not None:
        kc.check_packed(packed, dev)
        smem = (plan.tiles.smem_bytes
                + jacobi_plan.COLLIDER_BYTES * packed.shape[0])
        if smem > jacobi_plan.SMEM_LIMIT:
            raise ValueError(
                f"{fn.__name__}: the plan's largest tile and {packed.shape[0]}"
                f" colliders need {smem} bytes of shared memory, over "
                f"{jacobi_plan.SMEM_LIMIT}: build the plan with smem_budget="
                f"jacobi_plan.pass_budget({packed.shape[0]})")
    if dev.type == "cpu":
        plain(plan, xin, xout, k, omega, cnt_out)
        if packed is not None:
            xout.copy_(kc.collide_plain(xout, packed, ground))
        return
    _launch(plan, arity, xin, xout, k, omega, cnt_out, fn.__name__, packed,
            ground)
    count_launch(fn)


def jacobi_edge_pass(plan: EdgePassPlan, xin: torch.Tensor,
                     xout: torch.Tensor, k, omega,
                     cnt_out: Optional[torch.Tensor] = None) -> None:
    """One distance gather + apply stage from snapshot xin into xout.
    k: the stiffness (float32-exact; with a per-constraint table, its
    multiplier); omega: the SOR factor."""
    _pass(plan, 2, jacobi_edge_pass, jacobi_edge_pass_plain, xin, xout, k,
          omega, cnt_out)


jacobi_edge_pass.launches = 0


def jacobi_edge_pass_collide(plan: EdgePassPlan, xin: torch.Tensor,
                             xout: torch.Tensor, k, omega,
                             packed: torch.Tensor, ground: kc.Ground,
                             cnt_out: Optional[torch.Tensor] = None) -> None:
    """``jacobi_edge_pass``, then the collide stage (``collide.collide``:
    the ground plane, then the colliders of the packed table) on every free
    row of xout, in one launch.  Its plain version is the two plain
    versions in turn."""
    _pass(plan, 2, jacobi_edge_pass_collide, jacobi_edge_pass_plain, xin,
          xout, k, omega, cnt_out, packed, ground)


jacobi_edge_pass_collide.launches = 0


# --------------------------------------------------------------------------
# Tet pass
# --------------------------------------------------------------------------

def jacobi_tet_pass_plain(plan: TetPassPlan, xin: torch.Tensor,
                          xout: torch.Tensor, k, omega,
                          cnt_out: Optional[torch.Tensor] = None) -> None:
    x, w = xin[:, :3], xin[:, 3]
    delta, cnt = tet_jacobi_deltas(x, w, plan.tets.long(), plan.rest,
                                   _stiffness(plan, k), plan.num_particles)
    _write(xin, xout, apply_delta(x, w, delta, cnt, float(omega)), cnt,
           cnt_out)


def jacobi_tet_pass(plan: TetPassPlan, xin: torch.Tensor,
                    xout: torch.Tensor, k, omega,
                    cnt_out: Optional[torch.Tensor] = None) -> None:
    """One volume gather + apply stage from snapshot xin into xout."""
    _pass(plan, 4, jacobi_tet_pass, jacobi_tet_pass_plain, xin, xout, k,
          omega, cnt_out)


jacobi_tet_pass.launches = 0


def jacobi_tet_pass_collide(plan: TetPassPlan, xin: torch.Tensor,
                            xout: torch.Tensor, k, omega,
                            packed: torch.Tensor, ground: kc.Ground,
                            cnt_out: Optional[torch.Tensor] = None) -> None:
    """``jacobi_tet_pass`` with the collide stage fused, as
    ``jacobi_edge_pass_collide``."""
    _pass(plan, 4, jacobi_tet_pass_collide, jacobi_tet_pass_plain, xin,
          xout, k, omega, cnt_out, packed, ground)


jacobi_tet_pass_collide.launches = 0


# --------------------------------------------------------------------------
# Accumulate-only mode (the kernel-sharded Jacobi step's)
# --------------------------------------------------------------------------

def jacobi_edge_accumulate_plain(plan: EdgePassPlan, xin: torch.Tensor,
                                 acc: torch.Tensor, k) -> None:
    x, w = xin[:, :3], xin[:, 3]
    delta, cnt = edge_jacobi_deltas(x, w, plan.edges.long(), plan.rest,
                                    _stiffness(plan, k), plan.num_particles)
    acc[:, :3] = delta
    acc[:, 3] = cnt.to(torch.float32)


def jacobi_tet_accumulate_plain(plan: TetPassPlan, xin: torch.Tensor,
                                acc: torch.Tensor, k) -> None:
    x, w = xin[:, :3], xin[:, 3]
    delta, cnt = tet_jacobi_deltas(x, w, plan.tets.long(), plan.rest,
                                   _stiffness(plan, k), plan.num_particles)
    acc[:, :3] = delta
    acc[:, 3] = cnt.to(torch.float32)


def _accumulate(plan, arity, fn, plain, xin, acc, k) -> None:
    """Checks, then ``plain`` for tables on the CPU or one launch of the
    accumulate-only kernel of ``arity``, counted as ``fn``'s."""
    dev = _check_pass(plan, xin, acc, None)
    (_check_edge_plan if arity == 2 else _check_tet_plan)(plan, dev)
    k = _scalar(k, "k", dev)
    if dev.type == "cpu":
        plain(plan, xin, acc, k)
        return
    _launch(plan, arity, xin, acc, k, None, None, fn.__name__,
            accumulate=True)
    count_launch(fn)


def jacobi_edge_accumulate(plan: EdgePassPlan, xin: torch.Tensor,
                           acc: torch.Tensor, k) -> None:
    """The distance gather from snapshot xin, unapplied: acc (V, 4) gets
    per row (delta xyz, count as a float), as ``edge_jacobi_deltas``
    gives them.  k as for ``jacobi_edge_pass``."""
    _accumulate(plan, 2, jacobi_edge_accumulate,
                jacobi_edge_accumulate_plain, xin, acc, k)


jacobi_edge_accumulate.launches = 0


def jacobi_tet_accumulate(plan: TetPassPlan, xin: torch.Tensor,
                          acc: torch.Tensor, k) -> None:
    """The volume gather from snapshot xin, unapplied, as
    ``jacobi_edge_accumulate``."""
    _accumulate(plan, 4, jacobi_tet_accumulate,
                jacobi_tet_accumulate_plain, xin, acc, k)


jacobi_tet_accumulate.launches = 0
