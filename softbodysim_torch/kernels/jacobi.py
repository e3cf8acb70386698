"""PyTorch wrappers of the CUDA Jacobi pass kernels (``csrc/jacobi.cu``),
each with its plain PyTorch version beside it.

* ``jacobi_edge_pass`` -- replaces ``softbodysim_tpu/kernels/jacobi.py::
  _edge_pass_kernel``: one distance gather + apply stage.
* ``jacobi_tet_pass``  -- replaces ``_tet_pass_kernel``: one volume gather +
  apply stage (two kernel launches: per-tet gradients, per-vertex gather).

Both read the snapshot ``xin`` and write ``xout``, two distinct (V, 4) f32
tables of rows x, y, z, inverse mass in public vertex order; the caller
swaps them (a pass that wrote the table it reads would be Gauss-Seidel).
The plain versions are the segment formulation: the per-constraint math
defined here (``edge_jacobi_deltas``, ``tet_jacobi_deltas``, each an
``index_add_`` into (delta, count)) then ``apply_delta``; the solver's
segment and gather backends import that math from here.  A wrapper runs its
plain version for tables on the CPU and launches its kernel for tables on
a CUDA device, raising if the launch is refused; ``<wrapper>.launches``
counts the kernel launches and nothing else.  ``cnt_out`` (optional, (V,)
int32) receives each particle's constraint count.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..collide.primitives import cross3, dot3
from ..core.adjacency import build_edge_adjacency, build_tet_adjacency
from ..core.state import f32, resolve_device
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
    a scalar or an (E,) tensor."""
    a, b = edges[:, 0], edges[:, 1]
    wa, wb = inv_mass[a], inv_mass[b]
    w = wa + wb
    d = x_pred[a] - x_pred[b]
    len2 = dot3(d, d)
    valid = (w != 0.0) & (len2 >= EPS_LEN2)
    length = torch.sqrt(len2.clamp_min(EPS_SQRT))
    n = d / length[:, None]
    lam = torch.where(
        valid, -stiffness * ((length - edge_rest)
                             / torch.where(w == 0.0, 1.0, w)), 0.0)
    delta = torch.zeros_like(x_pred)
    delta.index_add_(0, a, n * (lam * wa)[:, None])
    delta.index_add_(0, b, -n * (lam * wb)[:, None])
    vi = valid.to(torch.int32)
    cnt = torch.zeros(nv, dtype=torch.int32, device=x_pred.device)
    cnt.index_add_(0, a, vi)
    cnt.index_add_(0, b, vi)
    return delta, cnt


def _tet_gradients(pa, pb, pc, pd):
    """Role gradients g_a..g_d (each (T, 3)) and the signed volume."""
    ga = cross3(pd - pb, pc - pb) / 6.0
    gb = cross3(pc - pa, pd - pa) / 6.0
    gc = cross3(pd - pa, pb - pa) / 6.0
    gd = cross3(pb - pa, pc - pa) / 6.0
    vol = dot3(cross3(pb - pa, pc - pa), pd - pa) / 6.0
    return (ga, gb, gc, gd), vol


def tet_lambda(x_pred, inv_mass, tets, tet_rest_vol, stiffness):
    """(gradients, corner inverse masses, lambda, valid) per tet."""
    corners = [tets[:, r] for r in range(4)]
    ws = [inv_mass[c] for c in corners]
    gs, vol = _tet_gradients(*(x_pred[c] for c in corners))
    wsum = ws[0] * dot3(gs[0], gs[0])
    for r in range(1, 4):
        wsum = wsum + ws[r] * dot3(gs[r], gs[r])
    valid = (((ws[0] + ws[1]) + ws[2]) + ws[3] != 0.0) & (wsum >= EPS_WSUM)
    lam = torch.where(
        valid, -stiffness * ((vol - tet_rest_vol)
                             / torch.where(wsum == 0.0, 1.0, wsum)), 0.0)
    return corners, gs, ws, lam, valid


def tet_jacobi_deltas(x_pred, inv_mass, tets, tet_rest_vol, stiffness, nv):
    """Per-particle (delta, count) from all volume constraints: role
    gradient * (lambda * w_role); a corner counts only when its tet is
    valid and its w != 0 (SoftBodySolver.cs:461-515)."""
    corners, gs, ws, lam, valid = tet_lambda(x_pred, inv_mass, tets,
                                              tet_rest_vol, stiffness)
    delta = torch.zeros_like(x_pred)
    cnt = torch.zeros(nv, dtype=torch.int32, device=x_pred.device)
    for c, g, w in zip(corners, gs, ws):
        delta.index_add_(0, c, g * (lam * w)[:, None])
        cnt.index_add_(0, c, (valid & (w != 0.0)).to(torch.int32))
    return delta, cnt


def apply_delta(x_pred, inv_mass, delta, cnt, omega):
    """x += (omega / cnt) * delta for free particles with cnt > 0
    (SoftBodySolver.cs:521-527)."""
    ok = (cnt > 0) & (inv_mass != 0.0)
    cntf = cnt.to(x_pred.dtype).clamp_min(1.0)
    scale = torch.full_like(cntf, f32(omega)) / cntf
    return torch.where(ok[:, None], x_pred + scale[:, None] * delta, x_pred)


class EdgePassPlan(NamedTuple):
    """The distance constraints of one topology on one device."""

    num_particles: int
    row: torch.Tensor              # (V+1,) int32 CSR offsets
    ent: torch.Tensor              # (2E, 2) int32 (other endpoint, edge)
    rest: torch.Tensor             # (E,) f32
    k: Optional[torch.Tensor]      # (E,) f32 per-constraint stiffness
    edges: torch.Tensor            # (E, 2) int32, the plain version's


class TetPassPlan(NamedTuple):
    """The volume constraints of one topology on one device."""

    num_particles: int
    tets: torch.Tensor             # (T, 4) int32
    rest: torch.Tensor             # (T,) f32
    k: Optional[torch.Tensor]      # (T,) f32 per-constraint stiffness
    row: torch.Tensor              # (V+1,) int32 CSR offsets
    slot: torch.Tensor             # (4T,) int32 role * T + tet


def _t(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a)).to(device, dtype)


def _k_table(k, n, device):
    if k is None:
        return None
    k = np.asarray(k, np.float32).reshape(-1)
    if k.shape[0] != n:
        raise ValueError(f"per-constraint stiffness: {k.shape[0]} values "
                         f"for {n} constraints")
    return _t(k, torch.float32, device)


def edge_pass_plan(num_particles: int, edges, edge_rest, k=None,
                   device=None) -> EdgePassPlan:
    """CSR of incident edges per vertex (``build_edge_adjacency`` order)
    and the edge tables, on ``device`` (default: the card)."""
    dev = resolve_device(device)
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    off, other, eidx = build_edge_adjacency(num_particles, edges)
    i32 = torch.int32
    return EdgePassPlan(
        num_particles=num_particles, row=_t(off, i32, dev),
        ent=_t(np.stack([other, eidx], 1), i32, dev),
        rest=_t(np.asarray(edge_rest, np.float32), torch.float32, dev),
        k=_k_table(k, len(edges), dev), edges=_t(edges, i32, dev))


def tet_pass_plan(num_particles: int, tets, tet_rest_vol, k=None,
                  device=None) -> TetPassPlan:
    """CSR of incident (tet, role) slots per vertex (``build_tet_adjacency``
    order, slot = role * T + tet) and the tet tables, on ``device``."""
    dev = resolve_device(device)
    tets = np.asarray(tets, np.int64).reshape(-1, 4)
    off, tidx, role = build_tet_adjacency(num_particles, tets)
    i32 = torch.int32
    return TetPassPlan(
        num_particles=num_particles, tets=_t(tets, i32, dev),
        rest=_t(np.asarray(tet_rest_vol, np.float32), torch.float32, dev),
        k=_k_table(k, len(tets), dev), row=_t(off, i32, dev),
        slot=_t(role * len(tets) + tidx, i32, dev))


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


def _check_edge_plan(plan: EdgePassPlan, dev) -> None:
    v, e = plan.num_particles, plan.rest.shape[0]
    _check(plan.row, "plan.row", torch.int32, (v + 1,), dev)
    _check(plan.ent, "plan.ent", torch.int32, (2 * e, 2), dev)
    _check(plan.rest, "plan.rest", torch.float32, (e,), dev)
    if plan.k is not None:
        _check(plan.k, "plan.k", torch.float32, (e,), dev)
    _check(plan.edges, "plan.edges", torch.int32, (e, 2), dev)


def _check_tet_plan(plan: TetPassPlan, dev) -> None:
    v, t = plan.num_particles, plan.rest.shape[0]
    _check(plan.tets, "plan.tets", torch.int32, (t, 4), dev)
    _check(plan.rest, "plan.rest", torch.float32, (t,), dev)
    if plan.k is not None:
        _check(plan.k, "plan.k", torch.float32, (t,), dev)
    _check(plan.row, "plan.row", torch.int32, (v + 1,), dev)
    _check(plan.slot, "plan.slot", torch.int32, (4 * t,), dev)


def _stiffness(plan, k: float):
    """k, or the per-constraint table times k (the scalar multiplies)."""
    return k if plan.k is None else plan.k * k


def _write(xin, xout, x_new, cnt, cnt_out) -> None:
    xout[:, :3] = x_new
    xout[:, 3] = xin[:, 3]
    if cnt_out is not None:
        cnt_out.copy_(cnt)


# --------------------------------------------------------------------------
# Edge pass
# --------------------------------------------------------------------------

def jacobi_edge_pass_plain(plan: EdgePassPlan, xin: torch.Tensor,
                           xout: torch.Tensor, k: float, omega: float,
                           cnt_out: Optional[torch.Tensor] = None) -> None:
    x, w = xin[:, :3], xin[:, 3]
    delta, cnt = edge_jacobi_deltas(x, w, plan.edges.long(), plan.rest,
                                    _stiffness(plan, k), plan.num_particles)
    _write(xin, xout, apply_delta(x, w, delta, cnt, omega), cnt, cnt_out)


def jacobi_edge_pass(plan: EdgePassPlan, xin: torch.Tensor,
                     xout: torch.Tensor, k: float, omega: float,
                     cnt_out: Optional[torch.Tensor] = None) -> None:
    """One distance gather + apply stage from snapshot xin into xout.
    k: the stiffness (float32-exact; with a per-constraint table, its
    multiplier); omega: the SOR factor."""
    dev = _check_pass(plan, xin, xout, cnt_out)
    _check_edge_plan(plan, dev)
    if dev.type == "cpu":
        return jacobi_edge_pass_plain(plan, xin, xout, k, omega, cnt_out)
    f = ctypes.c_float
    rc = _lib().sbs_jacobi_edge_pass(
        _ptr(xin), _ptr(xout), _ptr(plan.row), _ptr(plan.ent),
        _ptr(plan.rest), _ptr(plan.k), plan.num_particles, f(k), f(omega),
        _ptr(cnt_out), _stream(dev))
    _raise_on(rc, "jacobi_edge_pass")
    jacobi_edge_pass.launches += 1


jacobi_edge_pass.launches = 0


# --------------------------------------------------------------------------
# Tet pass
# --------------------------------------------------------------------------

def jacobi_tet_pass_plain(plan: TetPassPlan, xin: torch.Tensor,
                          xout: torch.Tensor, k: float, omega: float,
                          cnt_out: Optional[torch.Tensor] = None) -> None:
    x, w = xin[:, :3], xin[:, 3]
    delta, cnt = tet_jacobi_deltas(x, w, plan.tets.long(), plan.rest,
                                   _stiffness(plan, k), plan.num_particles)
    _write(xin, xout, apply_delta(x, w, delta, cnt, omega), cnt, cnt_out)


def jacobi_tet_pass(plan: TetPassPlan, xin: torch.Tensor,
                    xout: torch.Tensor, k: float, omega: float,
                    cnt_out: Optional[torch.Tensor] = None) -> None:
    """One volume gather + apply stage from snapshot xin into xout."""
    dev = _check_pass(plan, xin, xout, cnt_out)
    _check_tet_plan(plan, dev)
    if dev.type == "cpu":
        return jacobi_tet_pass_plain(plan, xin, xout, k, omega, cnt_out)
    nt = plan.rest.shape[0]
    glam = torch.empty((4 * nt, 4), dtype=torch.float32, device=dev)
    f = ctypes.c_float
    rc = _lib().sbs_jacobi_tet_pass(
        _ptr(xin), _ptr(xout), _ptr(plan.tets), _ptr(plan.rest),
        _ptr(plan.k), _ptr(glam), _ptr(plan.row), _ptr(plan.slot),
        plan.num_particles, nt, f(k), f(omega), _ptr(cnt_out), _stream(dev))
    _raise_on(rc, "jacobi_tet_pass")
    jacobi_tet_pass.launches += 1


jacobi_tet_pass.launches = 0
