"""PyTorch wrappers of the CUDA sweep kernels, each with its plain PyTorch
version beside it.

* ``w_fill``     -- replaces ``softbodysim_tpu/kernels/sweep.py::
  _w_fill_kernel``: the streamed inverse-mass table, once per carry pack.
* ``edge_sweep`` -- replaces ``_edge_kernel_super``: one XPBD distance sweep.
* ``tet_sweep``  -- replaces ``_tet_kernel_super``: one XPBD volume sweep.
* ``legacy_edge_sweep`` -- replaces ``_edge_kernel``: one XPBD distance
  sweep over the 128-wide blocks of a legacy SweepPlan.
* ``legacy_tet_sweep``  -- replaces ``_tet_kernel``: one XPBD volume sweep
  over the 128-wide blocks.

A wrapper runs its plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device (raising if the launch is refused); it
raises for any other device.  ``<wrapper>.launches`` counts the kernel
launches, and nothing else.  The sweeps update ``xw`` and ``lam`` in place
(the JAX kernels return new arrays; in place saves a table copy per sweep).

Tables (see ``sweep_plan.GpuPlan``): ``xw`` (Vpad, 4) f32 rows x, y, z,
inverse mass in layout order; ``lam`` (NB*width,) f32 in packed order
(width 1024 for the super-block sweeps, 128 for the legacy sweeps).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..collide.primitives import cross3
from .sweep_plan import BLOCK, LANES, GpuPlan

# guard constants as f32-exact doubles (compared in fp32 either way)
EPS_LEN = float(np.float32(1e-12))
EPS_WSUM = float(np.float32(1e-20))
SIXTH = float(np.float32(1.0 / 6.0))


class DevicePlan(NamedTuple):
    """A GpuPlan's tables on one device (int32 / f32, contiguous)."""

    arity: int
    num_blocks: int
    width: int
    split: bool
    verts: torch.Tensor
    rest: torch.Tensor
    scale: torch.Tensor
    counts: Optional[torch.Tensor]
    atab: Optional[torch.Tensor]
    blk_vptr: torch.Tensor
    cvert: torch.Tensor
    cptr: torch.Tensor
    centry: torch.Tensor
    # plain version only: CSR row / lane / role of every entry, and the
    # host copies of the CSR offsets used to slice one block
    cseg: torch.Tensor
    lane: torch.Tensor
    role: torch.Tensor
    vptr_host: np.ndarray
    cptr_host: np.ndarray


def to_device(plan: GpuPlan, device) -> DevicePlan:
    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(
            device)

    i32, f32, i64 = torch.int32, torch.float32, torch.int64
    return DevicePlan(
        arity=plan.arity, num_blocks=plan.num_blocks, width=plan.width,
        split=plan.scheme == "split",
        verts=t(plan.verts, i32), rest=t(plan.rest, f32),
        scale=t(plan.scale, f32),
        counts=None if plan.counts is None else t(plan.counts, f32),
        atab=None if plan.atab is None else t(plan.atab, f32),
        blk_vptr=t(plan.blk_vptr, i32), cvert=t(plan.cvert, i32),
        cptr=t(plan.cptr, i32), centry=t(plan.centry, i32),
        cseg=t(np.repeat(np.arange(len(plan.cvert)), np.diff(plan.cptr)),
               i64),
        lane=t(plan.centry >> 2, i64),
        role=t(plan.centry & 3, i64),
        vptr_host=plan.blk_vptr.astype(np.int64),
        cptr_host=plan.cptr.astype(np.int64))


# --------------------------------------------------------------------------
# Checks and launch plumbing
# --------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device.type == "cuda" and t.numel() and t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _check_plan(plan: DevicePlan, device, width: int = BLOCK) -> None:
    if plan.width != width:
        raise ValueError(f"plan of {plan.width}-wide blocks, this sweep "
                         f"takes {width}-wide blocks")
    n, a = plan.num_blocks * width, plan.arity
    _check(plan.verts, "plan.verts", torch.int32, (n, a), device)
    if width == BLOCK:
        _check(plan.counts, "plan.counts", torch.float32, (n, a), device)
    for name in ("rest", "scale"):
        _check(getattr(plan, name), f"plan.{name}", torch.float32, (n,),
               device)
    if plan.atab is not None:
        _check(plan.atab, "plan.atab", torch.float32, (n,), device)
    _check(plan.blk_vptr, "plan.blk_vptr", torch.int32,
           (plan.num_blocks + 1,), device)
    u = plan.cvert.shape[0]
    _check(plan.cvert, "plan.cvert", torch.int32, (u,), device)
    _check(plan.cptr, "plan.cptr", torch.int32, (u + 1,), device)
    _check(plan.centry, "plan.centry", torch.int32,
           (plan.centry.shape[0],), device)


def _check_xw(xw: torch.Tensor) -> torch.device:
    if not isinstance(xw, torch.Tensor) or xw.dim() != 2 \
            or xw.shape[1] != 4:
        raise ValueError("xw must be a (Vpad, 4) tensor")
    dev = xw.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _check(xw, "xw", torch.float32, xw.shape, dev)
    return dev


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaGetLastError()"
                           f" = {rc}")


def _lib():
    from ._build import load

    return load()


# --------------------------------------------------------------------------
# w_fill
# --------------------------------------------------------------------------

def w_fill_plain(plan: DevicePlan, xw: torch.Tensor) -> torch.Tensor:
    """Edges: (n,) c0*w0 + c1*w1.  Tets: (n, 4) c_r*w_r.  Pads: w = 0."""
    v = plan.verts.long()
    w = torch.where(v >= 0, xw[:, 3][v.clamp_min(0)], 0.0)
    wc = w * plan.counts
    if plan.arity == 2:
        return wc[:, 0] + wc[:, 1]
    return wc.contiguous()


def w_fill(plan: DevicePlan, xw: torch.Tensor) -> torch.Tensor:
    dev = _check_xw(xw)
    _check_plan(plan, dev)
    if dev.type == "cpu":
        return w_fill_plain(plan, xw)
    n = plan.num_blocks * BLOCK
    out = torch.empty((n,) if plan.arity == 2 else (n, plan.arity),
                      dtype=torch.float32, device=dev)
    rc = _lib().sbs_w_fill(_ptr(plan.verts), _ptr(plan.counts), _ptr(xw),
                           _ptr(out), n, plan.arity, _stream(dev))
    _raise_on(rc, "w_fill")
    w_fill.launches += 1
    return out


w_fill.launches = 0


# --------------------------------------------------------------------------
# Sweeps: plain versions (a Python loop over blocks in plan order, each
# block vectorized over its lanes; one version per family for both block
# widths) and the kernel wrappers
# --------------------------------------------------------------------------

def _block_csr(plan: DevicePlan, b: int):
    """Block b's CSR: (row vertex ids, entry lanes, entry roles, entry
    rows relative to the block)."""
    u0, u1 = int(plan.vptr_host[b]), int(plan.vptr_host[b + 1])
    e0, e1 = int(plan.cptr_host[u0]), int(plan.cptr_host[u1])
    return (plan.cvert[u0:u1].long(), plan.lane[e0:e1], plan.role[e0:e1],
            plan.cseg[e0:e1] - u0)


def _apply(xw, cv, seg, contrib):
    """Add each CSR row's summed contributions to its vertex."""
    acc = torch.zeros((cv.shape[0], 3), dtype=xw.dtype, device=xw.device)
    acc.index_add_(0, seg, contrib)
    xw[cv, :3] = xw[cv, :3] + acc


def edge_sweep_plain(plan: DevicePlan, xw: torch.Tensor, lam: torch.Tensor,
                     wsum: Optional[torch.Tensor], alpha: float,
                     local_iters: int = 1) -> None:
    """On a legacy 128-wide plan ``wsum`` is None: w0 + w1 come from xw and
    the normal is d / |d|, as in the legacy kernel."""
    legacy = plan.width == LANES
    W = plan.width
    verts = plan.verts.long()
    for b in range(plan.num_blocks):
        sl = slice(b * W, (b + 1) * W)
        v = verts[sl]
        live = v[:, 0] >= 0
        v = v.clamp_min(0)
        al = alpha * plan.atab[sl] if plan.atab is not None else alpha
        cv, lane, role, seg = _block_csr(plan, b)
        l = lam[sl]
        for _ in range(local_iters):
            a0, a1 = xw[v[:, 0]], xw[v[:, 1]]
            d = a0[:, :3] - a1[:, :3]
            dx, dy, dz = d.unbind(1)
            length = torch.sqrt(dx * dx + dy * dy + dz * dz)
            ws = a0[:, 3] + a1[:, 3] if legacy else wsum[sl]
            valid = live & (ws != 0.0) & (length >= EPS_LEN)
            c = length - plan.rest[sl]
            denom = ws + al
            dlam = torch.where(
                valid, (-c - al * l) / torch.where(denom == 0.0, 1.0, denom),
                0.0)
            dlam = dlam * plan.scale[sl]
            l = l + dlam
            nl = torch.where(length < EPS_LEN, 1.0, length)[:, None]
            n = d / nl if legacy else d * (1.0 / nl)
            corr = n * dlam[:, None]
            wt = xw[cv, 3][seg]
            f = torch.where(role == 0, wt, -wt)
            _apply(xw, cv, seg, corr[lane] * f[:, None])
        lam[sl] = l


def tet_sweep_plain(plan: DevicePlan, xw: torch.Tensor, lam: torch.Tensor,
                    wtab: Optional[torch.Tensor], alpha: float,
                    local_iters: int = 1) -> None:
    """On a legacy 128-wide plan ``wtab`` is None: the w_r come from xw and
    the volume is (cross . e) times the f32 sixth, as in the legacy
    kernel."""
    legacy = plan.width == LANES
    W = plan.width
    verts = plan.verts.long()
    for b in range(plan.num_blocks):
        sl = slice(b * W, (b + 1) * W)
        v = verts[sl]
        live = v[:, 0] >= 0
        v = v.clamp_min(0)
        w = None if legacy else wtab[sl]
        al = alpha * plan.atab[sl] if plan.atab is not None else alpha
        cv, lane, role, seg = _block_csr(plan, b)
        l = lam[sl]
        for _ in range(local_iters):
            a = [xw[v[:, k]] for k in range(4)]
            pa, pb, pc, pd = (t[:, :3] for t in a)
            if legacy:
                w = torch.stack([t[:, 3] for t in a], 1)        # (W, 4)
            cd = cross3(pb - pa, pc - pa)
            g = torch.stack([
                cross3(pd - pb, pc - pb), cross3(pc - pa, pd - pa),
                cross3(pd - pa, pb - pa), cd], 1) * SIXTH        # (W, 4, 3)
            n2 = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]
                  + g[..., 2] * g[..., 2])
            wn = w * n2
            wsum = ((wn[:, 0] + wn[:, 1]) + wn[:, 2]) + wn[:, 3]
            wtot = ((w[:, 0] + w[:, 1]) + w[:, 2]) + w[:, 3]
            valid = live & (wtot != 0.0) & (wsum >= EPS_WSUM)
            e = pd - pa
            gd = cd if legacy else g[:, 3]
            vol = gd[:, 0] * e[:, 0] + gd[:, 1] * e[:, 1] + gd[:, 2] * e[:, 2]
            if legacy:
                vol = vol * SIXTH
            cfn = vol - plan.rest[sl]
            denom = wsum + al
            dlam = torch.where(
                valid,
                (-cfn - al * l) / torch.where(denom == 0.0, 1.0, denom), 0.0)
            dlam = dlam * plan.scale[sl]
            l = l + dlam
            s = dlam[:, None].expand(-1, 4) if plan.split else w * dlam[:, None]
            contrib = (g * s[..., None])[lane, role]
            if plan.split:           # mass splitting: plain w of the target
                contrib = contrib * xw[cv, 3][seg][:, None]
            _apply(xw, cv, seg, contrib)
        lam[sl] = l


def _check_sweep(plan, xw, lam, wtab, wshape):
    dev = _check_xw(xw)
    _check_plan(plan, dev)
    n = plan.num_blocks * BLOCK
    _check(lam, "lam", torch.float32, (n,), dev)
    _check(wtab, "wtab", torch.float32, wshape, dev)
    return dev


def edge_sweep(plan: DevicePlan, xw: torch.Tensor, lam: torch.Tensor,
               wsum: torch.Tensor, alpha: float,
               local_iters: int = 1) -> None:
    """One distance sweep over every block, in place on xw and lam.
    alpha: compliance / sdt^2 (f32-exact); with a per-constraint table
    (plan.atab) the per-lane alpha is alpha * atab."""
    if plan.arity != 2:
        raise ValueError("edge_sweep needs an edge (arity 2) plan")
    dev = _check_sweep(plan, xw, lam, wsum, (plan.num_blocks * BLOCK,))
    if dev.type == "cpu":
        return edge_sweep_plain(plan, xw, lam, wsum, alpha, local_iters)
    rc = _lib().sbs_edge_sweep(
        _ptr(xw), _ptr(lam), _ptr(plan.verts), _ptr(plan.rest),
        _ptr(plan.scale), _ptr(plan.atab), _ptr(wsum), _ptr(plan.blk_vptr),
        _ptr(plan.cvert), _ptr(plan.cptr), _ptr(plan.centry),
        plan.num_blocks, float(alpha), int(local_iters), _stream(dev))
    _raise_on(rc, "edge_sweep")
    edge_sweep.launches += 1


edge_sweep.launches = 0


def tet_sweep(plan: DevicePlan, xw: torch.Tensor, lam: torch.Tensor,
              wtab: torch.Tensor, alpha: float,
              local_iters: int = 1) -> None:
    """One volume sweep over every block, in place on xw and lam."""
    if plan.arity != 4:
        raise ValueError("tet_sweep needs a tet (arity 4) plan")
    dev = _check_sweep(plan, xw, lam, wtab, (plan.num_blocks * BLOCK, 4))
    if dev.type == "cpu":
        return tet_sweep_plain(plan, xw, lam, wtab, alpha, local_iters)
    rc = _lib().sbs_tet_sweep(
        _ptr(xw), _ptr(lam), _ptr(plan.verts), _ptr(plan.rest),
        _ptr(plan.scale), _ptr(plan.atab), _ptr(wtab), _ptr(plan.blk_vptr),
        _ptr(plan.cvert), _ptr(plan.cptr), _ptr(plan.centry),
        plan.num_blocks, float(alpha), int(local_iters), int(plan.split),
        _stream(dev))
    _raise_on(rc, "tet_sweep")
    tet_sweep.launches += 1


tet_sweep.launches = 0


# --------------------------------------------------------------------------
# Legacy 128-wide sweeps (superblocks=False): the scale scheme only, w read
# from the particle table, one visit per block.  Their plain versions are
# edge_sweep_plain / tet_sweep_plain on a 128-wide plan, which follow the
# JAX legacy kernels' rounding, so kernel and plain differ only in the
# order a vertex's corrections are summed.
# --------------------------------------------------------------------------

def _check_legacy(plan, xw, lam, arity, name):
    if plan.arity != arity:
        raise ValueError(f"{name} needs an arity-{arity} plan")
    dev = _check_xw(xw)
    _check_plan(plan, dev, LANES)
    _check(lam, "lam", torch.float32, (plan.num_blocks * LANES,), dev)
    return dev


def legacy_edge_sweep(plan: DevicePlan, xw: torch.Tensor, lam: torch.Tensor,
                      alpha: float) -> None:
    """One distance sweep over every 128-wide block of a legacy plan, in
    place on xw and lam (alpha as for ``edge_sweep``)."""
    dev = _check_legacy(plan, xw, lam, 2, "legacy_edge_sweep")
    if dev.type == "cpu":
        return edge_sweep_plain(plan, xw, lam, None, alpha)
    rc = _lib().sbs_legacy_edge_sweep(
        _ptr(xw), _ptr(lam), _ptr(plan.verts), _ptr(plan.rest),
        _ptr(plan.scale), _ptr(plan.atab), _ptr(plan.blk_vptr),
        _ptr(plan.cvert), _ptr(plan.cptr), _ptr(plan.centry),
        plan.num_blocks, float(alpha), _stream(dev))
    _raise_on(rc, "legacy_edge_sweep")
    legacy_edge_sweep.launches += 1


legacy_edge_sweep.launches = 0


def legacy_tet_sweep(plan: DevicePlan, xw: torch.Tensor, lam: torch.Tensor,
                     alpha: float) -> None:
    """One volume sweep over every 128-wide block of a legacy plan, in
    place on xw and lam."""
    dev = _check_legacy(plan, xw, lam, 4, "legacy_tet_sweep")
    if dev.type == "cpu":
        return tet_sweep_plain(plan, xw, lam, None, alpha)
    rc = _lib().sbs_legacy_tet_sweep(
        _ptr(xw), _ptr(lam), _ptr(plan.verts), _ptr(plan.rest),
        _ptr(plan.scale), _ptr(plan.atab), _ptr(plan.blk_vptr),
        _ptr(plan.cvert), _ptr(plan.cptr), _ptr(plan.centry),
        plan.num_blocks, float(alpha), _stream(dev))
    _raise_on(rc, "legacy_tet_sweep")
    legacy_tet_sweep.launches += 1


legacy_tet_sweep.launches = 0
