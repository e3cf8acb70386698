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
launches on the f32 table, and nothing else; ``w_fill_bf16``,
``edge_sweep_bf16`` and ``tet_sweep_bf16`` count the launches of the same
wrappers' bf16 instantiations.  The sweeps update ``xw`` and ``lam`` in
place (the JAX kernels return new arrays; in place saves a table copy per
sweep).

Tables (see ``sweep_plan.GpuPlan``): ``xw`` (Vpad, 4) rows x, y, z,
inverse mass in layout order; ``lam`` (NB*width,) f32 in packed order
(width 1024 for the super-block sweeps, 128 for the legacy sweeps).

The particle table is f32, or bf16 on the super-block path (the JAX
package's ``SolverParams.xpbd_x_dtype="bfloat16"``, ``make_sweep(...,
x_dtype=)``): every read upcasts to f32, the arithmetic is f32, and each
block visit adds each row's f32 sum and rounds the row back to bf16 (the
JAX kernels' per-window read-modify-write, ``_scatter_super``), so a
revisit reads rounded positions.  w is never written.  The legacy sweeps
take the f32 table only, as the JAX legacy kernels.

On a CUDA device a sweep runs the plan's blocks as a dependency schedule
over Q persistent CTAs (``sweep_plan.stage_plan``; Q from the card's
occupancy unless ``to_device`` is given ``queues``), in the plan's exact
block order: bit for bit what one CTA walking the plan gives.  Launches of
one plan must stay on one stream (they share its flag buffer).  A launch
that waits more than 2 s for a block aborts and sets its plan's own
timed-out word (pinned host memory the kernel writes), so the timeout is
reported to the plan's owner: its next sweep call raises.
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..collide.primitives import cross3
from . import LaunchCounter, count_launch
from . import sweep_plan as sp
from .sweep_plan import BLOCK, LANES, GpuPlan

# guard constants as f32-exact doubles (compared in fp32 either way)
EPS_LEN = float(np.float32(1e-12))
EPS_WSUM = float(np.float32(1e-20))
SIXTH = float(np.float32(1.0 / 6.0))


# kernel kind of sweep.cu's sbs_sweep, by (arity, block width, table dtype)
_KIND = {(2, BLOCK, torch.float32): 0, (4, BLOCK, torch.float32): 1,
         (2, LANES, torch.float32): 2, (4, LANES, torch.float32): 3,
         (2, BLOCK, torch.bfloat16): 4, (4, BLOCK, torch.bfloat16): 5}
# the particle tables the super-block kernels take (the legacy ones: f32)
TABLE_DTYPES = (torch.float32, torch.bfloat16)


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)


class Staged:
    """What the CUDA sweep kernels read besides the per-lane tables: a
    plan's schedule on the card (``sweep_plan.StagedPlan``), its flag
    buffer and the launch epoch.

    capacity: Q, the queues the schedule was built for; queues: the CTAs
    it uses (non-empty queues); levels, length: the schedule's dependency
    levels and length in blocks; nstages, smem_bytes: shared-memory stages
    and bytes per CTA."""

    def __init__(self, plan: GpuPlan, device, capacity: int, nstages: int,
                 smem_bytes: int, st: Optional[sp.StagedPlan] = None):
        if st is None:
            st = sp.stage_plan(plan, capacity)
        sched = st.schedule

        def t(a, dtype):
            return _tensor(a, dtype, device)

        self.capacity, self.nstages = int(capacity), int(nstages)
        self.smem_bytes = int(smem_bytes)
        self.queues, self.levels = sched.queues, sched.levels
        self.length = sched.length
        self.max_rows, self.max_rec = st.max_rows, st.max_rec
        self.lrow = t(st.lrow, torch.int16)
        self.rec = t(st.rec, torch.int32)
        self.qinfo = t(st.qinfo, torch.int32)
        self.qptr = t(sched.qptr, torch.int32)
        # per block the epoch of its last release; [NB] the abort word
        self.flags = torch.zeros(plan.num_blocks + 1, dtype=torch.int32,
                                 device=device)
        self.epoch = 0
        # 1 once a launch of this plan has aborted on a timed-out wait:
        # pinned host memory (addressable by the card), read and reset by
        # raise_on_timeouts
        self.timeouts = torch.zeros(1, dtype=torch.int32, pin_memory=True)
        with _STAGED_LOCK:
            _STAGED.add(self)


# every live schedule on the card, for raise_on_timeouts() without a plan
_STAGED = weakref.WeakSet()
_STAGED_LOCK = threading.Lock()


class DevicePlan(NamedTuple):
    """A GpuPlan's tables on one device (int32 / f32, contiguous); on a
    CUDA device also the kernels' schedule (``staged``)."""

    arity: int
    num_blocks: int
    width: int
    split: bool
    verts: torch.Tensor
    rest: torch.Tensor
    scale: torch.Tensor
    counts: Optional[torch.Tensor]
    atab: Optional[torch.Tensor]
    # plain version only: the CSR rows' vertices, per entry its row / lane /
    # role, and the host copies of the CSR offsets used to slice one block
    # (the kernels read the CSR from ``staged``)
    cvert: torch.Tensor
    cseg: torch.Tensor
    lane: torch.Tensor
    role: torch.Tensor
    vptr_host: np.ndarray
    cptr_host: np.ndarray
    staged: Optional[Staged] = None


def card_queues(plan: GpuPlan) -> tuple:
    """(Q, stages, bytes): how many CTAs of the plan's sweep kernel the
    current CUDA device holds at once (SMs x CTAs per SM, the occupancy
    API), the shared-memory stages per CTA that fit (2, else 1) and a
    CTA's shared memory.  One schedule serves every table the kernel
    takes (its f32 and bf16 instantiations share a shared-memory layout):
    Q is the least any of them holds."""
    rows, rec = sp.stage_bounds(plan)
    nst, smem = ctypes.c_int(0), ctypes.c_int(0)
    q = min(_lib().sbs_sweep_ctas(kind, int(plan.atab is not None), rows,
                                  rec, ctypes.byref(nst), ctypes.byref(smem))
            for (a, w, _), kind in _KIND.items()
            if (a, w) == (plan.arity, plan.width))
    if q < 0:
        raise RuntimeError(f"sbs_sweep_ctas: CUDA error {-q}")
    if q == 0:
        raise ValueError(f"a block of this plan ({rows} rows, {rec} record "
                         "ints) does not fit in one CTA's shared memory")
    return q, nst.value, smem.value


def host_stage(plan: GpuPlan, device, queues: Optional[int] = None
               ) -> Optional[tuple]:
    """(Q, stages, bytes, StagedPlan): the plan's schedule over ``queues``
    persistent CTAs of ``device``'s card (default: as many as it holds at
    once; 1 is plan order on one CTA, for tests), built on the host (the
    occupancy query launches nothing); None on a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    with torch.cuda.device(device):
        q, nst, smem = card_queues(plan)
    if queues is not None:
        if not 1 <= queues <= q:
            raise ValueError(f"queues={queues}: the card holds 1..{q} "
                             "CTAs of this sweep at once")
        q = queues
    return q, nst, smem, sp.stage_plan(plan, q)


def to_device(plan: GpuPlan, device, queues: Optional[int] = None,
              stage: Optional[tuple] = None) -> DevicePlan:
    """The plan's tables on ``device``; on a CUDA device also its schedule
    (``stage``, else ``host_stage(plan, device, queues)``)."""
    device = torch.device(device)

    def t(a, dtype):
        return _tensor(a, dtype, device)

    if stage is None:
        stage = host_stage(plan, device, queues)
    staged = None if stage is None else Staged(plan, device, *stage)
    i32, f32, i64 = torch.int32, torch.float32, torch.int64
    return DevicePlan(
        arity=plan.arity, num_blocks=plan.num_blocks, width=plan.width,
        split=plan.scheme == "split",
        verts=t(plan.verts, i32), rest=t(plan.rest, f32),
        scale=t(plan.scale, f32),
        counts=None if plan.counts is None else t(plan.counts, f32),
        atab=None if plan.atab is None else t(plan.atab, f32),
        cvert=t(plan.cvert, i32),
        cseg=t(np.repeat(np.arange(len(plan.cvert)), np.diff(plan.cptr)),
               i64),
        lane=t(plan.centry >> 2, i64),
        role=t(plan.centry & 3, i64),
        vptr_host=plan.blk_vptr.astype(np.int64),
        cptr_host=plan.cptr.astype(np.int64), staged=staged)


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
    _check(plan.cvert, "plan.cvert", torch.int32, (plan.cvert.shape[0],),
           device)


def _check_xw(xw: torch.Tensor, dtypes=TABLE_DTYPES) -> torch.device:
    if not isinstance(xw, torch.Tensor) or xw.dim() != 2 \
            or xw.shape[1] != 4:
        raise ValueError("xw must be a (Vpad, 4) tensor")
    dev = xw.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if xw.dtype not in dtypes:
        raise TypeError(f"xw: dtype {xw.dtype}, expected one of "
                        f"{', '.join(str(d) for d in dtypes)}")
    _check(xw, "xw", xw.dtype, xw.shape, dev)
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


class _SweepArgs(ctypes.Structure):
    """sweep.cu's SweepArgs."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "xw", "lam", "lrow", "rest", "scale", "atab", "wt", "rec", "qinfo",
        "qptr", "flags", "timeouts")]
        + [(n, ctypes.c_int) for n in (
            "nqueues", "nblocks", "max_rows", "max_rec", "nstages", "epoch")]
        + [("alpha", ctypes.c_float), ("local_iters", ctypes.c_int),
           ("ms", ctypes.c_int)])


def _addr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def raise_on_timeouts(*staged: Staged) -> None:
    """Raise if a sweep launch of one of the ``staged`` plans (default: of
    any live plan) aborted on a wait of more than 2 s since the last check;
    every word checked is reset.  The kernels report it in the plan's
    pinned host word; the sweep wrappers check their plan's before every
    launch, a caller after a synchronize."""
    plans = staged
    if not plans:
        with _STAGED_LOCK:
            plans = list(_STAGED)
    aborted = False
    for st in plans:
        if st.timeouts.item():
            st.timeouts.zero_()
            aborted = True
    if aborted:
        raise RuntimeError("a CUDA sweep launch timed out waiting for a "
                           "block and aborted: its results are not valid")


def _launch_sweep(name, plan: DevicePlan, xw, lam, wt, alpha, local_iters,
                  ms) -> None:
    """One cooperative launch of the plan's sweep kernel over its
    schedule's CTAs."""
    st = plan.staged
    if st is None:
        raise ValueError(f"{name}: the plan has no kernel schedule (make it "
                         "with to_device on the CUDA device)")
    raise_on_timeouts(st)
    # A block's flag holds the epoch of the launch that last released it,
    # so flags are never reset; the epoch is a host counter, which a CUDA
    # graph capturing this launch would freeze (the sweeps are not
    # captured).  It runs through the int32 range; the kernel compares
    # differences.
    st.epoch = (st.epoch + 1 + 2**31) % 2**32 - 2**31
    args = _SweepArgs(
        xw=xw.data_ptr(), lam=lam.data_ptr(), lrow=st.lrow.data_ptr(),
        rest=plan.rest.data_ptr(), scale=plan.scale.data_ptr(),
        atab=_addr(plan.atab), wt=_addr(wt), rec=st.rec.data_ptr(),
        qinfo=st.qinfo.data_ptr(), qptr=st.qptr.data_ptr(),
        flags=st.flags.data_ptr(), timeouts=st.timeouts.data_ptr(),
        nqueues=st.queues,
        nblocks=plan.num_blocks, max_rows=st.max_rows, max_rec=st.max_rec,
        nstages=st.nstages, epoch=st.epoch, alpha=float(alpha),
        local_iters=int(local_iters), ms=int(ms))
    rc = _lib().sbs_sweep(_KIND[(plan.arity, plan.width, xw.dtype)],
                          ctypes.c_void_p(ctypes.addressof(args)),
                          _stream(xw.device))
    _raise_on(rc, name)


# --------------------------------------------------------------------------
# w_fill
# --------------------------------------------------------------------------

def w_fill_plain(plan: DevicePlan, xw: torch.Tensor) -> torch.Tensor:
    """Edges: (n,) c0*w0 + c1*w1.  Tets: (n, 4) c_r*w_r.  Pads: w = 0.
    f32 on either table (w read upcast)."""
    v = plan.verts.long()
    w = torch.where(v >= 0, xw[:, 3].float()[v.clamp_min(0)], 0.0)
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
    bf16 = xw.dtype == torch.bfloat16
    rc = _lib().sbs_w_fill(_ptr(plan.verts), _ptr(plan.counts), _ptr(xw),
                           _ptr(out), n, plan.arity, int(bf16), _stream(dev))
    _raise_on(rc, "w_fill")
    count_launch(w_fill_bf16 if bf16 else w_fill)
    return out


w_fill.launches = 0
w_fill_bf16 = LaunchCounter("w_fill_bf16")


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
    """Add each CSR row's summed contributions (f32) to its vertex, once
    per block visit: on the bf16 table the row rounds on the store."""
    acc = torch.zeros((cv.shape[0], 3), dtype=torch.float32,
                      device=xw.device)
    acc.index_add_(0, seg, contrib)
    xw[cv, :3] = (xw[cv, :3].float() + acc).to(xw.dtype)


def _blocks(plan: DevicePlan, order):
    return range(plan.num_blocks) if order is None else order


def edge_sweep_plain(plan: DevicePlan, xw: torch.Tensor, lam: torch.Tensor,
                     wsum: Optional[torch.Tensor], alpha: float,
                     local_iters: int = 1, order=None) -> None:
    """On a legacy 128-wide plan ``wsum`` is None: w0 + w1 come from xw and
    the normal is d / |d|, as in the legacy kernel.  ``order``: the blocks
    to run, in turn (default: every block in plan order).  On a bf16 table
    the reads upcast and each visit's store rounds (``_apply``)."""
    legacy = plan.width == LANES
    W = plan.width
    verts = plan.verts.long()
    for b in _blocks(plan, order):
        sl = slice(b * W, (b + 1) * W)
        v = verts[sl]
        live = v[:, 0] >= 0
        v = v.clamp_min(0)
        al = alpha * plan.atab[sl] if plan.atab is not None else alpha
        cv, lane, role, seg = _block_csr(plan, b)
        l = lam[sl]
        for _ in range(local_iters):
            a0, a1 = xw[v[:, 0]].float(), xw[v[:, 1]].float()
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
            wt = xw[cv, 3].float()[seg]
            f = torch.where(role == 0, wt, -wt)
            _apply(xw, cv, seg, corr[lane] * f[:, None])
        lam[sl] = l


def tet_sweep_plain(plan: DevicePlan, xw: torch.Tensor, lam: torch.Tensor,
                    wtab: Optional[torch.Tensor], alpha: float,
                    local_iters: int = 1, order=None) -> None:
    """On a legacy 128-wide plan ``wtab`` is None: the w_r come from xw and
    the volume is (cross . e) times the f32 sixth, as in the legacy
    kernel.  ``order`` as for ``edge_sweep_plain``."""
    legacy = plan.width == LANES
    W = plan.width
    verts = plan.verts.long()
    for b in _blocks(plan, order):
        sl = slice(b * W, (b + 1) * W)
        v = verts[sl]
        live = v[:, 0] >= 0
        v = v.clamp_min(0)
        w = None if legacy else wtab[sl]
        al = alpha * plan.atab[sl] if plan.atab is not None else alpha
        cv, lane, role, seg = _block_csr(plan, b)
        l = lam[sl]
        for _ in range(local_iters):
            a = [xw[v[:, k]].float() for k in range(4)]
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
                contrib = contrib * xw[cv, 3].float()[seg][:, None]
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
    """One distance sweep over every block, in place on xw (f32 or bf16)
    and lam.  alpha: compliance / sdt^2 (f32-exact); with a per-constraint
    table (plan.atab) the per-lane alpha is alpha * atab."""
    if plan.arity != 2:
        raise ValueError("edge_sweep needs an edge (arity 2) plan")
    dev = _check_sweep(plan, xw, lam, wsum, (plan.num_blocks * BLOCK,))
    if dev.type == "cpu":
        return edge_sweep_plain(plan, xw, lam, wsum, alpha, local_iters)
    _launch_sweep("edge_sweep", plan, xw, lam, wsum, alpha, local_iters, 0)
    count_launch(edge_sweep_bf16 if xw.dtype == torch.bfloat16
                 else edge_sweep)


edge_sweep.launches = 0
edge_sweep_bf16 = LaunchCounter("edge_sweep_bf16")


def tet_sweep(plan: DevicePlan, xw: torch.Tensor, lam: torch.Tensor,
              wtab: torch.Tensor, alpha: float,
              local_iters: int = 1) -> None:
    """One volume sweep over every block, in place on xw and lam."""
    if plan.arity != 4:
        raise ValueError("tet_sweep needs a tet (arity 4) plan")
    dev = _check_sweep(plan, xw, lam, wtab, (plan.num_blocks * BLOCK, 4))
    if dev.type == "cpu":
        return tet_sweep_plain(plan, xw, lam, wtab, alpha, local_iters)
    _launch_sweep("tet_sweep", plan, xw, lam, wtab, alpha, local_iters,
                  int(plan.split))
    count_launch(tet_sweep_bf16 if xw.dtype == torch.bfloat16
                 else tet_sweep)


tet_sweep.launches = 0
tet_sweep_bf16 = LaunchCounter("tet_sweep_bf16")


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
    dev = _check_xw(xw, (torch.float32,))
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
    _launch_sweep("legacy_edge_sweep", plan, xw, lam, None, alpha, 1, 0)
    count_launch(legacy_edge_sweep)


legacy_edge_sweep.launches = 0


def legacy_tet_sweep(plan: DevicePlan, xw: torch.Tensor, lam: torch.Tensor,
                     alpha: float) -> None:
    """One volume sweep over every 128-wide block of a legacy plan, in
    place on xw and lam."""
    dev = _check_legacy(plan, xw, lam, 4, "legacy_tet_sweep")
    if dev.type == "cpu":
        return tet_sweep_plain(plan, xw, lam, None, alpha)
    _launch_sweep("legacy_tet_sweep", plan, xw, lam, None, alpha, 1, 0)
    count_launch(legacy_tet_sweep)


legacy_tet_sweep.launches = 0
