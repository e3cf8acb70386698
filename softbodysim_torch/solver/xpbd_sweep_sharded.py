"""XPBD on the sweep kernels, one scene split across the ranks of a
``torch.distributed`` mesh: halo windows and homed ghost deltas.

The counterpart of ``softbodysim_tpu/solver/xpbd_pallas_sharded.py``, as
``xpbd_sweep.py`` is of ``xpbd_pallas.py``.  The WINDOW axis of the laid-out
particle table (128 rows per window) is cut into D contiguous ranges, one
per rank, and each rank runs its own super-block sub-plan with the
unmodified sweep kernels (``kernels/sweep.py``):

  - The vertex layout (aligned windows, else the natural / Morton / RCM
    order) is the single-device step's; ``wd = ceil(nwin / D)`` windows go
    to each rank, dead windows padding the last.  Each constraint is owned
    by the rank of its minimum window (``owner = min window // wd``).
  - Per sweep a rank materializes its OWN windows plus a static list of
    GHOST windows (copies of other ranks' windows its constraints
    reference) in an extended table, runs the whole block-sequential sweep
    there -- corrections to ghost copies accumulate like any row's -- and
    ships each ghost window's position DELTA home to its owner, which adds
    the incoming deltas.  Collectives per family sweep: one all-gather of
    the exported boundary windows out, one all-gather of ghost deltas back.

Ordering semantics, the JAX package's dialect: within a rank the sweep is
block-synchronous Gauss-Seidel; ACROSS ranks one family sweep is Jacobi --
every rank reads boundary positions frozen at the sweep's start and the
boundary corrections sum.  Constraints touching a vertex that k ranks
touch scale dlambda by 1/k (folded into the packed per-lane scale).  So at
D > 1 this is a dialect of its own, held to the JAX sharded step and not
to the single-device block order.

The block scheme.  'auto' resolves as on one device at D = 1 (the split
scheme, omega (1.5, 2.2): the JAX package's D = 1 exactness contract), and
to the scale scheme at D > 1, where within-block multiplicity counts would
need folding across ranks; 'split', a block omega or local_iters at D > 1
raise ValueError.  At D = 1 the rank's plan is the single-device step's
(``xpbd_sweep.cached_plans``: the adaptive packer and its regrouping), so
the sharded step at D = 1 runs the single-device step's blocks in its
order, bit for bit; at D > 1 each rank's super-blocks are packed by
``sweep_plan.pack_superblocks`` (slot cap 8, the family's multiplicity
cap) in the JAX package's order, without regrouping, and each rank keeps
its own plan (the JAX package pads the plans to one shape to stack them).

The homing sums.  A window that several ranks hold as a ghost gets one
delta from each; they are added in rank order, one rank per pass over the
distinct targets (no scatter-add), so a run repeats its bits.

Every rank calls ``step(state, dt)`` with the same public SimState, in
public vertex and constraint order, and gets the same public state back,
lambdas included; ``step_n`` and ``Engine.run`` keep each rank's rows on
its device between steps (the carry API) and gather only at the end.  The
w fill runs once per carry pack, over each rank's extended tables (ghost
rows included): inverse masses do not change.  Ground (the y clamp),
colliders (the stand-alone collide kernel, radius 0, free rows only) and
the contact stages (``solver/global_stages.py``) run on each rank's rows
inside every iteration, as on one device.

The particle table is f32 whatever ``SolverParams.xpbd_x_dtype`` says:
the JAX sharded step never reads that knob (its ``make_sweep`` call passes
no ``x_dtype``), and neither does this one, beyond refusing an unknown
value.  The bf16 table is the single-device sweep step's.

Not differentiable, as the single-device sweep step (``select.
refuse_grad``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..collide.primitives import Colliders
from ..core.state import SimState, SolverParams, f32, resolve_device
from ..kernels import collide as kc
from ..kernels import sweep as sw
from ..kernels import sweep_plan as sp
from ..parallel.collectives import Axis
from .global_stages import build_sliced_stages
from .select import refuse_grad
from .xpbd_sweep import cached_plans, resolve_block_scheme

LANES = sp.LANES


# --------------------------------------------------------------------------
# The partition (shared with the sharded Jacobi passes)
# --------------------------------------------------------------------------

class Partition(NamedTuple):
    """The layout cut into D equal window ranges; rank ``rank`` owns layout
    rows [rank * wd * 128, (rank + 1) * wd * 128)."""

    D: int
    rank: int
    wd: int
    nwin: int
    vpad: int
    perm_layout: np.ndarray     # (vpad,) layout row -> vertex, V if dead
    old2new: np.ndarray         # (V,) vertex -> layout row

    @property
    def rows(self) -> int:
        """Rows a rank owns."""
        return self.wd * LANES


def partition(topology, D: int, rank: int, layout=None) -> Partition:
    """The JAX package's layout and window split; ``layout``: (perm_layout,
    old2new) when the caller has it already."""
    V = topology.num_particles
    if layout is None:
        aligned = (sp.aligned_order(V, topology.edges)
                   if topology.num_edges > 0 else None)
        if aligned is not None:
            layout = aligned
        else:
            perm = sp.order_vertices(
                topology.vertices,
                topology.edges if topology.num_edges > 0 else None,
                topology.tets if topology.num_tets > 0 else None)
            vpad = -(-V // LANES) * LANES
            old2new = np.empty(V, np.int64)
            old2new[perm] = np.arange(V)
            layout = (np.concatenate([perm, np.full(vpad - V, V,
                                                    np.int64)]), old2new)
    perm_layout, old2new = layout
    nwin = len(perm_layout) // LANES
    wd = -(-nwin // D)
    if wd * D != nwin:                       # pad with dead windows
        perm_layout = np.concatenate(
            [perm_layout, np.full((wd * D - nwin) * LANES, V, np.int64)])
        nwin = wd * D
    return Partition(D=D, rank=rank, wd=wd, nwin=nwin, vpad=nwin * LANES,
                     perm_layout=np.asarray(perm_layout, np.int64),
                     old2new=np.asarray(old2new, np.int64))


@dataclasses.dataclass
class ShardedFamily:
    """One constraint family cut over the ranks, seen from one rank (the
    JAX package's ``_Family``).  Windows are 128 layout rows; a rank's
    extended rows are its own windows, then its ghost windows."""

    arity: int
    owner: np.ndarray           # (N,) each constraint's rank
    owned: np.ndarray           # (n,) this rank's constraint ids, ascending
    local: np.ndarray           # (n, arity) their vertices, extended rows
    rest: np.ndarray            # (n,) f32
    ghosts: list                # per rank: its ghost windows (global ids)
    exports: list               # per rank: its windows others read (local)
    emax: int                   # the most windows a rank exports
    gmax: int                   # the most ghost windows a rank holds
    gather_src: np.ndarray      # (g,) this rank's ghosts in the gathered
                                # exports: rank * emax + export slot
    incoming: np.ndarray        # (m, 2) deltas sent home to this rank, in
                                # rank order: (rank * gmax + ghost slot,
                                # own window)
    cross: np.ndarray           # (n,) f32: 1 / ranks touching a vertex,
                                # the least over the constraint's vertices


def build_sharded_family(cons_pub, rest_pub, part: Partition
                         ) -> ShardedFamily:
    """Ownership, ghost, export and incoming maps of one family
    (``build_sharded_family`` :110-250 of the JAX package, for one rank);
    plans are the caller's."""
    D, wd, rank = part.D, part.wd, part.rank
    cons = part.old2new[np.asarray(cons_pub, np.int64)]
    win = cons // LANES
    owner = win.min(axis=1) // wd

    # ranks touching each vertex -> the cross-rank dlambda scale
    touch = np.zeros((part.vpad,), np.int64)
    ghosts = []
    for d in range(D):
        mine = cons[owner == d]
        if len(mine):
            touch[np.unique(mine.reshape(-1))] += 1
        w = mine // LANES
        ghosts.append(np.unique(w[(w < d * wd) | (w >= (d + 1) * wd)]))

    sel = owner == rank
    owned = np.flatnonzero(sel)
    gw = ghosts[rank]
    wv, lane = win[sel], cons[sel] % LANES
    lo = rank * wd
    local_w = np.where((wv >= lo) & (wv < lo + wd), wv - lo,
                       wd + np.searchsorted(gw, wv))
    cmult = np.maximum(touch, 1)[cons[sel]].max(axis=1).astype(np.float32)

    exports = []
    for d in range(D):
        need = [g[(g >= d * wd) & (g < (d + 1) * wd)] - d * wd
                for dd, g in enumerate(ghosts) if dd != d]
        exports.append(np.unique(np.concatenate(need)) if need
                       else np.zeros((0,), np.int64))
    emax = max(len(e) for e in exports)
    gmax = max(len(g) for g in ghosts)
    o = gw // wd
    gather_src = o * emax + np.asarray(
        [np.searchsorted(exports[oo], g - oo * wd) for oo, g in zip(o, gw)],
        np.int64).reshape(-1)
    incoming = [(s * gmax + i, int(g) - rank * wd)
                for s, gs in enumerate(ghosts) for i, g in enumerate(gs)
                if int(g) // wd == rank]
    return ShardedFamily(
        arity=cons.shape[1], owner=owner, owned=owned,
        local=local_w * LANES + lane,
        rest=np.asarray(rest_pub, np.float32)[owned], ghosts=ghosts,
        exports=exports, emax=emax, gmax=gmax, gather_src=gather_src,
        incoming=np.asarray(incoming, np.int64).reshape(-1, 2),
        cross=np.float32(1.0) / cmult)


class Halo:
    """One family's exchanges on one rank's device: the ghost windows in
    (``ghosts``), their deltas home (``home``), and the public order of the
    family's constraint values (``gather_values``)."""

    def __init__(self, fam: ShardedFamily, part: Partition, axis: Axis,
                 device):
        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(device)

        self.axis, self.wd, self.D = axis, part.wd, part.D
        self.emax, self.gmax = fam.emax, fam.gmax
        self.g = len(fam.gather_src)               # this rank's ghosts
        self.active = fam.gmax > 0              # the same on every rank
        exp = fam.exports[part.rank]
        self.export_idx = i64(np.concatenate(
            [exp, np.zeros(fam.emax - len(exp), np.int64)]))
        self.gather_src = i64(fam.gather_src)
        # the incoming deltas, one layer per pass: a window's k-th delta
        # (in rank order) in layer k, so each layer's targets are distinct
        tgt = fam.incoming[:, 1]
        layer = np.zeros(len(tgt), np.int64)
        seen = {}
        for j, t in enumerate(tgt):
            layer[j] = seen.get(int(t), 0)
            seen[int(t)] = layer[j] + 1
        self.layers = [(i64(fam.incoming[layer == k, 0]),
                        i64(tgt[layer == k]))
                       for k in range(int(layer.max(initial=-1)) + 1)]
        # public order of the per-constraint values every rank holds
        counts = np.bincount(fam.owner, minlength=part.D)
        self.nmax = int(counts.max(initial=0))
        order = np.argsort(fam.owner, kind="stable")
        self._pub = i64(order)
        self._flat = i64(fam.owner[order] * self.nmax
                         + (np.arange(len(order))
                            - np.concatenate([[0], np.cumsum(counts)])[
                                fam.owner[order]]))

    def ghosts(self, own: torch.Tensor) -> torch.Tensor:
        """The ghost windows' rows (g * 128, c) from every rank's own rows
        (wd * 128, c): one all-gather of the exported windows."""
        c = own.shape[1]
        out = own.view(self.wd, LANES, c)[self.export_idx]
        allw = self.axis.all_gather(out).view(self.D * self.emax, LANES, c)
        return allw[self.gather_src].view(-1, c)

    def home(self, own: torch.Tensor, ghost_vals: torch.Tensor) -> None:
        """Add each rank's ghost values (g * 128, c) to the own rows
        (wd * 128, c) they copy, in place: one all-gather, then the
        incoming values added in rank order."""
        c = own.shape[1]
        pad = ghost_vals.new_zeros((self.gmax * LANES, c))
        pad[:ghost_vals.shape[0]] = ghost_vals
        allg = self.axis.all_gather(pad).view(self.D * self.gmax, LANES, c)
        ow = own.view(self.wd, LANES, c)
        for src, tgt in self.layers:
            ow[tgt] = ow[tgt] + allg[src]

    def gather_values(self, vals: torch.Tensor) -> torch.Tensor:
        """The family's per-constraint values in public order from each
        rank's own (n,) values (owned order)."""
        pad = vals.new_zeros((self.nmax,))
        pad[:vals.shape[0]] = vals
        allv = self.axis.all_gather(pad).view(-1)
        out = torch.empty((self._pub.shape[0],), dtype=vals.dtype,
                          device=vals.device)
        out[self._pub] = allv[self._flat]
        return out


class ShardedRows:
    """What both kernel-sharded steps share (this one and
    ``jacobi_pass_sharded``): the rank's place in the partition, its rows
    of a public table and back, its families' extended tables, the
    contact stages over the gathered rows, and ``shard_info``.  A step
    puts its families, each with ``fam``, ``halo`` and ``ext``, in
    ``fams``."""

    def __init__(self, topology, params: SolverParams, mesh,
                 colliders: Optional[Colliders], device, layout=None):
        ax = self.axis = Axis(mesh)
        dev = self.device = resolve_device(device)
        self.params = params
        self.colliders = None if colliders is None else colliders.to(dev)
        V = topology.num_particles
        part = self.part = partition(topology, ax.size, ax.index, layout)
        lo = ax.index * part.rows
        self._perm = torch.as_tensor(
            part.perm_layout[lo:lo + part.rows]).to(dev)
        self._old2new = torch.as_tensor(part.old2new).to(dev)
        self._gravity = torch.tensor(params.gravity, dtype=torch.float32,
                                     device=dev)
        # the layout rows' rest positions (dead rows at the origin)
        self.rest_rows = np.concatenate(
            [np.asarray(topology.vertices, np.float32),
             np.zeros((1, 3), np.float32)])[part.perm_layout]
        # the contact stages, own-slice form over the gathered rows
        tris = None
        if params.surface_collision and len(topology.surface_tris):
            tris = part.old2new[np.asarray(topology.surface_tris,
                                           np.int64).reshape(-1, 3)]
        self._self_fn, self._surf_fn, iso = build_sliced_stages(
            topology, params, rest_rows=self.rest_rows,
            dead=part.perm_layout == V, tris_rows=tris, device=dev)
        self._iso = torch.as_tensor(iso).to(dev)
        self.fams = {}

    def _shard_info(self, **extra) -> dict:
        part = self.part
        return {"D": part.D, "rank": part.rank, "wd": part.wd,
                "nwin": part.nwin, "perm_layout": part.perm_layout,
                "old2new": part.old2new,
                **{name: f.fam for name, f in self.fams.items()}, **extra}

    @property
    def has_stage(self) -> bool:
        return self._self_fn is not None or self._surf_fn is not None

    def _rows(self, a: torch.Tensor) -> torch.Tensor:
        """A public per-vertex table (V, ...) -> this rank's rows (dead
        rows 0)."""
        a = a.to(self.device, torch.float32)
        return torch.cat([a, a.new_zeros((1,) + a.shape[1:])])[
            self._perm].contiguous()

    def _gather_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Every rank's rows (vb, c) -> public order (V, c)."""
        return self.axis.all_gather(rows, tiled=True)[self._old2new]

    def _w_full(self, xo: torch.Tensor) -> Optional[torch.Tensor]:
        """Every rank's inverse masses, for the contact stages."""
        return (self.axis.all_gather(xo[:, 3], tiled=True)
                if self.has_stage else None)

    def _ext(self, f, xo: torch.Tensor) -> torch.Tensor:
        """The family's extended table from the own rows: the own rows
        themselves when this rank holds no ghost, else a copy with the
        ghost windows fetched (every rank joins the exchange while any
        rank holds ghosts)."""
        if not f.halo.active:
            return xo
        ghosts = f.halo.ghosts(xo)
        if f.ext is None:
            return xo
        f.ext[:xo.shape[0]] = xo
        f.ext[xo.shape[0]:] = ghosts
        return f.ext

    def _contact(self, xo: torch.Tensor, w_full: torch.Tensor) -> None:
        """Self, then surface collision on this rank's rows, each over
        the gathered (parked) table (``global_stages``)."""
        ax, vb = self.axis, xo.shape[0]
        off = ax.index * vb
        radius = max(1e-6, self.params.particle_radius)
        free = (xo[:, 3] != 0.0)[:, None]
        if self._self_fn is not None:
            p = ax.all_gather(xo[:, :3], tiled=True) + self._iso
            d = self._self_fn(p, w_full, radius, off, vb)
            xo[:, :3] = torch.where(free, xo[:, :3] + d, xo[:, :3])
        if self._surf_fn is not None:
            p = ax.all_gather(xo[:, :3], tiled=True) + self._iso
            vd, corners = self._surf_fn(p, w_full, off, vb)
            cd = ax.psum(corners)[off:off + vb]
            xo[:, :3] = torch.where(free, xo[:, :3] + (vd + cd), xo[:, :3])


# --------------------------------------------------------------------------
# The step
# --------------------------------------------------------------------------

class ShardedCarry(NamedTuple):
    """A rank's run state: its own layout rows (x* xyz + inverse mass,
    committed positions, velocities), its owned lambdas in packed order and
    its streamed inverse-mass tables (filled once per pack)."""

    xo: torch.Tensor
    xp: torch.Tensor
    vv: torch.Tensor
    lam_e: torch.Tensor
    lam_t: torch.Tensor
    w_e: Optional[torch.Tensor]
    w_t: Optional[torch.Tensor]


class _Fam(NamedTuple):
    fam: ShardedFamily
    gpu: sp.GpuPlan
    plan: sw.DevicePlan
    halo: Halo
    ext: Optional[torch.Tensor]        # (own + ghost rows, 4), or None
    pos_of: torch.Tensor               # (n,) owned -> packed position
    local_iters: int


def _sharded_plan(fam: ShardedFamily, lcap: int, scheme):
    """A rank's super-blocks in the JAX package's order, the cross-rank
    1/k folded into the per-lane scale (``build_sharded_family``
    :164-178)."""
    sch, om, _ = scheme
    plan = sp.pack_superblocks(fam.local, fam.rest, slots_cap=8,
                               layer_cap=lcap)
    if len(fam.owned):
        live = plan.perm >= 0
        extra = np.ones_like(plan.scale).reshape(-1)
        extra[live] = fam.cross[plan.perm[live]]
        plan = dataclasses.replace(plan, scale=(
            plan.scale.reshape(-1) * extra).reshape(plan.scale.shape))
    return sp.build_gpu_plan(plan, fam.local, scheme=sch, omega=om)


class XpbdSweepShardedStep(ShardedRows):
    """``step(state, dt) -> state`` on the sweep kernels, split across the
    ranks of ``mesh`` (module docstring), with the carry API of
    ``xpbd_sweep.SweepStep``.  ``colliders``: a make-time set (replicated
    on every rank); ``colliders_rt`` moves it per call.
    ``shard_info``: the partition and each family's maps."""

    backend = "sweep"

    def __init__(self, topology, params: SolverParams, mesh,
                 colliders: Optional[Colliders] = None, *, device=None):
        if params.dialect != "xpbd":
            raise ValueError("the sharded sweep step implements the xpbd "
                             "dialect")
        D = mesh.size()
        fams = resolve_block_scheme(params, legacy=D > 1)
        if D > 1 and any(f != ("scale", 1.0, 1) for f in fams.values()):
            raise ValueError(
                "xpbd_block_scheme='split' (and block omega / local_iters) "
                "are single-device only; the window-sharded path at D > 1 "
                "runs the scale scheme (leave the xpbd_block_* knobs at "
                "their defaults)")
        # the knob is checked, not read: the table is f32 (module
        # docstring)
        if params.xpbd_x_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown xpbd_x_dtype {params.xpbd_x_dtype!r}"
                             " (float32|bfloat16)")
        # D = 1: the single-device step's layout and plans
        single = cached_plans(topology) if D == 1 else None
        super().__init__(topology, params, mesh, colliders, device,
                         layout=None if single is None else single[:2])
        part, dev = self.part, self.device
        for name, cons, rest, lcap, key, sup in (
                ("edges", topology.edges, topology.edge_rest, 2, "edge", 3),
                ("tets", topology.tets, topology.tet_rest_vol, 3, "tet", 4)):
            if len(cons) == 0:
                continue
            fam = build_sharded_family(cons, rest, part)
            if single is not None:            # D = 1: the step's own plan
                sch, om, _ = fams[key]
                gpu = sp.build_gpu_plan(
                    single[sup], part.old2new[np.asarray(cons, np.int64)],
                    scheme=sch, omega=om)
            else:
                gpu = _sharded_plan(fam, lcap, fams[key])
            halo = Halo(fam, part, self.axis, dev)
            ext = (torch.zeros(((part.wd + halo.g) * LANES, 4), device=dev)
                   if halo.g else None)
            self.fams[name] = _Fam(
                fam=fam, gpu=gpu, plan=sw.to_device(gpu, dev), halo=halo,
                ext=ext, pos_of=torch.as_tensor(gpu.pos_of).to(dev),
                local_iters=fams[key][2])
        self.shard_info = self._shard_info(
            plans={name: f.gpu for name, f in self.fams.items()})

    def raise_on_timeouts(self) -> None:
        staged = [f.plan.staged for f in self.fams.values()
                  if f.plan.staged is not None]
        if staged:
            sw.raise_on_timeouts(*staged)

    # ---- public <-> internal layout --------------------------------------

    def pack_state(self, state: SimState) -> ShardedCarry:
        """Public state (the same on every rank) -> this rank's carry."""
        refuse_grad("the sharded 'sweep' step", state)
        dev, rows = self.device, self._rows
        xo = torch.cat([rows(state.x_star), rows(state.inv_mass)[:, None]],
                       1).contiguous()

        def pack_lam(name, lam):
            f = self.fams.get(name)
            if f is None:
                return torch.zeros((0,), dtype=torch.float32, device=dev)
            out = torch.zeros((f.plan.num_blocks * f.plan.width,),
                              dtype=torch.float32, device=dev)
            owned = torch.as_tensor(f.fam.owned).to(dev)
            out[f.pos_of] = lam.to(dev, torch.float32)[owned]
            return out

        def fill(name):
            f = self.fams.get(name)
            return None if f is None else sw.w_fill(f.plan, self._ext(f, xo))

        return ShardedCarry(
            xo=xo, xp=rows(state.x), vv=rows(state.v),
            lam_e=pack_lam("edges", state.edge_lambda),
            lam_t=pack_lam("tets", state.tet_lambda),
            w_e=fill("edges"), w_t=fill("tets"))

    def unpack_state(self, carry: ShardedCarry, state: SimState) -> SimState:
        """This rank's carry -> the public state (the same on every rank;
        ``state`` supplies inv_mass and absent families' lambdas)."""
        full = self._gather_rows(torch.cat(
            [carry.xp, carry.vv, carry.xo[:, :3]], 1))

        def lam(name, packed, default):
            f = self.fams.get(name)
            if f is None:
                return default
            return f.halo.gather_values(packed[f.pos_of])

        return SimState(
            x=full[:, 0:3].contiguous(), v=full[:, 3:6].contiguous(),
            x_star=full[:, 6:9].contiguous(), inv_mass=state.inv_mass,
            edge_lambda=lam("edges", carry.lam_e, state.edge_lambda),
            tet_lambda=lam("tets", carry.lam_t, state.tet_lambda))

    def carry_positions(self, carry: ShardedCarry) -> torch.Tensor:
        """Committed positions (V, 3) in public order (on every rank)."""
        return self._gather_rows(carry.xp)

    # ---- stepping ---------------------------------------------------------

    def _sweep(self, name: str, c: ShardedCarry, lam, wtab, alpha) -> None:
        """One family sweep: ghosts in, the rank's sweep, deltas home."""
        f = self.fams[name]
        ext = self._ext(f, c.xo)
        before = ext[c.xo.shape[0]:, :3].clone() if f.ext is not None \
            else None
        kern = sw.edge_sweep if f.fam.arity == 2 else sw.tet_sweep
        kern(f.plan, ext, lam, wtab, alpha, f.local_iters)
        if f.ext is not None:
            c.xo.copy_(ext[:c.xo.shape[0]])
        if f.halo.active:
            vals = (ext[c.xo.shape[0]:, :3] - before if before is not None
                    else c.xo.new_zeros((0, 3)))
            f.halo.home(c.xo[:, :3], vals)

    def _resolve(self, edge_compliance, volume_compliance):
        p = self.params
        ec = p.edge_compliance if edge_compliance is None else \
            edge_compliance
        vc = p.volume_compliance if volume_compliance is None else \
            volume_compliance
        return np.float32(ec), np.float32(vc)

    def run_carry(self, carry: ShardedCarry, dt, n: int,
                  edge_compliance=None, volume_compliance=None,
                  colliders_rt=None) -> ShardedCarry:
        """n steps on this rank's carry, in place (every rank calls it
        with the same arguments); returns it."""
        ec, vc = self._resolve(edge_compliance, volume_compliance)
        cols = kc.runtime_colliders(self.colliders, colliders_rt,
                                    self.device)
        packed = None if cols is None else kc.pack_colliders(cols,
                                                            self.device)
        p = self.params
        ss = max(1, p.substeps)
        sdt = np.float32(dt) / np.float32(ss)
        big = sdt > np.float32(1e-12)
        inv_dt2 = np.float32(1.0) / (sdt * sdt) if big else np.float32(0.0)
        inv_dt = np.float32(1.0) / sdt if big else np.float32(0.0)
        e_alpha = float(np.maximum(ec, np.float32(0.0)) * inv_dt2)
        t_alpha = float(np.maximum(vc, np.float32(0.0)) * inv_dt2)
        free = carry.xo[:, 3:4] != 0.0
        w_full = self._w_full(carry.xo)
        for _ in range(int(n)):
            for _ in range(ss):
                self._substep(carry, free, float(sdt), float(inv_dt),
                              e_alpha, t_alpha, packed, w_full)
        return carry

    def _substep(self, c: ShardedCarry, free, sdt, inv_dt, e_alpha, t_alpha,
                 packed, w_full) -> None:
        p = self.params
        xo, xp, vv = c.xo, c.xp, c.vv
        vv.copy_(torch.where(free, vv + self._gravity * sdt, vv))
        xo[:, :3] = torch.where(free, xp + vv * sdt, xp)
        ground_y = f32(p.ground_y)
        for _ in range(p.iterations):
            if "edges" in self.fams:
                self._sweep("edges", c, c.lam_e, c.w_e, e_alpha)
            if "tets" in self.fams:
                self._sweep("tets", c, c.lam_t, c.w_t, t_alpha)
            if p.ground_enabled:          # axis-aligned y clamp
                y = xo[:, 1]
                xo[:, 1] = torch.where(free[:, 0], y.clamp_min(ground_y), y)
            if packed is not None:        # free rows only; dead rows w = 0
                kc.collide(xo, packed, kc.XPBD_GROUND)
            if self.has_stage:
                self._contact(xo, w_full)
        xs = xo[:, :3]
        vel = (xs - xp) * inv_dt
        if p.ground_enabled:
            on_g = xs[:, 1] <= f32(p.ground_y + 1e-6)
            keep = f32(1.0 - min(1.0, max(0.0, p.friction)))
            vx = torch.where(on_g, vel[:, 0] * keep, vel[:, 0])
            vz = torch.where(on_g, vel[:, 2] * keep, vel[:, 2])
            vy = torch.where(on_g & (vel[:, 1] < 0.0), 0.0, vel[:, 1])
            vel = torch.stack([vx, vy, vz], 1)
        vv.copy_(torch.where(free, vel, 0.0))
        xp.copy_(torch.where(free, xs, xp))
        xo[:, :3] = xp

    def __call__(self, state: SimState, dt, edge_compliance=None,
                 volume_compliance=None, colliders_rt=None) -> SimState:
        return self.step_n(state, dt, 1, edge_compliance, volume_compliance,
                           colliders_rt)

    def step_n(self, state: SimState, dt, n: int, edge_compliance=None,
               volume_compliance=None, colliders_rt=None) -> SimState:
        refuse_grad("the sharded 'sweep' step", state, edge_compliance,
                    volume_compliance, colliders_rt)
        carry = self.pack_state(state)
        self.run_carry(carry, dt, n, edge_compliance, volume_compliance,
                       colliders_rt)
        return self.unpack_state(carry, state)


def make_xpbd_sweep_sharded_step(topology, params: SolverParams, mesh, *,
                                 colliders=None,
                                 device=None) -> XpbdSweepShardedStep:
    """The JAX package's ``make_xpbd_pallas_sharded_step`` (:301) on the
    port's sweep kernels: ``step(state, dt)``, ``step.step_n(state, dt,
    n)``, ``step.shard_info``."""
    return XpbdSweepShardedStep(topology, params, mesh, colliders,
                                device=device)
