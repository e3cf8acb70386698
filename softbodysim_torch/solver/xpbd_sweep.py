"""XPBD solver on the block-synchronous sweep kernels -- the large scene
path, at either block width.

The counterpart of ``softbodysim_tpu/solver/xpbd_pallas.py`` (flat path):
the same physics contract (XPBD compliance, lambda accumulated across the
whole run, ground clamp, the colliders and the contact stages inside
iterations, friction at commit), the same host plans, the same block order
and block scheme, on the CUDA kernels of ``kernels/sweep.py``.  ``superblocks=True`` (default)
packs 1024-wide super-blocks and runs the w-fill and super-block sweeps;
``superblocks=False`` packs the legacy 128-wide blocks and runs the legacy
sweeps (scale scheme only).  No segmentation: the particle table lives in
device memory, not in a bounded scratchpad.

Internal layout (one device):
  xw : (Vpad, 4) f32 or bf16 -- x* xyz + inverse mass, rows in layout order
  xp : (Vpad, 3) f32 -- committed positions
  vv : (Vpad, 3) f32 -- velocities
Layout slot i holds vertex perm[i]; dead slots (perm == V: tail padding and
component-alignment gaps) sit at the origin with w = 0 and never move.  The
permutation and the packed lambda order are applied only at the public
SimState boundary (``pack_state`` / ``unpack_state``).

The bf16 table (``SolverParams.xpbd_x_dtype="bfloat16"``, super-blocks
only), as ``xpbd_pallas.py:583-700`` runs it: xw holds bf16 rows (the
sweep kernels' bf16 instantiations), xp and vv stay f32.  Predict keeps
the substep's f32 prediction in the carry (``xs_pred``) and writes it
rounded into the table; the ground clamp, the colliders and the contact
stages work on the table's f32 upcast and round where they write; commit
takes ``xs_pred + (table - bf16(xs_pred))`` as the position, so only the
constraint and collision corrections round, never the integration.  Valid
for scenes under about 100 rest lengths per axis (the JAX package's
envelope: a bf16 ulp of the coordinates well under an edge's rest
length).

Not differentiable: the kernels write the tables in place, unseen by
autograd, so a step handed a tensor that requires grad raises
(``select.refuse_grad``; ``diff.make_rollout`` builds the coloured step),
as ``jax.grad`` through the JAX sweeps' ``pallas_call`` fails.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..collide.primitives import Colliders
from ..core.state import SimState, SolverParams, f32, resolve_device
from ..io import plan_store
from ..kernels import collide as kc
from ..kernels import sweep as sw
from ..kernels import sweep_plan as sp
from .contact import make_contact_stage
from .select import refuse_grad

LANES = sp.LANES

# Packing a 600k-constraint topology takes seconds (super-blocks) to tens of
# seconds (legacy blocks) of host work; memoize per topology object and
# block width, so steps rebuilt with other substeps / iterations / schemes
# reuse the plans.  Entries die with the topology.
_PLAN_CACHE: dict = {}


def _pack_best(cons, rest, layer_cap, arity):
    """Adaptive super-block packing: both greedy-scan orders x slot caps,
    keep the cheapest by the JAX package's per-block op-count model (so the
    plans, and with them the block order, are the JAX package's)."""
    best = None
    for order_mode in (1, 0):
        for scap in (8, 12, 16):
            plan = sp.pack_superblocks(cons, rest, slots_cap=scap,
                                       layer_cap=layer_cap,
                                       order_mode=order_mode)
            cost = plan.num_super * (12 * arity * scap
                                     + 15 * scap * plan.dmax + 80)
            if best is None or cost < best[0]:
                best = (cost, plan)
            if len(cons) / plan.capacity >= 0.6:
                break
    return best[1]


def _pack(topology, superblocks):
    V = topology.num_particles
    has_edges = topology.num_edges > 0
    has_tets = topology.num_tets > 0

    aligned = sp.aligned_order(V, topology.edges) if has_edges else None
    if aligned is not None:
        perm_layout, old2new = aligned
    else:
        perm = sp.order_vertices(
            topology.vertices,
            topology.edges if has_edges else None,
            topology.tets if has_tets else None)
        vpad = -(-V // LANES) * LANES
        perm_layout = np.concatenate([perm, np.full(vpad - V, V, np.int64)])
        old2new = np.empty(V, np.int64)
        old2new[perm] = np.arange(V)
    nwin = len(perm_layout) // LANES

    def pack(cons, rest, lcap, arity):
        cons = old2new[cons.astype(np.int64)]
        if superblocks:
            return sp.regroup_plan(_pack_best(cons, rest, lcap, arity))
        # legacy 128-wide blocks: 4 window slots, multiplicity cap 3
        return sp.pack_constraints(cons, rest, slots_cap=4, layer_cap=3)

    # same-block multiplicity cap (super-blocks): 2 for edges, 3 for tets
    e_plan = (pack(topology.edges, topology.edge_rest, 2, 2)
              if has_edges else None)
    t_plan = (pack(topology.tets, topology.tet_rest_vol, 3, 4)
              if has_tets else None)
    return perm_layout, old2new, nwin, e_plan, t_plan


def cached_plans(topology, superblocks: bool = True):
    """(perm_layout, old2new, nwin, e_plan, t_plan), as the JAX package's
    ``_cached_plans`` with its defaults ('auto' vertex order; adaptive slot
    caps for super-blocks, slots_cap 4 / layer_cap 3 for the legacy
    blocks).  perm_layout is (nwin*128,) old vertex ids, == V on dead
    slots.  Memoized per topology object; packed plans also go to the disk
    cache (``io/plan_store.py``) unless it is disabled."""
    key = (id(topology), bool(superblocks))
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    has_edges = topology.num_edges > 0
    has_tets = topology.num_tets > 0
    dkey = plan_store.content_key([
        "xpbd_sweep_plans", topology.num_particles, topology.vertices,
        topology.edges if has_edges else None,
        topology.edge_rest if has_edges else None,
        topology.tets if has_tets else None,
        topology.tet_rest_vol if has_tets else None,
        bool(superblocks),
    ]) if plan_store.enabled() else None
    result = plan_store.load(dkey) if dkey is not None else None
    if result is None:
        result = _pack(topology, superblocks)
        if dkey is not None:
            plan_store.save(dkey, result)
    _PLAN_CACHE[key] = result
    weakref.finalize(topology, _PLAN_CACHE.pop, key, None)
    return result


def resolve_block_scheme(params: SolverParams, legacy: bool = False) -> dict:
    """{"edge": (scheme, omega, k), "tet": (scheme, omega, k)}.

    Each knob takes a scalar or an (edge, tet) pair.  'auto' resolves to
    the tuned split defaults -- both families mass-split, omega (1.5, 2.2)
    when the omega knob is left at its neutral 1.0, one visit per block --
    and to the scale scheme on the legacy 128-wide path, whose kernels have
    no other (``xpbd_pallas.py:316``)."""

    def pair(v, cast):
        if isinstance(v, (tuple, list)):
            e, t = v
            return cast(e), cast(t)
        return cast(v), cast(v)

    se, st = pair(params.xpbd_block_scheme, str)
    oe, ot = pair(params.xpbd_block_omega, float)
    ke, kt = pair(params.xpbd_block_local_iters, lambda x: max(1, int(x)))
    om_default = not isinstance(params.xpbd_block_omega, (tuple, list)) \
        and float(params.xpbd_block_omega) == 1.0
    auto = "scale" if legacy else "split"
    if se == "auto":
        se = auto
        if se == "split" and om_default:
            oe = 1.5
    if st == "auto":
        st = auto
        if st == "split" and om_default:
            ot = 2.2
    return {"edge": (se, oe, ke), "tet": (st, ot, kt)}


class Carry(NamedTuple):
    """Internal run state: layout tables, packed lambdas and the streamed
    inverse-mass tables (super-blocks: filled once per pack, masses never
    change; None on the legacy path, whose kernels read w from xw); on the
    bf16 table the substep's f32 prediction (Vpad, 3) (None on f32)."""

    xw: torch.Tensor
    xp: torch.Tensor
    vv: torch.Tensor
    lam_e: torch.Tensor
    lam_t: torch.Tensor
    w_e: Optional[torch.Tensor]
    w_t: Optional[torch.Tensor]
    xs_pred: Optional[torch.Tensor] = None


class SweepHost(NamedTuple):
    """A SweepStep's make on the host: the vertex layout and block plans
    (``cached_plans``), per family its GPU plan and, on a CUDA device, its
    schedule (``sweep.host_stage``; None on the CPU).  Building it
    launches nothing on the device, so a server builds it outside its
    device lock and hands it to ``SweepStep(host=...)``."""

    perm: np.ndarray
    old2new: np.ndarray
    block_order: dict
    gpu_plans: dict
    stages: dict


def sweep_host(topology, params: SolverParams, device=None, *,
               superblocks: bool = True, edge_c=None,
               tet_c=None) -> SweepHost:
    """The host part of ``SweepStep(topology, params, device=device,
    superblocks=..., edge_c=..., tet_c=...)``."""
    fam = resolve_block_scheme(params, legacy=not superblocks)
    perm, old2new, _, e_plan, t_plan = cached_plans(topology, superblocks)
    (e_sch, e_om, _), (t_sch, t_om, _) = fam["edge"], fam["tet"]
    gpu_plans = {
        "edges": sp.build_gpu_plan(
            e_plan, old2new[topology.edges.astype(np.int64)],
            scheme=e_sch, omega=e_om, compliance=edge_c)
        if topology.num_edges > 0 else None,
        "tets": sp.build_gpu_plan(
            t_plan, old2new[topology.tets.astype(np.int64)],
            scheme=t_sch, omega=t_om, compliance=tet_c)
        if topology.num_tets > 0 else None,
    }
    dev = resolve_device(device)
    return SweepHost(
        perm=perm, old2new=old2new,
        block_order={"edges": e_plan, "tets": t_plan}, gpu_plans=gpu_plans,
        stages={k: sw.host_stage(p, dev)
                for k, p in gpu_plans.items() if p is not None})


class SweepStep:
    """``step(state, dt) -> state`` on the sweep kernels, with the carry
    API: ``pack_state`` -> ``run_carry``* -> ``unpack_state`` keeps the
    internal layout on the device across any number of calls, and
    ``carry_positions`` reads committed positions without unpacking the
    lambdas.

    superblocks: 1024-wide super-blocks (default) or the legacy 128-wide
    blocks (scale scheme, omega 1, one visit, f32 table; anything else
    raises ValueError).  ``params.xpbd_x_dtype``: the particle table's
    dtype, "float32" or "bfloat16" (module docstring).  colliders: a
    make-time collider set, applied after the ground clamp in every
    iteration; ``colliders_rt`` moves it per call.  edge_c / tet_c:
    optional per-constraint compliance (public order); the compliance
    scalars then scale them.  host: the make's host part, ``sweep_host``
    of the same arguments (default: built here)."""

    backend = "sweep"

    def __init__(self, topology, params: SolverParams,
                 colliders: Optional[Colliders] = None, *, device=None,
                 superblocks: bool = True, edge_c=None, tet_c=None,
                 host: Optional["SweepHost"] = None):
        fam = resolve_block_scheme(params, legacy=not superblocks)
        if not superblocks and (
                fam["edge"] != ("scale", 1.0, 1)
                or fam["tet"] != ("scale", 1.0, 1)
                or params.xpbd_x_dtype != "float32"):
            raise ValueError(
                "the legacy 128-wide sweep kernels support only the scale "
                "scheme at omega 1 with one visit per block on the float32 "
                "table (use superblocks=True for split / omega / "
                "local_iters / xpbd_x_dtype)")
        dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        if params.xpbd_x_dtype not in dtypes:
            raise ValueError(f"unknown xpbd_x_dtype {params.xpbd_x_dtype!r}"
                             " (float32|bfloat16)")
        self.x_dtype = dtypes[params.xpbd_x_dtype]
        dev = self.device = resolve_device(device)
        self.params = params
        self.superblocks = bool(superblocks)
        self.has_edges = topology.num_edges > 0
        self.has_tets = topology.num_tets > 0
        self._edge_c, self._tet_c = edge_c, tet_c
        self.colliders = None if colliders is None else colliders.to(dev)

        if host is None:
            host = sweep_host(topology, params, dev, superblocks=superblocks,
                              edge_c=edge_c, tet_c=tet_c)
        perm, old2new = host.perm, host.old2new
        (e_sch, e_om, self._e_k), (t_sch, t_om, self._t_k) = \
            fam["edge"], fam["tet"]
        self.block_order = host.block_order
        self.block_scheme = {"scheme": (e_sch, t_sch), "omega": (e_om, t_om),
                             "local_iters": (self._e_k, self._t_k)}
        self.gpu_plans = host.gpu_plans
        self.device_plans = {k: sw.to_device(p, dev, stage=host.stages[k])
                             for k, p in self.gpu_plans.items()
                             if p is not None}
        self._perm = torch.as_tensor(perm, dtype=torch.int64).to(dev)
        self._old2new = torch.as_tensor(old2new, dtype=torch.int64).to(dev)
        # self / surface collision on the row layout: dead rows parked,
        # triangle corners remapped (solver/contact.py)
        self.contact = make_contact_stage(topology, params, device=dev,
                                          perm=perm, old2new=old2new)
        self._pos_of = {k: torch.as_tensor(p.pos_of).to(dev)
                        for k, p in self.gpu_plans.items() if p is not None}
        self._gravity = torch.tensor(params.gravity, dtype=torch.float32,
                                     device=dev)
        if superblocks:
            self._edge_sweep = lambda plan, c, a: sw.edge_sweep(
                plan, c.xw, c.lam_e, c.w_e, a, self._e_k)
            self._tet_sweep = lambda plan, c, a: sw.tet_sweep(
                plan, c.xw, c.lam_t, c.w_t, a, self._t_k)
        else:
            self._edge_sweep = lambda plan, c, a: sw.legacy_edge_sweep(
                plan, c.xw, c.lam_e, a)
            self._tet_sweep = lambda plan, c, a: sw.legacy_tet_sweep(
                plan, c.xw, c.lam_t, a)

    def raise_on_timeouts(self) -> None:
        """Raise if a sweep launch of this step aborted on a timed-out
        wait since the last check (its own plans' words: valid once the
        launches have finished, e.g. after a synchronize)."""
        staged = [p.staged for p in self.device_plans.values()
                  if p.staged is not None]
        if staged:
            sw.raise_on_timeouts(*staged)

    # ---- public <-> internal layout --------------------------------------

    def pack_state(self, state: SimState) -> Carry:
        """Public state -> carry (new tensors; ``state`` is not touched and
        serves as the template for ``unpack_state``)."""
        refuse_grad("the 'sweep' step", state)
        dev = self.device

        def rows(a):                       # (V, k) -> (Vpad, k), permuted
            a = a.to(dev, torch.float32)
            return torch.cat([a, a.new_zeros((1,) + a.shape[1:])])[
                self._perm].contiguous()

        xw = torch.cat([rows(state.x_star), rows(state.inv_mass)[:, None]],
                       1).to(self.x_dtype).contiguous()

        def pack_lam(fam, lam):
            plan = self.device_plans.get(fam)
            if plan is None:
                return torch.zeros((0,), dtype=torch.float32, device=dev)
            out = torch.zeros((plan.num_blocks * plan.width,),
                              dtype=torch.float32, device=dev)
            out[self._pos_of[fam]] = lam.to(dev, torch.float32)
            return out

        def fill(fam):
            plan = self.device_plans.get(fam)
            return (sw.w_fill(plan, xw)
                    if plan is not None and self.superblocks else None)

        xp = rows(state.x)
        return Carry(
            xw=xw, xp=xp, vv=rows(state.v),
            lam_e=pack_lam("edges", state.edge_lambda),
            lam_t=pack_lam("tets", state.tet_lambda),
            w_e=fill("edges"), w_t=fill("tets"),
            xs_pred=(torch.empty_like(xp)
                     if self.x_dtype == torch.bfloat16 else None))

    def unpack_state(self, carry: Carry, state: SimState) -> SimState:
        """Carry -> public state (``state`` supplies inv_mass and the
        lambdas of absent families); stepping may continue from the same
        carry."""
        o2n = self._old2new
        return SimState(
            x=carry.xp[o2n], v=carry.vv[o2n],
            x_star=carry.xw[o2n, :3].float(),
            inv_mass=state.inv_mass,
            edge_lambda=(carry.lam_e[self._pos_of["edges"]]
                         if self.has_edges else state.edge_lambda),
            tet_lambda=(carry.lam_t[self._pos_of["tets"]]
                        if self.has_tets else state.tet_lambda))

    def carry_positions(self, carry: Carry) -> torch.Tensor:
        """Committed positions (V, 3) straight off the carry."""
        return carry.xp[self._old2new]

    # ---- stepping ---------------------------------------------------------

    def _resolve(self, edge_compliance, volume_compliance):
        # with per-constraint tables the scalars SCALE the tables
        p = self.params
        ec = ((1.0 if self._edge_c is not None else p.edge_compliance)
              if edge_compliance is None else edge_compliance)
        vc = ((1.0 if self._tet_c is not None else p.volume_compliance)
              if volume_compliance is None else volume_compliance)
        return np.float32(ec), np.float32(vc)

    def run_carry(self, carry: Carry, dt, n: int, edge_compliance=None,
                  volume_compliance=None, colliders_rt=None) -> Carry:
        """n steps on the carry, in place; returns it.  colliders_rt: the
        collider poses for these steps (same count as the make-time set)."""
        ec, vc = self._resolve(edge_compliance, volume_compliance)
        cols = kc.runtime_colliders(self.colliders, colliders_rt,
                                    self.device)
        packed = None if cols is None else kc.pack_colliders(cols,
                                                            self.device)
        p = self.params
        ss = max(1, p.substeps)
        # scalars in float32, as the JAX step computes them
        sdt = np.float32(dt) / np.float32(ss)
        big = sdt > np.float32(1e-12)
        inv_dt2 = np.float32(1.0) / (sdt * sdt) if big else np.float32(0.0)
        inv_dt = np.float32(1.0) / sdt if big else np.float32(0.0)
        e_alpha = float(np.maximum(ec, np.float32(0.0)) * inv_dt2)
        t_alpha = float(np.maximum(vc, np.float32(0.0)) * inv_dt2)
        free = carry.xw[:, 3:4] != 0.0
        for _ in range(int(n)):
            for _ in range(ss):
                self._substep(carry, free, float(sdt), float(inv_dt),
                              e_alpha, t_alpha, packed)
        return carry

    def _substep(self, c: Carry, free, sdt, inv_dt, e_alpha, t_alpha,
                 packed):
        p = self.params
        xw, xp, vv, pred = c.xw, c.xp, c.vv, c.xs_pred
        # predict: semi-implicit Euler; pinned rows hold still (on the bf16
        # table the f32 prediction is kept and the table rounds it)
        vv.copy_(torch.where(free, vv + self._gravity * sdt, vv))
        xs = torch.where(free, xp + vv * sdt, xp)
        if pred is not None:
            pred.copy_(xs)
        xw[:, :3] = xs
        ep, tp = self.device_plans.get("edges"), self.device_plans.get("tets")
        ground_y = f32(p.ground_y)
        for _ in range(p.iterations):
            if ep is not None:
                self._edge_sweep(ep, c, e_alpha)
            if tp is not None:
                self._tet_sweep(tp, c, t_alpha)
            # the stages below read the table's f32 upcast and round where
            # they write (identities on the f32 table)
            if p.ground_enabled:          # axis-aligned y clamp
                y = xw[:, 1].float()
                xw[:, 1] = torch.where(free[:, 0], y.clamp_min(ground_y), y)
            if packed is not None:        # free rows only; dead slots w = 0
                kc.collide(xw, packed, kc.XPBD_GROUND)
            if self.contact is not None:  # self, then surface collision
                xw[:, :3] = self.contact(xw[:, :3].float(),
                                         xw[:, 3].float())
        # commit: velocity update + ground friction; on the bf16 table the
        # f32 prediction plus the table's rounded correction
        xs = xw[:, :3]
        if pred is not None:
            xs = pred + (xs.float() - pred.to(xw.dtype).float())
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
        xw[:, :3] = xp

    def __call__(self, state: SimState, dt, edge_compliance=None,
                 volume_compliance=None, colliders_rt=None) -> SimState:
        return self.step_n(state, dt, 1, edge_compliance, volume_compliance,
                           colliders_rt)

    def step_n(self, state: SimState, dt, n: int, edge_compliance=None,
               volume_compliance=None, colliders_rt=None) -> SimState:
        refuse_grad("the 'sweep' step", state, edge_compliance,
                    volume_compliance, colliders_rt)
        carry = self.pack_state(state)
        self.run_carry(carry, dt, n, edge_compliance, volume_compliance,
                       colliders_rt)
        return self.unpack_state(carry, state)

