"""Jacobi-dialect solver on the CUDA pass kernels -- the large-scene path.

The counterpart of ``softbodysim_tpu/solver/jacobi_pallas.py``, as
``xpbd_sweep.py`` is of ``xpbd_pallas.py``: the same physics contract as
``solver/jacobi.py`` (predict; ``params.iterations`` x {edge pass, tet
pass, ground plane and colliders, Chebyshev blend if set}; velocity
update), each gather + apply stage one call of ``kernels/jacobi.py``.  Pure
Jacobi reads one snapshot per pass, so this matches the segment and gather
backends (and ``tests/oracle.py::JacobiOracle``) up to fp32 summation
order.

The collide stage (the ground plane, then the colliders) runs inside the
iteration's last pass -- the tet pass, or the edge pass of a mesh without
tets -- as that pass's collide variant (``kernels/jacobi.py::
jacobi_tet_pass_collide``): each row the pass writes is pushed out before
its store, so the stage costs no launch and no pass over the table of its
own.  The JAX package's Pallas backend ran this stage as XLA ops after
both passes (``jacobi_pallas.py:187-203``).  The contact stages
(``solver/contact.py``: self, then surface collision) follow the last
pass, inside the substep's graph, and the Chebyshev blend follows them.
This path is in public vertex order with no dead rows, so the contact
cap and table sizes are the JAX XLA jacobi step's, not ``jacobi_pallas``'s
(whose padded layout parks dead lanes).  Body transforms are not
supported here (``make_jacobi_step`` routes them to 'gather').

On a CUDA device one substep -- predict, the iterations' passes and
Chebyshev blends, commit -- is captured once as a CUDA graph
(``solver/graphs.py``) and replayed, so the host launches one graph per
substep instead of ~40 kernels and ops (the JAX package compiles the same
loop into one XLA program, ``jacobi_pallas.py:205-262``).  The graphs run
on static tables of the step; ``run_carry`` copies the carry, the
runtime collider poses and the step-time scalars (k_edge, k_vol, omega,
sdt, 1 / sdt: a device tensor that the kernels and the elementwise ops
read) in before the replays and the carry out after them.  So the only
key of a graph is which of the two tables holds the substep's start:
scalar overrides and poses that change every step capture nothing new.
On the CPU the substep runs eagerly on the plain versions.

Internal layout (one device, public vertex order, no permutation):
  xw : (V, 4) f32 -- positions + inverse mass (the current snapshot)
  xs : (V, 4) f32 -- the other table of the double-buffered passes
  vv : (V, 3) f32 -- velocities
Between substeps xw holds the committed positions.  Stepping updates the
tables in place (saving a table per pass) and swaps xw / xs; ``run_carry``
returns the carry with the current table first.

Not differentiable: the kernels write the tables in place, unseen by
autograd, so a step handed a tensor that requires grad raises
(``select.refuse_grad``; ``diff.make_rollout`` builds the 'segment' step),
as ``jax.grad`` through the JAX passes' ``pallas_call`` fails.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..collide.primitives import Colliders
from ..core.state import SimState, SolverParams, f32, resolve_device
from ..kernels import collide as kc
from ..kernels import jacobi as kj
from ..kernels import jacobi_plan
from .accel import chebyshev_loop
from .contact import make_contact_stage
from .graphs import GraphCache
from .select import refuse_grad


class PassCarry(NamedTuple):
    xw: torch.Tensor
    xs: torch.Tensor
    vv: torch.Tensor


class JacobiPassStep:
    """``step(state, dt) -> state`` on the pass kernels, with the carry API
    of the sweep backend: ``pack_state`` -> ``run_carry``* ->
    ``unpack_state``; ``carry_positions`` reads the committed positions.

    edge_k / tet_k: optional per-constraint stiffness (public order); the
    step-time stiffness scalars then multiply them (default 1.0).  Built
    by ``make_jacobi_step``, which rejects what this backend lacks.

    tiles: the (edge, tet) host tile plans of ``jacobi_plan.pass_tiles``
    for these colliders, when the caller already cut them."""

    backend = "pass"

    def __init__(self, topology, params: SolverParams,
                 colliders: Optional[Colliders] = None, *, device=None,
                 edge_k=None, tet_k=None, tiles=None):
        dev = self.device = resolve_device(device)
        self.params = params
        V = topology.num_particles
        self.colliders = None if colliders is None else colliders.to(dev)
        if tiles is None:     # the last pass stages the collider table
            tiles = jacobi_plan.pass_tiles(
                topology, 0 if colliders is None else colliders.count)
        edge_tiles, tet_tiles = tiles
        self.edge_plan = (kj.edge_pass_plan(
            V, topology.edges, topology.edge_rest, edge_k, dev,
            vertices=topology.vertices, tiles=edge_tiles)
            if topology.num_edges else None)
        self.tet_plan = (kj.tet_pass_plan(
            V, topology.tets, topology.tet_rest_vol, tet_k, dev,
            vertices=topology.vertices, tiles=tet_tiles)
            if topology.num_tets else None)
        self._per_k = (edge_k is not None, tet_k is not None)
        self.ground = kc.make_ground(params)
        self.do_collide = params.ground_enabled or (
            colliders is not None and colliders.count > 0)
        self.contact = make_contact_stage(topology, params, device=dev)
        self._gravity = torch.tensor(params.gravity, dtype=torch.float32,
                                     device=dev)
        # on the card, the graphs' static tables: the two pass tables, the
        # velocities, the packed colliders, the step-time scalars
        self._graphs = GraphCache(dev, kept=2)   # by start table
        self._buf = None if dev.type != "cuda" else dict(
            x=(torch.zeros((V, 4), device=dev),
               torch.zeros((V, 4), device=dev)),
            vv=torch.zeros((V, 3), device=dev),
            packed=kc.pack_colliders(self.colliders, dev),
            scal=torch.zeros(5, device=dev))
        self._scal_now = None                   # the scalars in _buf["scal"]

    # ---- public <-> internal layout --------------------------------------

    def pack_state(self, state: SimState) -> PassCarry:
        """Public state -> carry (new tensors; ``state`` is not touched and
        serves as the template for ``unpack_state``)."""
        refuse_grad("the 'pass' step", state)
        dev = self.device
        xw = torch.cat([state.x.to(dev, torch.float32),
                        state.inv_mass.to(dev, torch.float32)[:, None]],
                       1).contiguous()
        return PassCarry(xw=xw, xs=torch.empty_like(xw),
                         vv=state.v.to(dev, torch.float32).clone())

    def unpack_state(self, carry: PassCarry, state: SimState) -> SimState:
        """Carry -> public state (new tensors; ``state`` supplies inv_mass
        and the lambdas, which this dialect does not use)."""
        x = carry.xw[:, :3].clone()
        return SimState(x=x, v=carry.vv.clone(), x_star=x,
                        inv_mass=state.inv_mass,
                        edge_lambda=state.edge_lambda,
                        tet_lambda=state.tet_lambda)

    def carry_positions(self, carry: PassCarry) -> torch.Tensor:
        """Committed positions (V, 3) straight off the carry (a copy)."""
        return carry.xw[:, :3].clone()

    # ---- stepping ---------------------------------------------------------

    def _scalars(self, dt, edge_stiffness=None, volume_stiffness=None,
                 sor_omega=None) -> tuple:
        """(k_edge, k_vol, omega, sdt, 1 / sdt) as float32-exact floats."""
        p = self.params
        k_edge = f32((1.0 if self._per_k[0] else p.edge_stiffness)
                     if edge_stiffness is None else edge_stiffness)
        k_vol = f32((1.0 if self._per_k[1] else p.volume_stiffness)
                    if volume_stiffness is None else volume_stiffness)
        omega = f32(p.sor_omega if sor_omega is None else sor_omega)
        sdt = np.float32(dt) / np.float32(max(1, p.substeps))
        inv_dt = float(np.float32(1.0) / sdt) if sdt > 0 else 0.0
        return k_edge, k_vol, omega, float(sdt), inv_dt

    def _substep(self, bufs, x, vv, packed, scal) -> torch.Tensor:
        """One substep from table ``x`` (one of ``bufs``), in place:
        predict, the iterations, commit; returns the table that holds the
        result.  ``scal``: (5,) f32, ``_scalars`` on the device."""
        k_edge, k_vol, omega, sdt, inv_dt = scal.unbind()
        free = x[:, 3:4] != 0.0

        passes = [(plan, fn, fused, k) for plan, fn, fused, k in (
            (self.edge_plan, kj.jacobi_edge_pass,
             kj.jacobi_edge_pass_collide, k_edge),
            (self.tet_plan, kj.jacobi_tet_pass, kj.jacobi_tet_pass_collide,
             k_vol)) if plan is not None]

        def iteration(x):
            y = bufs[1] if x is bufs[0] else bufs[0]
            for i, (plan, fn, fused, k) in enumerate(passes):
                if self.do_collide and i == len(passes) - 1:
                    fused(plan, x, y, k, omega, packed, self.ground)
                else:
                    fn(plan, x, y, k, omega)
                x, y = y, x
            if self.do_collide and not passes:
                kc.collide(x, packed, self.ground)
            if self.contact is not None:
                x[:, :3] = self.contact(x[:, :3], x[:, 3])
            return x

        def set_rows(x, rows):
            x[:, :3] = rows
            return x

        # PreSolve (SoftBodySolver.cs:349-362): pinned velocities zeroed
        xp = x[:, :3].clone()
        vv.copy_(torch.where(free, vv + self._gravity * sdt, 0.0))
        x[:, :3] = torch.where(free, xp + vv * sdt, xp)
        x = chebyshev_loop(iteration, x, self.params,
                           get=lambda t: t[:, :3].clone(), set_=set_rows)
        # PostSolve (SoftBodySolver.cs:364-377)
        vv.copy_(torch.where(free, (x[:, :3] - xp) * inv_dt, 0.0))
        return x

    def _run_eager(self, carry: PassCarry, substeps: int, scalars,
                   packed) -> PassCarry:
        scal = torch.tensor(scalars, dtype=torch.float32, device=self.device)
        bufs = (carry.xw, carry.xs)
        x = carry.xw
        for _ in range(substeps):
            x = self._substep(bufs, x, carry.vv, packed, scal)
        return PassCarry(xw=x, xs=bufs[1] if x is bufs[0] else bufs[0],
                         vv=carry.vv)

    def _run_graphed(self, carry: PassCarry, substeps: int, scalars,
                     packed) -> PassCarry:
        b = self._buf
        if scalars != self._scal_now:     # copied only when they change
            b["scal"].copy_(torch.tensor(scalars, dtype=torch.float32)
                            .pin_memory(), non_blocking=True)
            self._scal_now = scalars
        b["x"][0].copy_(carry.xw)
        b["vv"].copy_(carry.vv)
        b["packed"].copy_(packed)

        def substep():                 # the index of the result's table
            x = self._substep(b["x"], b["x"][cur], b["vv"], b["packed"],
                              b["scal"])
            return 0 if x is b["x"][0] else 1
        cur = 0
        for _ in range(substeps):
            cur = self._graphs.run(cur, substep)
        carry.xw.copy_(b["x"][cur])
        carry.vv.copy_(b["vv"])
        return carry

    def run_carry(self, carry: PassCarry, dt, n: int, edge_stiffness=None,
                  volume_stiffness=None, sor_omega=None,
                  colliders_rt: Optional[Colliders] = None) -> PassCarry:
        """n steps on the carry's tables, in place; returns the carry with
        the current table first."""
        scalars = self._scalars(dt, edge_stiffness, volume_stiffness,
                                sor_omega)
        packed = kc.pack_colliders(
            kc.runtime_colliders(self.colliders, colliders_rt, self.device),
            self.device)
        substeps = int(n) * max(1, self.params.substeps)
        run = self._run_eager if self._buf is None else self._run_graphed
        return run(carry, substeps, scalars, packed)

    def __call__(self, state: SimState, dt, edge_stiffness=None,
                 volume_stiffness=None, sor_omega=None,
                 colliders_rt: Optional[Colliders] = None) -> SimState:
        return self.step_n(state, dt, 1, edge_stiffness, volume_stiffness,
                           sor_omega, colliders_rt)

    def step_n(self, state: SimState, dt, n: int, edge_stiffness=None,
               volume_stiffness=None, sor_omega=None,
               colliders_rt: Optional[Colliders] = None) -> SimState:
        refuse_grad("the 'pass' step", state, edge_stiffness,
                    volume_stiffness, sor_omega, colliders_rt)
        carry = self.run_carry(self.pack_state(state), dt, n, edge_stiffness,
                               volume_stiffness, sor_omega, colliders_rt)
        return self.unpack_state(carry, state)
