"""The Jacobi pass kernels, one scene split across the ranks of a
``torch.distributed`` mesh: homed accumulator halos.

The counterpart of ``softbodysim_tpu/solver/jacobi_pallas_sharded.py``, as
``jacobi_pass.py`` is of ``jacobi_pallas.py``.  The window partition and the
ghost maps are the sharded XPBD step's (``xpbd_sweep_sharded.partition`` /
``build_sharded_family``).  Jacobi is a snapshot gather and a
count-averaged apply (SoftBodySolver.cs:395-527), so each pass runs:

  1. all-gather the exported boundary windows; each rank builds its
     extended table (own windows + ghost copies) from the FROZEN snapshot
     the pass reads;
  2. the pass kernel's accumulate-only mode (``kernels/jacobi.py::
     jacobi_edge_accumulate`` / ``jacobi_tet_accumulate``, one CTA per
     spatial tile of the rank's extended rows, ``kernels/jacobi_plan.py``):
     per row the raw (delta xyz, count), nothing applied;
  3. all-gather the ghost rows' (delta, count) home to their owners, which
     add them to their own rows, in rank order (``Halo.home``: no
     scatter-add, so a run repeats its bits).  Each constraint is owned by
     one rank, so every contribution lands exactly once;
  4. apply x += (omega / count) * delta on the rank's own rows
     (``kernels/jacobi.py::apply_delta``, the JAX ``_apply_epilogue``
     math).

Pure Jacobi reads one snapshot, so this sharding is NOT a dialect change:
the result is the single-device pass step's up to fp32 summation order.

Per iteration: the edge pass, the tet pass, then on the rank's own rows
the ground plane and the colliders (the stand-alone collide kernel,
particle radius, free rows only), the contact stages
(``solver/global_stages.py``), and the Chebyshev blend when it is on.
Gravity, stiffness and omega come from the params (or per call);
colliders are a make-time set, moved per call by ``colliders_rt``;
per-constraint stiffness tables and body transforms stay single-device,
as in the JAX package.  Not differentiable (``select.refuse_grad``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..collide.primitives import Colliders
from ..core.state import SimState, SolverParams, f32
from ..kernels import collide as kc
from ..kernels import jacobi as kj
from .accel import chebyshev_loop
from .select import refuse_grad
from .xpbd_sweep_sharded import (LANES, Halo, ShardedFamily, ShardedRows,
                                 build_sharded_family)


class PassShardedCarry(NamedTuple):
    """A rank's run state: its own layout rows (positions + inverse mass)
    and their velocities."""

    xo: torch.Tensor
    vv: torch.Tensor


class _Fam(NamedTuple):
    fam: ShardedFamily
    plan: object                        # kj.EdgePassPlan / kj.TetPassPlan
    halo: Halo
    ext: Optional[torch.Tensor]         # (own + ghost rows, 4), or None
    acc: torch.Tensor                   # (own + ghost rows, 4)
    accumulate: object                  # the accumulate wrapper


class JacobiPassShardedStep(ShardedRows):
    """``step(state, dt) -> state`` on the Jacobi pass kernels' accumulate
    mode, split across the ranks of ``mesh`` (module docstring), with the
    carry API of ``jacobi_pass.JacobiPassStep``.  ``shard_info``: the
    partition and each family's maps."""

    backend = "pass"

    def __init__(self, topology, params: SolverParams, mesh,
                 colliders: Optional[Colliders] = None, *, device=None):
        if params.dialect != "jacobi":
            raise ValueError("the sharded pass step implements the jacobi "
                             "dialect")
        super().__init__(topology, params, mesh, colliders, device)
        part, dev, rank = self.part, self.device, self.axis.index
        lo = rank * part.wd
        for name, cons, rest, make, acc_fn in (
                ("edges", topology.edges, topology.edge_rest,
                 kj.edge_pass_plan, kj.jacobi_edge_accumulate),
                ("tets", topology.tets, topology.tet_rest_vol,
                 kj.tet_pass_plan, kj.jacobi_tet_accumulate)):
            if len(cons) == 0:
                continue
            fam = build_sharded_family(cons, rest, part)
            halo = Halo(fam, part, self.axis, dev)
            # the extended rows' rest positions: own windows, then ghosts
            wins = np.concatenate([np.arange(lo, lo + part.wd),
                                   fam.ghosts[rank]])
            rows = (wins[:, None] * LANES + np.arange(LANES)).reshape(-1)
            plan = make(len(rows), fam.local, fam.rest, None, dev,
                        vertices=self.rest_rows[rows])
            self.fams[name] = _Fam(
                fam=fam, plan=plan, halo=halo,
                ext=(torch.zeros((len(rows), 4), device=dev)
                     if halo.g else None),
                acc=torch.zeros((len(rows), 4), device=dev),
                accumulate=acc_fn)

        self.ground = kc.make_ground(params)
        self.do_collide = params.ground_enabled or (
            colliders is not None and colliders.count > 0)
        self.shard_info = self._shard_info(
            tiles={name: f.plan.tiles for name, f in self.fams.items()})

    # ---- public <-> internal layout --------------------------------------

    def pack_state(self, state: SimState) -> PassShardedCarry:
        """Public state (the same on every rank) -> this rank's carry."""
        refuse_grad("the sharded 'pass' step", state)
        rows = self._rows
        xo = torch.cat([rows(state.x), rows(state.inv_mass)[:, None]],
                       1).contiguous()
        return PassShardedCarry(xo=xo, vv=rows(state.v))

    def unpack_state(self, carry: PassShardedCarry,
                     state: SimState) -> SimState:
        """This rank's carry -> the public state (the same on every rank;
        ``state`` supplies inv_mass and the lambdas, which this dialect
        does not use)."""
        full = self._gather_rows(torch.cat([carry.xo[:, :3], carry.vv], 1))
        x = full[:, 0:3].contiguous()
        return SimState(x=x, v=full[:, 3:6].contiguous(), x_star=x,
                        inv_mass=state.inv_mass,
                        edge_lambda=state.edge_lambda,
                        tet_lambda=state.tet_lambda)

    def carry_positions(self, carry: PassShardedCarry) -> torch.Tensor:
        return self._gather_rows(carry.xo[:, :3].contiguous())

    # ---- stepping ---------------------------------------------------------

    def _pass(self, f: _Fam, xo: torch.Tensor, k, omega) -> None:
        """One pass on the own rows, in place: halo in, accumulate, home,
        apply."""
        vb = xo.shape[0]
        f.accumulate(f.plan, self._ext(f, xo), f.acc, k)
        own = f.acc[:vb]
        if f.halo.active:
            f.halo.home(own, f.acc[vb:])
        xo[:, :3] = kj.apply_delta(xo[:, :3], xo[:, 3], own[:, :3],
                                   own[:, 3], omega)

    def run_carry(self, carry: PassShardedCarry, dt, n: int,
                  edge_stiffness=None, volume_stiffness=None,
                  sor_omega=None,
                  colliders_rt: Optional[Colliders] = None
                  ) -> PassShardedCarry:
        """n steps on this rank's carry, in place (every rank calls it
        with the same arguments); returns it."""
        p = self.params
        k_edge = f32(p.edge_stiffness if edge_stiffness is None
                     else edge_stiffness)
        k_vol = f32(p.volume_stiffness if volume_stiffness is None
                    else volume_stiffness)
        omega = f32(p.sor_omega if sor_omega is None else sor_omega)
        packed = kc.pack_colliders(
            kc.runtime_colliders(self.colliders, colliders_rt, self.device),
            self.device)
        sdt = np.float32(dt) / np.float32(max(1, p.substeps))
        inv_dt = float(np.float32(1.0) / sdt) if sdt > 0 else 0.0
        sdt = float(sdt)
        xo, vv = carry.xo, carry.vv
        free = xo[:, 3:4] != 0.0
        w_full = self._w_full(xo)
        passes = [(self.fams[name], k) for name, k in
                  (("edges", k_edge), ("tets", k_vol)) if name in self.fams]

        def iteration(x):
            for f, k in passes:
                self._pass(f, x, k, omega)
            if self.do_collide:
                kc.collide(x, packed, self.ground)
            if self.has_stage:
                self._contact(x, w_full)
            return x

        def set_rows(x, r):
            x[:, :3] = r
            return x

        for _ in range(int(n) * max(1, p.substeps)):
            # PreSolve (SoftBodySolver.cs:349-362): pinned velocities zeroed
            xp = xo[:, :3].clone()
            vv.copy_(torch.where(free, vv + self._gravity * sdt, 0.0))
            xo[:, :3] = torch.where(free, xp + vv * sdt, xp)
            chebyshev_loop(iteration, xo, p, get=lambda t: t[:, :3].clone(),
                           set_=set_rows)
            # PostSolve (SoftBodySolver.cs:364-377)
            vv.copy_(torch.where(free, (xo[:, :3] - xp) * inv_dt, 0.0))
        return carry

    def __call__(self, state: SimState, dt, edge_stiffness=None,
                 volume_stiffness=None, sor_omega=None,
                 colliders_rt: Optional[Colliders] = None) -> SimState:
        return self.step_n(state, dt, 1, edge_stiffness, volume_stiffness,
                           sor_omega, colliders_rt)

    def step_n(self, state: SimState, dt, n: int, edge_stiffness=None,
               volume_stiffness=None, sor_omega=None,
               colliders_rt: Optional[Colliders] = None) -> SimState:
        refuse_grad("the sharded 'pass' step", state, edge_stiffness,
                    volume_stiffness, sor_omega, colliders_rt)
        carry = self.run_carry(self.pack_state(state), dt, n,
                               edge_stiffness, volume_stiffness, sor_omega,
                               colliders_rt)
        return self.unpack_state(carry, state)


def make_jacobi_pass_sharded_step(topology, params: SolverParams, mesh, *,
                                  colliders=None,
                                  device=None) -> JacobiPassShardedStep:
    """The JAX package's ``make_jacobi_pallas_sharded_step`` (:60) on the
    port's pass kernels: ``step(state, dt)``, ``step.step_n(state, dt, n)``,
    ``step.shard_info``."""
    return JacobiPassShardedStep(topology, params, mesh, colliders,
                                 device=device)
