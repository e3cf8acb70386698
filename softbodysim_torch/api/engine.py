"""Engine: one scene, one device, stepped in place.

``Engine(topology, params, colliders=..., device=...)`` builds the initial
state (inverse masses, rest state, zero lambdas) and the solver step;
``step(dt)`` and ``run(n, dt)`` advance it; ``positions()`` returns the
committed positions.  Backends with a carry API (the sweep and pass
backends) keep their internal layout on the device between calls: the
public state is materialized lazily on access, so the layout / lambda
boundary is paid once per state transfer, not once per step.

Colliders (both dialects, every backend) are runtime poses: the engine's
current set goes to every step, so ``update_colliders`` moves them without
rebuilding the step (the reference rebuilds its collider snapshot every
step, SoftBodyManager.cs:239-261).

``mesh`` (``parallel.sharding.make_mesh``: a ``DeviceMesh`` over a
``torch.distributed`` process group) splits the scene across the ranks of
its "model" dimension (``parallel.sharding.make_sharded_step``: the
kernel-sharded steps for a big scene on the card or a forced kernel
backend, the vertex-sharded steps otherwise): the same step / run /
positions API, each rank keeping its own rows on its device between calls
(the carry), the public state gathered on access.  Every
rank builds the Engine with the same arguments and makes the same calls
in the same order (reading the state or the positions gathers across the
ranks).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..collide.primitives import Colliders
from ..core.state import SimState, SolverParams, init_state, resolve_device
from ..core.topology import Topology
from ..solver import make_step


class Engine:
    """Single-scene simulation engine on one device (default: the card;
    ``device="cpu"`` runs the kernels' plain PyTorch versions), or on
    each rank of ``mesh`` (module docstring)."""

    _carry = None
    _state_stale = False

    # Multi-step bursts run in fixed-size chunks, as in the JAX engine.
    RUN_CHUNK = 32

    def __init__(self, topology: Topology, params: SolverParams,
                 colliders: Optional[Colliders] = None, pinned=None,
                 inv_mass_mode: Optional[str] = None, density: float = 1.0,
                 pin_top_layer: bool = False, mesh=None, device=None,
                 **solver_kw):
        """``solver_kw``: per-constraint tables (``edge_c`` / ``tet_c``
        compliance for the xpbd sweep backend, ``edge_k`` / ``tet_k``
        stiffness for jacobi, public order); for xpbd ``superblocks``
        (False: the legacy 128-wide sweep kernels); for jacobi
        ``local_to_world`` / ``world_to_local``.  ``colliders`` work on
        both dialects and every backend.  ``mesh``: split the scene across
        its ranks (module docstring; the sharded steps take no
        ``solver_kw``)."""
        if mesh is not None and solver_kw:
            raise ValueError(f"the sharded steps take no {sorted(solver_kw)}"
                             " (per-constraint tables, legacy plans and "
                             "body transforms are single-device)")
        if inv_mass_mode is None:
            # server dialect: tet-volume inverse masses; in-engine: density
            inv_mass_mode = "tet" if params.dialect == "xpbd" else "density"
        self.device = resolve_device(device)
        self.topology = topology
        self.params = params
        self.mesh = mesh
        self.colliders = (None if colliders is None
                          else colliders.to(self.device))
        self._inv_mass_mode = inv_mass_mode
        self.state: SimState = init_state(
            topology, pinned=pinned, inv_mass_mode=inv_mass_mode,
            density=density, pin_top_layer=pin_top_layer,
            device=self.device)
        self._raw_step = self._make_step(params, **solver_kw)

    def _make_step(self, params, **solver_kw):
        if self.mesh is None:
            return make_step(self.topology, params, self.colliders,
                             device=self.device, **solver_kw)
        from ..parallel.sharding import make_sharded_step

        return make_sharded_step(self.topology, params, self.mesh,
                                 colliders=self.colliders,
                                 device=self.device)

    # ---- lazy public state over the carry backends -----------------------

    @property
    def state(self) -> SimState:
        if self._carry is not None and self._state_stale:
            self._state = self._raw_step.unpack_state(self._carry,
                                                      self._state)
            self._state_stale = False
        return self._state

    @state.setter
    def state(self, s: SimState):
        self._state = s
        self._carry = None
        self._state_stale = False

    def _ensure_carry(self):
        if self._carry is None:
            self._carry = self._raw_step.pack_state(self._state)
            self._state_stale = False

    def _with_colliders(self, overrides: dict) -> dict:
        if self.colliders is not None and "colliders_rt" not in overrides:
            overrides["colliders_rt"] = self.colliders
        return overrides

    def step(self, dt: float = 1.0 / 60.0, **overrides) -> "Engine":
        """One step; overrides go to the solver step (per-step compliance
        or stiffness scalars, omega, ``colliders_rt``; the xpbd coloured
        backend also takes ``friction`` and ``gravity_override``; jacobi
        body transforms for this step)."""
        overrides = self._with_colliders(overrides)
        rc = getattr(self._raw_step, "run_carry", None)
        if rc is not None:
            self._ensure_carry()
            self._carry = rc(self._carry, dt, 1, **overrides)
            self._state_stale = True
        else:
            self.state = self._raw_step(self.state, dt, **overrides)
        return self

    def run(self, steps: int, dt: float = 1.0 / 60.0) -> "Engine":
        """``steps`` fixed steps, in RUN_CHUNK bursts on a carry backend."""
        rc = getattr(self._raw_step, "run_carry", None)
        if rc is None:
            for _ in range(steps):
                self.step(dt)
            return self
        kw = self._with_colliders({})
        self._ensure_carry()
        for _ in range(steps // self.RUN_CHUNK):
            self._carry = rc(self._carry, dt, self.RUN_CHUNK, **kw)
        for _ in range(steps % self.RUN_CHUNK):
            self._carry = rc(self._carry, dt, 1, **kw)
        self._state_stale = True
        return self

    def update_colliders(self, colliders: Colliders) -> "Engine":
        """New collider poses for the following steps (same count as the
        engine's set; ``switch_params`` changes the set itself)."""
        if self.colliders is None or colliders.count != self.colliders.count:
            raise ValueError("collider count must match the template; use "
                             "switch_params to change the set")
        self.colliders = colliders.to(self.device)
        return self

    @property
    def backend(self) -> Optional[str]:
        """The concrete solver backend the step resolved to ("sweep" or
        "gather" for xpbd; "pass", "gather", "segment" for jacobi)."""
        return getattr(self._raw_step, "backend", None)

    def positions_device(self) -> torch.Tensor:
        """Committed positions (V, 3) on the device; on a carry backend a
        row read, without the lambda unpack."""
        if self._carry is not None and self._state_stale:
            return self._raw_step.carry_positions(self._carry)
        return self.state.x

    def positions(self) -> np.ndarray:
        """Committed positions, V x 3, on the host."""
        return self.positions_device().cpu().numpy()

    def velocities(self) -> np.ndarray:
        return self.state.v.cpu().numpy()

    def reset(self, pinned=None, **kw) -> "Engine":
        """Re-INIT: rebuild the rest state."""
        kw.setdefault("inv_mass_mode", self._inv_mass_mode)
        self.state = init_state(self.topology, pinned=pinned,
                                device=self.device, **kw)
        return self

    def block(self) -> "Engine":
        """Wait until the device has finished the queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def raise_on_timeouts(self) -> "Engine":
        """Raise if a sweep launch of this engine's step aborted on a
        timed-out wait since the last check (only the sweep backend's
        kernels can abort).  Valid once the queued work has finished:
        after ``block()``, or an event recorded after it."""
        check = getattr(self._raw_step, "raise_on_timeouts", None)
        if check is not None:
            check()
        return self

    def switch_params(self, params: SolverParams,
                      colliders: Optional[Colliders] = "unchanged",
                      **solver_kw) -> "Engine":
        """Swap the solver configuration (and, given ``colliders``, the
        collider set) mid-run; x, v and the lambdas carry over."""
        if isinstance(colliders, str) and colliders == "unchanged":
            colliders = self.colliders
        self.params = params
        self.colliders = (None if colliders is None
                          else colliders.to(self.device))
        self.state = self.state       # materialize, then drop the old carry
        self._raw_step = self._make_step(params, **solver_kw)
        return self
