"""Engine: one scene, one device, stepped in place.

``Engine(topology, params, device=...)`` builds the initial state (inverse
masses, rest state, zero lambdas) and the solver step; ``step(dt)`` and
``run(n, dt)`` advance it; ``positions()`` returns the committed positions.
Backends with a carry API (the sweep backend) keep their internal layout on
the device between calls: the public state is materialized lazily on
access, so the layout / lambda boundary is paid once per state transfer,
not once per step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.state import SimState, SolverParams, init_state, resolve_device
from ..core.topology import Topology
from ..solver import make_step


class Engine:
    """Single-scene simulation engine on one device (default: the CPU)."""

    _carry = None
    _state_stale = False

    # Multi-step bursts run in fixed-size chunks, as in the JAX engine.
    RUN_CHUNK = 32

    def __init__(self, topology: Topology, params: SolverParams,
                 colliders=None, pinned=None,
                 inv_mass_mode: Optional[str] = None, density: float = 1.0,
                 pin_top_layer: bool = False, mesh=None, device=None,
                 **solver_kw):
        """``solver_kw``: per-constraint compliance tables ``edge_c`` /
        ``tet_c`` (public order).  ``colliders`` and ``mesh`` are not ported
        yet and raise."""
        if mesh is not None:
            raise NotImplementedError(
                "multi-device meshes are not ported yet (ROADMAP.md queue 1 "
                "item 12)")
        if colliders is not None:
            raise NotImplementedError(
                "colliders are not ported yet (ROADMAP.md queue 1 item 3)")
        if inv_mass_mode is None:
            # server dialect: tet-volume inverse masses; in-engine: density
            inv_mass_mode = "tet" if params.dialect == "xpbd" else "density"
        self.device = resolve_device(device)
        self.topology = topology
        self.params = params
        self._inv_mass_mode = inv_mass_mode
        self.state: SimState = init_state(
            topology, pinned=pinned, inv_mass_mode=inv_mass_mode,
            density=density, pin_top_layer=pin_top_layer,
            device=self.device)
        self._raw_step = make_step(topology, params, device=self.device,
                                   **solver_kw)

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

    def step(self, dt: float = 1.0 / 60.0, **overrides) -> "Engine":
        """One step; overrides (per-step compliance scalars) go to the
        solver step."""
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
        self._ensure_carry()
        for _ in range(steps // self.RUN_CHUNK):
            self._carry = rc(self._carry, dt, self.RUN_CHUNK)
        for _ in range(steps % self.RUN_CHUNK):
            self._carry = rc(self._carry, dt, 1)
        self._state_stale = True
        return self

    @property
    def backend(self) -> Optional[str]:
        """The concrete solver backend the step resolved to ("sweep")."""
        return getattr(self._raw_step, "backend", None)

    def positions_device(self) -> torch.Tensor:
        """Committed positions (V, 3) on the device; on a carry backend a
        row gather, without the lambda unpack."""
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

    def switch_params(self, params: SolverParams, **solver_kw) -> "Engine":
        """Swap the solver configuration mid-run; x, v and the lambdas
        carry over."""
        self.params = params
        self.state = self.state       # materialize, then drop the old carry
        self._raw_step = make_step(self.topology, params, device=self.device,
                                   **solver_kw)
        return self
