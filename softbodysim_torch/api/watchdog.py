"""Failure detection + elastic recovery.

The reference has NONE (SURVEY.md section 5: any protocol hiccup tears the
server down, no retry/checkpoint).  For long datagen/production runs the
watchdog adds periodic state validation (finite, velocity/position bounds)
with automatic rollback to the last good snapshot on divergence -- cheap
because the SimState is six tensors kept on the device.

Typical blow-up causes: overly stiff settings + large dt (XPBD is stable but
the Jacobi dialect with omega ~2 can oscillate), or NaNs from degenerate
user topology.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.state import SimState


@dataclasses.dataclass
class WatchdogConfig:
    check_every: int = 10          # steps between validations
    max_speed: float = 1e3         # |v| ceiling (world units / s)
    max_coord: float = 1e4         # |x| ceiling
    keep_snapshots: int = 2


def state_health(state: SimState) -> torch.Tensor:
    """Device-side health pack, one fused reduction: [finite, max|v|,
    max|x|] (f32, on the state's device; one read-back per check)."""
    finite = (torch.isfinite(state.x).all() & torch.isfinite(state.v).all()
              & torch.isfinite(state.x_star).all())
    return torch.stack([finite.to(torch.float32),
                        state.v.abs().max(), state.x.abs().max()])


def clone_state(state: SimState) -> SimState:
    """A copy of every field (``tensor.clone()``) on the same device."""
    return SimState(**{f.name: getattr(state, f.name).clone()
                       for f in dataclasses.fields(state)})


class Watchdog:
    """Wraps an Engine-like object (needs .state and .step).  A rollback
    sets ``engine.state``: an Engine drops its carry then, and its next
    step packs one from the restored state."""

    def __init__(self, engine, config: Optional[WatchdogConfig] = None):
        self.engine = engine
        self.config = config or WatchdogConfig()
        self._snapshots = []
        self._steps = 0
        self.rollbacks = 0
        self._snapshot()

    def _snapshot(self):
        self._snapshots.append((self._steps, clone_state(self.engine.state)))
        if len(self._snapshots) > self.config.keep_snapshots:
            self._snapshots.pop(0)

    def _healthy(self) -> bool:
        h = state_health(self.engine.state).tolist()
        c = self.config
        return bool(h[0] > 0.5 and h[1] <= c.max_speed and h[2] <= c.max_coord)

    @property
    def steps(self) -> int:
        """Steps since the start, rewound by a rollback to the restored
        snapshot's step."""
        return self._steps

    def step(self, dt: float = 1.0 / 60.0, **kw) -> bool:
        """One step + periodic validation.  Returns False when a rollback
        happened (caller may want to lower dt / stiffness)."""
        self.engine.step(dt, **kw)
        self._steps += 1
        if self._steps % self.config.check_every:
            return True
        if self._healthy():
            self._snapshot()
            return True
        # divergence: restore the oldest retained snapshot (the newest may
        # already carry the instability)
        self.rollbacks += 1
        restore_step, snap = self._snapshots[0]
        self.engine.state = clone_state(snap)
        self._steps = restore_step
        return False
