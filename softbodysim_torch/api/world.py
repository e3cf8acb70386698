"""World: multi-body orchestration -- the SoftBodyManager equivalent.

Reproduces the manager's scheduling semantics
(Assets/Scripts/Softbody/SoftBodyManager.cs), as
``softbodysim_tpu/api/world.py`` does:
  - register / unregister bodies and primitive colliders (:122-156);
  - fixed-dt accumulator frame stepping with maxStepsPerFrame /
    maxFrameDeltaTime clamps (:73-94);
  - one collider snapshot per step shared by all bodies (:239-261);
  - each body its own Engine; steps are enqueued on the device without
    waiting, so bodies overlap on the card's stream.  Homogeneous worlds
    should prefer ``parallel/batching.py`` or ``Scene.build_merged``, which
    step all bodies as one;
  - 1 Hz-style aggregated stage stats (:158-197) via ``perf/timing.py``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..collide.primitives import Colliders
from ..core.state import SolverParams, resolve_device
from ..core.topology import Topology
from ..perf.timing import StepStats
from .engine import Engine


class Body:
    """One registered soft body: a Topology + per-body solver params."""

    def __init__(self, topology: Topology, params: SolverParams,
                 name: str = "body", pinned=None, **engine_kw):
        self.name = name
        self.topology = topology
        self.params = params
        self.pinned = pinned
        self.engine: Optional[Engine] = None
        self._engine_kw = engine_kw

    def bind(self, colliders: Optional[Colliders], device=None):
        self.engine = Engine(self.topology, self.params,
                             colliders=colliders, pinned=self.pinned,
                             device=device, **self._engine_kw)

    def positions(self) -> np.ndarray:
        return self.engine.positions()


class World:
    """Multi-body registry + frame scheduler on one device (default: the
    card)."""

    # Collider snapshots are padded to a power-of-two capacity, so adding or
    # removing colliders below capacity is a same-count pose update (no
    # engine rebuild); only capacity GROWTH rebinds the bodies -- the
    # reference's pow2-grown GPU collider buffer (SoftBodySolver.cs:648-664).
    # Padded slots are real (inactive) collide work in every iteration, so
    # the floor is 8 slots, doubled on demand.
    COLLIDER_MIN_CAPACITY = 8

    def __init__(self, fixed_dt: float = 1.0 / 60.0,
                 max_steps_per_frame: int = 4,
                 max_frame_delta_time: float = 0.05, *, device=None):
        self.device = resolve_device(device)
        self.fixed_dt = fixed_dt
        self.max_steps_per_frame = max_steps_per_frame
        self.max_frame_delta_time = max_frame_delta_time
        self.bodies: List[Body] = []
        self._collider_items: List[Optional[dict]] = []
        self._colliders: Optional[Colliders] = None
        self._collider_capacity = 0
        self._accumulator = 0.0
        self.stats = StepStats()

    # -- registration (SoftBodyManager.cs:122-156) --
    def register(self, body: Body) -> Body:
        if body not in self.bodies:
            self.bodies.append(body)
            body.bind(self._colliders, self.device)
        return body

    def unregister(self, body: Body):
        if body in self.bodies:
            self.bodies.remove(body)

    @property
    def collider_capacity(self) -> int:
        return self._collider_capacity

    def _snapshot_colliders(self) -> Optional[Colliders]:
        if not self._collider_items:
            return None
        return Colliders.build(self._collider_items,
                               capacity=self._collider_capacity,
                               device=self.device)

    def _push_colliders(self, grew: bool):
        self._colliders = self._snapshot_colliders()
        for b in self.bodies:
            if grew or b.engine is None:
                b.bind(self._colliders, self.device)
            else:
                b.engine.update_colliders(self._colliders)

    def add_collider(self, item: dict) -> int:
        """item from the Colliders.sphere / box / capsule builders.  Returns
        a stable collider id.  Rebinds bodies only when the padded capacity
        grows (the first collider, or the count passing a power of two)."""
        try:                       # reuse a tombstone slot (ids stay stable)
            index = self._collider_items.index(None)
            self._collider_items[index] = item
        except ValueError:
            self._collider_items.append(item)
            index = len(self._collider_items) - 1
        count = len(self._collider_items)
        grew = count > self._collider_capacity
        if grew:
            cap = self.COLLIDER_MIN_CAPACITY
            while cap < count:
                cap *= 2
            self._collider_capacity = cap
        self._push_colliders(grew)
        return index

    def remove_collider(self, index: int):
        """Deactivate a collider by id: its slot becomes a tombstone
        (inactive, reused by the next add); the count is unchanged, so no
        body is rebuilt (SoftBodyManager.UnregisterPrimitiveCollider)."""
        self._collider_items[index] = None
        self._push_colliders(grew=False)

    def update_collider(self, index: int, item: dict):
        """Move or replace a collider without a rebuild; takes effect at the
        next step (SoftBodyManager.RebuildColliderCache, :239-261)."""
        self._collider_items[index] = item
        self._push_colliders(grew=False)

    # -- stepping --
    def step(self, dt: Optional[float] = None, block: bool = False):
        """One fixed simulation step across all bodies
        (SoftBodyManager.StepSimulation, :199-237).  Steps are enqueued on
        the device and nothing waits unless ``block=True`` (or until
        ``positions()`` / ``sync()`` reads results)."""
        dt = self.fixed_dt if dt is None else dt
        t0 = time.perf_counter()
        for body in self.bodies:
            body.engine.step(dt)
        if block:
            self.sync()
        self.stats.add("step", time.perf_counter() - t0)

    def sync(self):
        """Wait for all in-flight steps to finish."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def frame(self, frame_dt: float) -> int:
        """Accumulator-driven frame update (SoftBodyManager.cs:73-94).
        Returns the number of fixed steps executed."""
        frame_dt = min(frame_dt, self.max_frame_delta_time)
        self._accumulator += frame_dt
        steps = 0
        while (self._accumulator >= self.fixed_dt
               and steps < self.max_steps_per_frame):
            self.step(self.fixed_dt)
            self._accumulator -= self.fixed_dt
            steps += 1
        if steps >= self.max_steps_per_frame:
            self._accumulator = 0.0
        return steps

    def positions(self) -> Dict[str, np.ndarray]:
        return {b.name: b.positions() for b in self.bodies}
