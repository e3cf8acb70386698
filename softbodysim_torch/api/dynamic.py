"""Mid-run scene growth with the backend chosen again at the new size.

The reference re-decides its compute mode every frame and migrates live
solver state between backends when the decision flips
(SoftBodySolver.cs:237-253: SyncGpuToCpuBlocking / UploadCpuToGpu around
the useGpu transition).  Here the transition that matters is SCENE
GROWTH: a merged world that crosses the kernel threshold
(``solver/select.py``: 'gather' below 100k constraints, 'pass' / 'sweep'
from there on the card) when bodies are added or removed mid-run.

``DynamicMergedWorld`` owns that transition, as
``softbodysim_tpu/api/dynamic.py`` does: add_body / remove_body rebuild the
merged engine with the backend resolved at the NEW scene size, and every
retained body's positions, velocities and XPBD lambdas carry across the
rebuild exactly.  The old engine's public state is read first (a carry
backend unpacks its packed layout there), then sliced per body on the
device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..collide.primitives import Colliders
from ..core.state import SimState, SolverParams, resolve_device
from ..core.topology import Topology, merge_topologies
from .engine import Engine


class DynamicMergedWorld:
    """A merged multi-body world whose body set can change between steps.

    All bodies share one ``SolverParams`` (``Scene.build_merged`` with
    uniform materials).  The engine is rebuilt lazily on the first use
    after a mutation; ``backend`` says what the thresholds resolved to.
    """

    def __init__(self, params: SolverParams,
                 colliders: Optional[Colliders] = None,
                 density: float = 1.0,
                 inv_mass_mode: Optional[str] = None, *, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.colliders = (None if colliders is None
                          else colliders.to(self.device))
        self.density = density
        self.inv_mass_mode = inv_mass_mode
        self._bodies: Dict[str, Topology] = {}
        self._pinned: Dict[str, Optional[np.ndarray]] = {}
        self._order = []            # insertion-ordered body names
        self._engine: Optional[Engine] = None
        self._dirty = False
        self._built_offs: Dict[str, tuple] = {}
        self._built_tops: Dict[str, Topology] = {}

    # ---- mutation --------------------------------------------------------

    def add_body(self, name: str, topology: Topology,
                 pinned=None) -> "DynamicMergedWorld":
        if name in self._bodies:
            raise ValueError(f"body {name!r} already exists")
        self._bodies[name] = topology
        self._pinned[name] = (np.atleast_1d(np.asarray(pinned, np.int64))
                              if pinned is not None else None)
        self._order.append(name)
        self._dirty = True
        return self

    def remove_body(self, name: str) -> "DynamicMergedWorld":
        if name not in self._bodies:
            raise KeyError(name)
        del self._bodies[name]
        del self._pinned[name]
        self._order.remove(name)
        self._dirty = True
        return self

    # ---- rebuild with state carry ---------------------------------------

    def _offsets(self, names):
        """{name: (vertex, edge, tet) offsets} in the merged order."""
        vo = eo = to = 0
        out = {}
        for n in names:
            out[n] = (vo, eo, to)
            t = self._bodies[n]
            vo, eo, to = (vo + t.num_particles, eo + t.num_edges,
                          to + t.num_tets)
        return out

    def _rebuild(self):
        names = list(self._order)
        if not names:
            raise ValueError("DynamicMergedWorld has no bodies")
        merged, voffs = merge_topologies([self._bodies[n] for n in names])
        pinned = [i for k, n in enumerate(names)
                  if self._pinned[n] is not None
                  for i in (self._pinned[n] + int(voffs[k])).tolist()]
        engine = Engine(
            merged, self.params, colliders=self.colliders,
            density=self.density, inv_mass_mode=self.inv_mass_mode,
            pinned=np.asarray(pinned, np.int64) if pinned else None,
            device=self.device)
        new_offs = self._offsets(names)

        if self._engine is not None:
            # retained bodies carry their dynamic state slice for slice;
            # new bodies keep their fresh slices (lambdas zero: the
            # reference zeroes them only at a body's init)
            old = self._engine.state        # unpacks a carry layout
            new = engine.state
            x, v = new.x.clone(), new.v.clone()
            el, tl = new.edge_lambda.clone(), new.tet_lambda.clone()
            for n in names:
                t = self._bodies[n]
                if self._built_tops.get(n) is not t:
                    continue
                (ovo, oeo, oto), (nvo, neo, nto) = (self._built_offs[n],
                                                    new_offs[n])
                for dst, src, o_new, o_old, count in (
                        (x, old.x, nvo, ovo, t.num_particles),
                        (v, old.v, nvo, ovo, t.num_particles),
                        (el, old.edge_lambda, neo, oeo, t.num_edges),
                        (tl, old.tet_lambda, nto, oto, t.num_tets)):
                    dst[o_new:o_new + count] = src[o_old:o_old + count]
            engine.state = SimState(x=x, v=v, x_star=x.clone(),
                                    inv_mass=new.inv_mass, edge_lambda=el,
                                    tet_lambda=tl)

        self._engine = engine
        self._built_offs = new_offs
        self._built_tops = dict(self._bodies)
        self._dirty = False

    @property
    def engine(self) -> Engine:
        if self._engine is None or self._dirty:
            self._rebuild()
        return self._engine

    @property
    def backend(self) -> Optional[str]:
        """The backend the thresholds resolved to for the CURRENT body set
        (rebuilds if stale)."""
        return self.engine.backend

    # ---- stepping / readback --------------------------------------------

    def step(self, dt: float = 1.0 / 60.0) -> "DynamicMergedWorld":
        self.engine.step(dt)
        return self

    def run(self, steps: int, dt: float = 1.0 / 60.0):
        self.engine.run(steps, dt)
        return self

    def _body_rows(self, a: np.ndarray, name: Optional[str]) -> np.ndarray:
        if name is None:
            return a
        vo = self._built_offs[name][0]
        return a[vo:vo + self._bodies[name].num_particles]

    def positions(self, name: Optional[str] = None) -> np.ndarray:
        return self._body_rows(self.engine.positions(), name)

    def velocities(self, name: Optional[str] = None) -> np.ndarray:
        return self._body_rows(self.engine.velocities(), name)
