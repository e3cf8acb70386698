"""Grouped homogeneous batching: the multi-body scene engine for scenes
that instance a few mesh FAMILIES many times (ExtremeTest: 16 balls + 8
bunnies; BatchTest: 10 + 5 + 5).

One batched step per family (``parallel/batching.py``: the family's
instances as one disjoint union, one launch of each op for all of them);
instances share the family's topology and differ only in their initial
positions.  The counterpart of ``softbodysim_tpu/parallel/groups.py``,
which vmaps one jitted step per family.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..collide.primitives import Colliders
from ..core.state import SimState, SolverParams, init_state, resolve_device
from ..core.topology import Topology
from ..solver.select import resolve_backend
from .batching import KERNEL_BACKENDS, BatchedStep, replicate


class Group:
    """One mesh family: base topology + per-instance world offsets."""

    def __init__(self, topology: Topology, offsets, params: SolverParams,
                 name: str = "group", density: float = 1.0, pinned=None):
        self.name = name
        self.topology = topology
        self.offsets = np.asarray(offsets, np.float32).reshape(-1, 3)
        self.params = params
        self.density = density
        self.pinned = pinned

    @property
    def count(self) -> int:
        return len(self.offsets)


class GroupedSceneEngine:
    """Multi-family scene: one batched step per family."""

    def __init__(self, groups: Sequence[Group],
                 colliders: Optional[Colliders] = None, *, device=None):
        self.device = dev = resolve_device(device)
        self.groups = list(groups)
        cols = None if colliders is None else colliders.to(dev)
        self._engines = []
        for g in self.groups:
            inv_mode = "tet" if g.params.dialect == "xpbd" else "density"
            state = replicate(init_state(g.topology, pinned=g.pinned,
                                         inv_mass_mode=inv_mode,
                                         density=g.density, device=dev),
                              g.count)
            x = state.x + torch.from_numpy(g.offsets).to(dev)[:, None, :]
            state = SimState(x=x, v=state.v, x_star=x.clone(),
                             inv_mass=state.inv_mass,
                             edge_lambda=state.edge_lambda,
                             tet_lambda=state.tet_lambda)
            if resolve_backend(g.topology, g.params,
                               device=dev) in KERNEL_BACKENDS:
                raise ValueError(
                    "the Pallas backends cannot be vmapped; set the family "
                    "backend to 'gather' or use Scene.build_merged")
            step = BatchedStep(g.topology, g.params, cols, device=dev)
            self._engines.append({"state": state, "step": step})

    def step(self, dt: float = 1.0 / 60.0) -> "GroupedSceneEngine":
        for e in self._engines:
            e["state"] = e["step"](e["state"], dt)
        return self

    def block(self) -> "GroupedSceneEngine":
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def positions(self) -> List[Tuple[str, np.ndarray]]:
        """[(name#i, (V, 3) positions)] across all bodies."""
        out = []
        for g, e in zip(self.groups, self._engines):
            xs = e["state"].x.cpu().numpy()
            out.extend((f"{g.name}#{i}", xs[i]) for i in range(g.count))
        return out
