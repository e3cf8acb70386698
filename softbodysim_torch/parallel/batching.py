"""Batched scenes: many independent copies of one soft body, one step.

The JAX package vmaps one scene's step over a leading scene axis
(``softbodysim_tpu/parallel/batching.py``): BatchTest-style datagen or
BASELINE config #5's randomized-stiffness scenes as one program.  The
port's CUDA ops and the coloured step's CUDA graphs do not go through
``torch.func.vmap``, so the B copies are stepped as ONE disjoint union
(``core/topology.py::merge_topologies``): the union's colour c holds every
copy's colour c, no constraint crosses copies, and each copy's physics is
its solo step's.  Every op and kernel of the step (the collide kernel
included) launches once for all B scenes.  The contact stages hash each
copy alone (``copies``, ``solver/spatial.py``): copies never touch.

The backend is resolved on the single scene, as the JAX package resolves
it (the union of 128 copies would cross the kernel threshold): 'gather' or
'segment' for jacobi, 'gather' for xpbd.  The kernel backends ('pass',
'sweep') are refused with the JAX package's error for its Pallas steps.
The public state keeps the JAX layout: every field has a leading scene
axis, (B, V, 3) positions and (B, E) lambdas.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..collide.primitives import Colliders
from ..core.state import SimState, SolverParams, init_state, resolve_device
from ..core.topology import Topology, merge_topologies
from ..solver import make_step
from ..solver.select import resolve_backend

_FIELDS = ("x", "v", "x_star", "inv_mass", "edge_lambda", "tet_lambda")
# per-scene stiffness at run time: the step overrides it feeds, per dialect
_STIFFNESS = {"jacobi": ("edge_stiffness", "volume_stiffness"),
              "xpbd": ("edge_compliance", "volume_compliance")}


def _flatten(state: SimState) -> SimState:
    """(B, ...) fields -> the union's (B * ...) fields (views)."""
    return SimState(**{k: getattr(state, k).reshape(
        (-1,) + tuple(getattr(state, k).shape[2:])) for k in _FIELDS})


def _unflatten(state: SimState, batch: int) -> SimState:
    """The union's fields -> (B, ...) fields (views)."""
    def split(t):
        return t.reshape((batch, t.shape[0] // batch) + tuple(t.shape[1:]))

    return SimState(**{k: split(getattr(state, k)) for k in _FIELDS})


def replicate(base: SimState, batch: int) -> SimState:
    """``base`` repeated along a new leading scene axis (new tensors)."""
    return SimState(**{k: getattr(base, k).unsqueeze(0).repeat(
        (batch,) + (1,) * getattr(base, k).dim()) for k in _FIELDS})


def init_batch_state(topology: Topology, batch: int, pinned=None,
                     inv_mass_mode: str = "tet", key=None,
                     pos_jitter: float = 0.0, *, device=None) -> SimState:
    """An initial state replicated along a leading scene axis, positions
    optionally jittered per scene (datagen diversity).  ``key``: a
    ``torch.Generator`` for the jitter (default: one seeded with 0); the
    noise is drawn on the generator's device, then moved to ``device``."""
    dev = resolve_device(device)
    state = replicate(init_state(topology, pinned=pinned,
                                 inv_mass_mode=inv_mass_mode, device=dev),
                      batch)
    if pos_jitter > 0.0:
        if key is None:
            key = torch.Generator().manual_seed(0)
        noise = torch.randn(tuple(state.x.shape), generator=key,
                            dtype=torch.float32, device=key.device)
        x = state.x + float(np.float32(pos_jitter)) * noise.to(dev)
        state = SimState(x=x, v=state.v, x_star=x.clone(),
                         inv_mass=state.inv_mass,
                         edge_lambda=state.edge_lambda,
                         tet_lambda=state.tet_lambda)
    return state


KERNEL_BACKENDS = ("pass", "sweep")     # the JAX package's Pallas steps


class BatchedStep:
    """``step(state, dt) -> state`` over batched states, or with
    ``randomized_stiffness`` ``step(state, dt, edge, volume)``, each a (B,)
    per-scene value: stiffness for jacobi, compliance for xpbd.  The
    union's step is built for the batch size of the call (once, where the
    size stays)."""

    def __init__(self, topology: Topology, params: SolverParams,
                 colliders: Optional[Colliders] = None,
                 randomized_stiffness: bool = False, *, device=None):
        self.topology = topology
        self.colliders = colliders
        self.randomized = randomized_stiffness
        self.device = resolve_device(device)
        # the single scene's backend, as the JAX package resolves it
        self.backend = resolve_backend(topology, params, device=self.device)
        if self.backend in KERNEL_BACKENDS:
            raise ValueError(
                "the Pallas backends cannot be vmapped (pre-jitted steps with "
                "donated state); use xpbd_backend/jacobi_backend='gather' for "
                "batched scenes, or Scene.build_merged for one big scene")
        knob = ("jacobi_backend" if params.dialect == "jacobi"
                else "xpbd_backend")
        self.params = params.replace(**{knob: self.backend})
        self._batch, self._union = None, None

    def __call__(self, state: SimState, dt, *stiffness) -> SimState:
        batch = int(state.x.shape[0])
        if batch != self._batch:      # the step of `batch` disjoint copies
            union, _ = merge_topologies([self.topology] * batch)
            # each copy hashed alone by the contact stages, as each
            # vmapped scene is
            self._union = make_step(union, self.params, self.colliders,
                                    device=self.device, copies=batch)
            self._batch = batch
        kw = {}
        if self.randomized:
            if len(stiffness) != 2:
                raise TypeError("a randomized-stiffness step takes (state, "
                                "dt, edge[B], volume[B])")
            counts = (self.topology.num_edges, self.topology.num_tets)
            for name, per_scene, n in zip(_STIFFNESS[self.params.dialect],
                                          stiffness, counts):
                kw[name] = torch.as_tensor(
                    per_scene, dtype=torch.float32).to(
                        self.device).reshape(batch).repeat_interleave(n)
        elif stiffness:
            raise TypeError("per-scene stiffness needs "
                            "randomized_stiffness=True")
        return _unflatten(self._union(_flatten(state), dt, **kw), batch)


def make_batched_step(topology: Topology, params: SolverParams,
                      colliders: Optional[Colliders] = None,
                      randomized_stiffness: bool = False, *, device=None):
    """One scene's step over a leading batch axis (the JAX package's
    vmapped step).  randomized_stiffness=True takes per-scene arrays:
      xpbd:   step(state, dt, edge_compliance[B], volume_compliance[B])
      jacobi: step(state, dt, edge_stiffness[B], volume_stiffness[B])
    """
    return BatchedStep(topology, params, colliders, randomized_stiffness,
                       device=device)


def sample_stiffness(key, batch: int, low: float, high: float,
                     device=None) -> torch.Tensor:
    """Uniform per-scene stiffness samples in [low, high) for RL-rollout
    datagen; ``key``: a ``torch.Generator``."""
    u = torch.rand((batch,), generator=key, dtype=torch.float32,
                   device=None if key is None else key.device)
    return (u * float(high - low) + float(low)).to(resolve_device(device))


class BatchedEngine:
    """Engine-like wrapper around a batch of scenes stepped as one."""

    def __init__(self, topology: Topology, params: SolverParams, batch: int,
                 colliders: Optional[Colliders] = None, pinned=None,
                 randomized_stiffness: bool = False, key=None,
                 pos_jitter: float = 0.0, *, device=None):
        self.device = resolve_device(device)
        self.topology, self.params, self.batch = topology, params, batch
        inv_mode = "tet" if params.dialect == "xpbd" else "density"
        self.state = init_batch_state(
            topology, batch, pinned=pinned, inv_mass_mode=inv_mode, key=key,
            pos_jitter=pos_jitter, device=self.device)
        self.randomized = randomized_stiffness
        self._step = make_batched_step(
            topology, params,
            None if colliders is None else colliders.to(self.device),
            randomized_stiffness, device=self.device)

    @property
    def backend(self) -> str:
        return self._step.backend

    def step(self, dt: float = 1.0 / 60.0, *stiffness) -> "BatchedEngine":
        self.state = self._step(self.state, dt, *stiffness)
        return self

    def positions(self) -> np.ndarray:
        """(B, V, 3) committed positions on the host."""
        return self.state.x.cpu().numpy()

    def block(self) -> "BatchedEngine":
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self
