"""Carry a state, a collider set and solver parameters between the JAX
package and the port as plain NumPy data (used by the parity tests).
Imports neither jax nor the JAX package: the caller converts its arrays
with ``np.asarray``."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..collide.primitives import Colliders
from ..core.state import SimState, SolverParams, resolve_device

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))
COLLIDER_FIELDS = tuple(f.name for f in dataclasses.fields(Colliders))
_COLLIDER_DTYPES = {"type": np.int32, "position": np.float32,
                    "rotation": np.float32, "data": np.float32,
                    "active": bool}


def state_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> SimState:
    """A SimState on ``device`` (default: the card) from a dict of the six
    fields' arrays."""
    missing = [k for k in STATE_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"state arrays missing {missing}")
    dev = resolve_device(device)
    return SimState(**{
        k: torch.from_numpy(np.array(arrays[k], np.float32)).to(dev)
        for k in STATE_FIELDS})


def state_to_numpy(state: SimState) -> Dict[str, np.ndarray]:
    """The six fields as host float32 arrays."""
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in STATE_FIELDS}


def params_from_fields(obj) -> SolverParams:
    """A SolverParams copying every field of the same name from ``obj``
    (for example the JAX package's SolverParams)."""
    return SolverParams(**{f.name: getattr(obj, f.name)
                           for f in dataclasses.fields(SolverParams)
                           if hasattr(obj, f.name)})


def colliders_from_numpy(arrays: Dict[str, np.ndarray],
                         device=None) -> Colliders:
    """A Colliders set on ``device`` (default: the card) from a dict of the
    five fields' arrays (type, position, rotation, data, active)."""
    missing = [k for k in COLLIDER_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"collider arrays missing {missing}")
    dev = resolve_device(device)
    return Colliders(**{
        k: torch.from_numpy(np.array(arrays[k], _COLLIDER_DTYPES[k])).to(dev)
        for k in COLLIDER_FIELDS})


def colliders_to_numpy(colliders: Colliders) -> Dict[str, np.ndarray]:
    """The five fields as host arrays."""
    return {k: getattr(colliders, k).detach().cpu().numpy()
            for k in COLLIDER_FIELDS}
