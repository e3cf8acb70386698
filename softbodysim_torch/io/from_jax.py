"""Carry a state (one scene's, or a batch's with a leading scene axis), a
topology, a collider set and solver parameters between the JAX package
and the port as plain NumPy data (used by the parity tests).
Imports neither jax nor the JAX package: the caller converts its arrays
with ``np.asarray``."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..collide.primitives import Colliders
from ..core.state import SimState, SolverParams, resolve_device
from ..core.topology import ColorGroups, Topology

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


def batched_state_from_numpy(arrays: Dict[str, np.ndarray], batch: int,
                             device=None) -> SimState:
    """A batched SimState (every field with a leading axis of ``batch``
    scenes, as ``parallel.batching`` keeps it) on ``device``."""
    state = state_from_numpy(arrays, device)
    for k in STATE_FIELDS:
        shape = tuple(getattr(state, k).shape)
        if not shape or shape[0] != batch:
            raise ValueError(f"{k}: shape {shape} has no leading axis of "
                             f"{batch} scenes")
    return state


def topology_from_fields(obj) -> Topology:
    """A Topology copying the arrays of ``obj``'s fields of the same names
    (for example a JAX package Topology), colour groups included."""
    def groups(g):
        return ColorGroups(idx=np.asarray(g.idx, np.int32),
                           mask=np.asarray(g.mask, bool),
                           order=np.asarray(g.order, np.int64))

    return Topology(
        vertices=np.asarray(obj.vertices, np.float32),
        edges=np.asarray(obj.edges, np.int32),
        tets=np.asarray(obj.tets, np.int32),
        surface_tris=np.asarray(obj.surface_tris, np.int32),
        edge_rest=np.asarray(obj.edge_rest, np.float32),
        tet_rest_vol=np.asarray(obj.tet_rest_vol, np.float32),
        edge_colors=groups(obj.edge_colors),
        tet_colors=groups(obj.tet_colors))


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
