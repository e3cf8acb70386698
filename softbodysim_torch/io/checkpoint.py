"""State checkpoint and exact resume.

The counterpart of ``softbodysim_tpu/io/checkpoint.py``, in the same file
format: one ``.npz`` holding the six SimState fields as float32 arrays and
a ``__meta__`` JSON (``format_version`` 1, the caller's metadata, and the
solver parameters when given), so a file written by either package loads
in the other.  The lambdas are saved in public constraint order: pass the
Engine's public ``state``, which unpacks any sweep or pass carry into that
order.  Resume is exact: a fresh Engine given the loaded state steps on to
the same bits as the run that was never interrupted.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from ..core.state import SimState, SolverParams, resolve_device

_FIELDS = ("x", "v", "x_star", "inv_mass", "edge_lambda", "tet_lambda")
FORMAT_VERSION = 1
# the SolverParams fields a checkpoint records (the JAX package's list)
_PARAMS = ("substeps", "iterations", "dialect", "edge_compliance",
           "volume_compliance", "friction", "edge_stiffness",
           "volume_stiffness", "sor_omega", "particle_radius", "gravity",
           "ground_enabled", "ground_y")


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_state(path: str, state: SimState,
               params: Optional[SolverParams] = None,
               metadata: Optional[dict] = None):
    """Write ``state`` (+ optional params / metadata) to ``path`` (.npz)."""
    arrays = {name: _host(getattr(state, name)) for name in _FIELDS}
    meta = {"format_version": FORMAT_VERSION}
    if metadata:
        meta.update(metadata)
    if params is not None:
        meta["params"] = {k: getattr(params, k) for k in _PARAMS}
        meta["params"]["gravity"] = list(params.gravity)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_state(path: str, device=None):
    """(state, metadata) from ``path``; the state's tensors on ``device``
    (default: the card).  metadata holds 'params' if they were saved."""
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        if meta.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {meta['format_version']} is newer than "
                f"supported {FORMAT_VERSION}")
        state = SimState(**{name: torch.from_numpy(np.array(
            z[name], np.float32)).to(dev) for name in _FIELDS})
    return state, meta


def params_from_metadata(meta: dict) -> SolverParams:
    p = dict(meta["params"])
    p["gravity"] = tuple(p["gravity"])
    return SolverParams(**p)
