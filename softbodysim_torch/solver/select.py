"""Backend auto-selection: the JAX package's size threshold, on the port's
devices.

``xpbd_backend="auto"`` resolves to the sweep kernels ("sweep") on a CUDA
device at >= 100k constraints and to the coloured Gauss-Seidel backend
("gather") otherwise.  "pallas", the JAX package's name for its sweep
kernels, is accepted as an alias of "sweep".
"""

from __future__ import annotations

from ..core.state import resolve_device

SWEEP_MIN_CONSTRAINTS = 100_000


def resolve_backend(topology, params, *, device=None) -> str:
    """The concrete xpbd backend for ``topology`` on ``device``."""
    if params.dialect == "jacobi":
        raise NotImplementedError(
            "the jacobi dialect is not ported yet (ROADMAP.md queue 1 "
            "item 7)")
    if params.dialect != "xpbd":
        raise ValueError(f"unknown dialect {params.dialect!r}")
    backend = params.xpbd_backend
    if backend == "pallas":
        return "sweep"
    if backend != "auto":
        return backend
    big = (topology.num_edges + topology.num_tets) >= SWEEP_MIN_CONSTRAINTS
    return "sweep" if big and resolve_device(device).type == "cuda" \
        else "gather"
