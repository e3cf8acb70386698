"""Backend auto-selection: the JAX package's size threshold, on the port's
devices.

``xpbd_backend="auto"`` resolves to the sweep kernels ("sweep") on a CUDA
device at >= 100k constraints and to the coloured Gauss-Seidel backend
("gather") otherwise; "pallas", the JAX package's name for its sweep
kernels, is an alias of "sweep", and "scatter", its other coloured
backend, an alias of "gather" (the same coloured sweep, computed once
here).  ``jacobi_backend="auto"`` resolves to the
pass kernels ("pass") on a CUDA device at >= 100k constraints without a
body transform and to "gather" otherwise; "pallas" is an alias of "pass".
"""

from __future__ import annotations

from ..core.state import resolve_device

SWEEP_MIN_CONSTRAINTS = 100_000
_KERNEL_BACKEND = {"xpbd": "sweep", "jacobi": "pass"}


def resolve_backend(topology, params, *, device=None,
                    local_to_world=None) -> str:
    """The concrete backend of ``params.dialect`` for ``topology`` on
    ``device``."""
    if params.dialect == "xpbd":
        backend, kernel_ok = params.xpbd_backend, True
    elif params.dialect == "jacobi":
        backend, kernel_ok = params.jacobi_backend, local_to_world is None
    else:
        raise ValueError(f"unknown dialect {params.dialect!r}")
    kernel = _KERNEL_BACKEND[params.dialect]
    if backend == "pallas":
        return kernel
    if backend == "scatter" and params.dialect == "xpbd":
        return "gather"
    if backend != "auto":
        return backend
    big = (topology.num_edges + topology.num_tets) >= SWEEP_MIN_CONSTRAINTS
    return kernel if big and kernel_ok and \
        resolve_device(device).type == "cuda" else "gather"
