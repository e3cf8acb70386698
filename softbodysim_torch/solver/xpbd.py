"""XPBD dialect dispatch (the C++ PBDServer contract).

Backends: "sweep" (block-synchronous CUDA sweep kernels, solver/
xpbd_sweep.py).  The coloured Gauss-Seidel backends ("gather", "scatter")
are not ported yet.
"""

from __future__ import annotations

from .select import resolve_backend


def make_xpbd_step(topology, params, colliders=None, *, device=None,
                   edge_c=None, tet_c=None):
    """Build ``step(state, dt) -> state`` for the resolved backend.

    edge_c / tet_c: optional per-constraint compliance (public order)."""
    backend = resolve_backend(topology, params, device=device)
    if backend == "sweep":
        from .xpbd_sweep import SweepStep

        return SweepStep(topology, params, colliders, device=device,
                         edge_c=edge_c, tet_c=tet_c)
    if backend in ("gather", "scatter"):
        raise NotImplementedError(
            f"xpbd_backend {backend!r} (coloured Gauss-Seidel) is not ported "
            "yet (ROADMAP.md queue 1 item 4); use xpbd_backend='sweep'")
    raise ValueError(f"unknown xpbd_backend {backend!r}")
