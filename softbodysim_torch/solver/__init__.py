"""Solver dialects (see core.state.SolverParams.dialect)."""

from .xpbd import make_xpbd_step


def make_step(topology, params, colliders=None, *, device=None, **kw):
    """Dispatch on params.dialect: 'xpbd' (server contract); 'jacobi'
    (in-engine contract) is not ported yet."""
    if params.dialect == "xpbd":
        return make_xpbd_step(topology, params, colliders=colliders,
                              device=device, **kw)
    if params.dialect == "jacobi":
        raise NotImplementedError(
            "the jacobi dialect is not ported yet (ROADMAP.md queue 1 "
            "item 7)")
    raise ValueError(f"unknown dialect {params.dialect!r}")


__all__ = ["make_step", "make_xpbd_step"]
