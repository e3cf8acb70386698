"""Solver dialects (see core.state.SolverParams.dialect)."""

from .jacobi import make_jacobi_step
from .xpbd import make_xpbd_step


def make_step(topology, params, colliders=None, *, device=None, **kw):
    """Dispatch on params.dialect: 'xpbd' (server contract) or 'jacobi'
    (in-engine contract), on ``device`` (default: the card).
    ``differentiable=True`` (xpbd only; a keyword of the port's own, not
    a SolverParams field) builds the coloured step for autograd, 'auto'
    resolving to 'gather' (``diff.py``); the jacobi plain steps are
    differentiable as built."""
    if params.dialect == "xpbd":
        return make_xpbd_step(topology, params, colliders=colliders,
                              device=device, **kw)
    if params.dialect == "jacobi":
        return make_jacobi_step(topology, params, colliders=colliders,
                                device=device, **kw)
    raise ValueError(f"unknown dialect {params.dialect!r}")


# after make_step: the sharded steps import ``parallel``, whose batching
# module imports make_step from here
from .jacobi_pass_sharded import make_jacobi_pass_sharded_step  # noqa: E402
from .xpbd_sweep_sharded import make_xpbd_sweep_sharded_step  # noqa: E402

__all__ = ["make_step", "make_xpbd_step", "make_jacobi_step",
           "make_xpbd_sweep_sharded_step", "make_jacobi_pass_sharded_step"]
