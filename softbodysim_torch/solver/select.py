"""Backend auto-selection: the JAX package's size threshold, on the port's
devices.

``xpbd_backend="auto"`` resolves to the sweep kernels ("sweep") on a CUDA
device at >= 100k constraints and to the coloured Gauss-Seidel backend
("gather") otherwise; "pallas", the JAX package's name for its sweep
kernels, is an alias of "sweep", and "scatter", its other coloured
backend, an alias of "gather" (the same coloured sweep, computed once
here).  ``jacobi_backend="auto"`` resolves to the
pass kernels ("pass") on a CUDA device at >= 100k constraints without a
body transform, when the mesh's tile plans fit the pass kernels
(``kernels/jacobi_plan.py``: a dense mesh may not), and to "gather"
otherwise; "pallas" is an alias of "pass".

The kernel backends write their tables in place through ctypes, so
autograd sees none of it: ``refuse_grad`` makes a kernel step raise when
it is handed anything that requires grad, as ``jax.grad`` through a
``pallas_call`` without a VJP fails (``diff.make_rollout`` runs the plain
backends, as ``softbodysim_tpu/diff.py`` runs its XLA twins).
"""

from __future__ import annotations

import torch

from ..core.state import resolve_device
from ..kernels import jacobi_plan
from ..utils.trees import leaves

SWEEP_MIN_CONSTRAINTS = 100_000
_KERNEL_BACKEND = {"xpbd": "sweep", "jacobi": "pass"}


def refuse_grad(step: str, *values) -> None:
    """Raise when gradients are enabled and any of ``values`` (tensors,
    states, collider sets) requires grad: ``step`` runs code autograd
    cannot follow (kernels and CUDA graphs writing in place).  The kernel
    steps call it where a public state enters (``step_n``,
    ``pack_state``), not per ``run_carry``: a carry comes from
    ``pack_state``."""
    if torch.is_grad_enabled() and any(
            getattr(leaf, "requires_grad", False)
            for _, leaf in leaves(values)):
        raise RuntimeError(
            f"{step} writes its tables in place through CUDA kernels or "
            "graphs that define no gradient, and it was handed a tensor "
            "that requires grad: differentiate through softbodysim_torch."
            "diff.make_rollout, which builds the differentiable steps (xpbd"
            " 'gather' / 'scatter' with make_step(..., differentiable=True),"
            " jacobi 'segment' / 'gather'), or step under torch.no_grad()")


def resolve_backend(topology, params, *, device=None, local_to_world=None,
                    num_colliders: int = 0) -> str:
    """The concrete backend of ``params.dialect`` for ``topology`` on
    ``device``; ``num_colliders``: the jacobi pass stages that many rows of
    the collider table beside each tile (``jacobi_plan.pass_budget``)."""
    return resolve_with_tiles(topology, params, device=device,
                              local_to_world=local_to_world,
                              num_colliders=num_colliders)[0]


def resolve_with_tiles(topology, params, *, device=None,
                       local_to_world=None, num_colliders: int = 0) -> tuple:
    """(``resolve_backend``'s backend, the jacobi tile plans that 'auto'
    cut to see that the pass kernels fit, else None): the pass step takes
    them instead of cutting them again (``JacobiPassStep(tiles=)``)."""
    if params.dialect == "xpbd":
        backend, kernel_ok = params.xpbd_backend, True
    elif params.dialect == "jacobi":
        backend, kernel_ok = params.jacobi_backend, local_to_world is None
    else:
        raise ValueError(f"unknown dialect {params.dialect!r}")
    kernel = _KERNEL_BACKEND[params.dialect]
    if backend == "pallas":
        return kernel, None
    if backend == "scatter" and params.dialect == "xpbd":
        return "gather", None
    if backend != "auto":
        return backend, None
    big = (topology.num_edges + topology.num_tets) >= SWEEP_MIN_CONSTRAINTS
    if not (big and kernel_ok and resolve_device(device).type == "cuda"):
        return "gather", None
    if params.dialect == "jacobi":
        try:
            return kernel, jacobi_plan.pass_tiles(topology, num_colliders)
        except jacobi_plan.TileFitError:
            return "gather", None
    return kernel, None
