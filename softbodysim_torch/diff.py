"""Differentiable simulation: ``torch.autograd`` through the solver.

The counterpart of ``softbodysim_tpu/diff.py``: an N-step rollout of the
plain steps (the coloured xpbd step's autograd build,
``make_step(..., differentiable=True)``; the jacobi 'segment' / 'gather'
steps as built) is reverse-differentiable end to end, w.r.t. the initial
state and the material overrides the step takes.  Use cases:

- **Material estimation / system identification**: recover
  compliance / stiffness from an observed trajectory (``fit``).
- **Initial-condition optimisation**: differentiate ``make_rollout``
  w.r.t. the initial state.
- **Scene tuning**: gradients w.r.t. any override the step exposes
  (per-dialect material scalars, SOR omega, the xpbd gravity).

Backends: the plain tensor steps differentiate (xpbd 'gather' /
'scatter', the coloured Gauss-Seidel step; jacobi 'segment' / 'gather').
The kernel backends ('sweep', 'pass') write their tables in place through
CUDA kernels that define no gradient and raise when handed a tensor that
requires grad, so ``make_rollout`` forces a plain backend
(``differentiable_params``), as the JAX function does.  Unlike the JAX
function it keeps ``use_pallas``: the port's collide kernel has a
gradient (``kernels/collide.py::collide_positions``: the kernel
forward, ``collide_plain``'s vector-Jacobian product backward), so the
collide stage runs on the card's kernel here too.

Memory: reverse mode through N steps keeps O(N * state) residuals.  Each
step is wrapped in ``torch.utils.checkpoint`` (recomputed in the backward
pass, as the JAX function's ``jax.checkpoint``) by default; pass
``remat=False`` for short rollouts whose residuals fit anyway.

``mesh=`` distributes a scene-batched rollout over the ranks of a
``torch.distributed`` mesh (``make_rollout``): every rank computes the
same loss and the same gradient, so an optimizer stepping on each rank
keeps the ranks' parameters equal.

Entry points run on ``device`` (default: the card, ``cuda:0``; the CPU
when asked for).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .core.state import SimState, SolverParams, init_state, resolve_device
from .solver import make_step

# The material overrides each dialect's step accepts (solver/xpbd.py,
# solver/jacobi.py): the fittable parameter surface.  "gravity_override"
# (xpbd, a (3,) vector) is accepted by make_rollout but not by fit(),
# whose scalar log-space machinery does not apply to signed vectors.
FITTABLE: Dict[str, Tuple[str, ...]] = {
    "xpbd": ("edge_compliance", "volume_compliance", "friction"),
    "jacobi": ("edge_stiffness", "volume_stiffness", "sor_omega"),
}
_ROLLOUT_ONLY: Dict[str, Tuple[str, ...]] = {
    "xpbd": ("gravity_override",),
    "jacobi": (),
}


def differentiable_params(params: SolverParams) -> SolverParams:
    """``params`` with a kernel backend replaced by its differentiable
    plain twin: 'scatter' (xpbd) / 'segment' (jacobi) unless the caller
    picked another plain backend ('gather'), as the JAX function does.
    The physics is the same for the jacobi dialect and, for xpbd, the same
    up to constraint order (coloured Gauss-Seidel instead of the block
    order of the sweeps).

    ``use_pallas`` stays as given, where the JAX function sets it to
    'off': its Pallas collide kernel has no VJP, the port's collide kernel
    has a gradient (module docstring)."""
    kw = {}
    if params.dialect == "xpbd" and params.xpbd_backend not in (
            "gather", "scatter"):
        kw["xpbd_backend"] = "scatter"
    if params.dialect == "jacobi" and params.jacobi_backend not in (
            "gather", "segment"):
        kw["jacobi_backend"] = "segment"
    return params.replace(**kw) if kw else params


def make_rollout(topology, params: SolverParams, *, dt: float, nsteps: int,
                 colliders=None, remat: bool = True, mesh=None,
                 data_axis: str = "data", model_axis: str = "model",
                 device=None):
    """Build ``rollout(state0, overrides=None) -> (nsteps, V, 3)``: the
    position trajectory of ``nsteps`` solver steps on ``device``,
    differentiable w.r.t. the ``state0`` tensors and the ``overrides``
    dict (keys from ``FITTABLE[params.dialect]``, and ``gravity_override``
    for xpbd; values floats or tensors).

    ``mesh`` (``parallel.make_mesh`` with dimensions ``data_axis`` and
    ``model_axis``): the distributed rollout, on every rank of the mesh
    with the same arguments.  ``state0`` is a batch of B scenes (every
    field with a leading scene axis), the same on every rank; each rank
    steps its block of B / d scenes (``parallel.shard_batch``) and the
    trajectory comes back whole, (nsteps, B, V, 3), the same on every rank
    (gathered over ``data_axis``), and so do the gradients.  The jacobi
    step is ``parallel.make_mesh_sharded_step`` (its material overrides
    may be tensors); the xpbd step is ``make_xpbd_sharded_step`` forward
    with the single-device coloured build's vector-Jacobian product as its
    backward (``_ShardedXpbdStep``), and takes no override."""
    p = differentiable_params(params)
    allowed = FITTABLE[p.dialect] + _ROLLOUT_ONLY[p.dialect]
    data = None
    if mesh is not None:
        from .parallel.collectives import Axis
        from .parallel.sharding import make_mesh_sharded_step, shard_batch

        data = Axis(mesh, data_axis)
        if p.dialect == "jacobi":
            allowed = FITTABLE["jacobi"]
            step = make_mesh_sharded_step(topology, p, mesh, colliders,
                                          data_axis, model_axis,
                                          device=device)
        else:
            allowed = ()
            step = _sharded_xpbd(topology, p, mesh, colliders, data_axis,
                                 model_axis, dt, device)
    else:
        # the jacobi plain steps differentiate as built; the coloured xpbd
        # step has a build of its own for autograd (no CUDA graph)
        kw = {"differentiable": True} if p.dialect == "xpbd" else {}
        step = make_step(topology, p, colliders=colliders, device=device,
                         **kw)

    def one(state: SimState, overrides) -> SimState:
        return step(state, dt, **overrides)

    def one_ck(state: SimState, overrides) -> SimState:
        # the step draws no random numbers: no RNG state to replay
        return checkpoint(one, state, overrides, use_reentrant=False,
                          preserve_rng_state=False)

    run = one_ck if remat else one

    def rollout(state0: SimState, overrides=None) -> torch.Tensor:
        ov = dict(overrides or {})
        bad = set(ov) - set(allowed)
        if bad:
            raise ValueError(
                f"overrides {sorted(bad)} not fittable for dialect "
                f"{p.dialect!r}; allowed: {allowed}")
        st = state0
        if data is not None:
            # each data rank steps its own scenes: a replicated override's
            # gradient sums the data ranks' shares
            st = shard_batch(state0, mesh, data_axis)
            ov = {k: data.varying(v) for k, v in ov.items()}
        xs = []
        for _ in range(int(nsteps)):
            st = run(st, ov)
            xs.append(st.x)
        traj = torch.stack(xs)
        if data is not None:
            traj = data.all_gather(traj, tiled=True, dim=1)
        return traj

    rollout.step = step
    return rollout


class _ShardedXpbdStep(torch.autograd.Function):
    """One step of the constraint-sharded xpbd step (``parallel.
    make_xpbd_sharded_step``) forward, the vector-Jacobian product of the
    single-device coloured build (``make_step(..., differentiable=True)``)
    backward, recomputed per scene from the saved input state under
    ``torch.enable_grad()`` (the JAX package's ``_sharded_xpbd_custom_vjp``,
    ``softbodysim_tpu/diff.py:151-189``): both compute the same function,
    and the sharded step's own reverse graph is never built.  Inputs and
    outputs: this rank's block (x, v, inv_mass, edge_lambda, tet_lambda);
    every model rank computes the whole backward of its block, so no
    cotangent is summed."""

    @staticmethod
    def forward(ctx, fns, x, v, w, el, tl):
        sharded, _, dt = fns
        ctx.fns = fns
        ctx.save_for_backward(x, v, w, el, tl)
        with torch.no_grad():
            out = sharded(SimState(x=x, v=v, x_star=x, inv_mass=w,
                                   edge_lambda=el, tet_lambda=tl), dt)
        # a family the topology lacks comes back as the input: a copy
        return (out.x, out.v, out.edge_lambda.clone(),
                out.tet_lambda.clone())

    @staticmethod
    def backward(ctx, gx, gv, gel, gtl):
        _, single, dt = ctx.fns
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            x, v, w, el, tl = ins
            outs = [single(SimState(x=x[s], v=v[s], x_star=x[s],
                                    inv_mass=w[s], edge_lambda=el[s],
                                    tet_lambda=tl[s]), dt)
                    for s in range(x.shape[0])]
            ys = [torch.stack([getattr(o, f) for o in outs])
                  for f in ("x", "v", "edge_lambda", "tet_lambda")]
            want = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(
                ys, want, [gx, gv, gel, gtl], allow_unused=True))
        return (None, *(next(got) if n else None for n in need))


def _sharded_xpbd(topology, p: SolverParams, mesh, colliders, data_axis,
                  model_axis, dt, device):
    """The xpbd mesh step of ``make_rollout``: ``_ShardedXpbdStep`` over
    this rank's block of scenes."""
    from .parallel.sharding import make_xpbd_sharded_step

    sharded = make_xpbd_sharded_step(topology, p, mesh, colliders,
                                     data_axis, model_axis, device=device)
    single = make_step(topology, p.replace(xpbd_backend="scatter"),
                       colliders=colliders, device=device,
                       differentiable=True)
    fns = (sharded, single, dt)

    def step(state: SimState, _dt) -> SimState:
        x, v, el, tl = _ShardedXpbdStep.apply(
            fns, state.x, state.v, state.inv_mass, state.edge_lambda,
            state.tet_lambda)
        return SimState(x=x, v=v, x_star=x, inv_mass=state.inv_mass,
                        edge_lambda=el, tet_lambda=tl)

    step.sharded = sharded
    return step


def make_trajectory_loss(topology, params: SolverParams, target, *,
                         dt: float, state0: Optional[SimState] = None,
                         pinned=None, colliders=None, remat: bool = True,
                         observed=None, mesh=None, device=None):
    """Build ``loss(overrides) -> scalar``: the mean squared position error
    of a rollout against ``target`` on ``device``.  Differentiable; feed it
    to ``torch.autograd.grad`` or an optimizer (``fit`` does).

    ``observed``: optional (K,) vertex ids (markers, or the surface): then
    ``target`` is (nsteps, K, 3) and the loss compares only those rows."""
    dev = resolve_device(device)
    target = (target.detach().to(dev, torch.float32)
              if isinstance(target, torch.Tensor)
              else torch.from_numpy(np.array(target, np.float32)).to(dev))
    if observed is not None:
        obs_np = np.unique(np.asarray(observed, np.int64).reshape(-1))
        if len(obs_np) and (obs_np[0] < 0
                            or obs_np[-1] >= topology.num_particles):
            raise ValueError(
                f"observed ids must be in [0, {topology.num_particles}); "
                f"got range [{obs_np[0]}, {obs_np[-1]}]")
        observed = torch.as_tensor(obs_np).to(dev)
        want = (int(observed.shape[0]), 3)
    else:
        want = (topology.num_particles, 3)
    if mesh is not None:
        # sharded rollouts are scene-batched: target (nsteps, B, V|K, 3)
        if target.dim() != 4 or tuple(target.shape[2:]) != want:
            raise ValueError(
                f"sharded target must be (nsteps, B, {want[0]}, 3), "
                f"got {tuple(target.shape)}")
        if state0 is None:
            raise ValueError("sharded loss needs an explicit batched "
                             "state0 (shard it over the data axis)")
    elif target.dim() != 3 or tuple(target.shape[1:]) != want:
        raise ValueError(
            f"target must be (nsteps, {want[0]}, 3), got "
            f"{tuple(target.shape)}")
    rollout = make_rollout(topology, params, dt=dt,
                           nsteps=int(target.shape[0]), colliders=colliders,
                           remat=remat, mesh=mesh, device=dev)
    if state0 is None:
        state0 = init_state(topology, pinned=pinned, device=dev)

    def loss(overrides) -> torch.Tensor:
        traj = rollout(state0, overrides)
        if observed is not None:
            traj = (traj[:, :, observed] if mesh is not None
                    else traj[:, observed])
        return torch.mean(torch.square(traj - target))

    return loss


class FitResult(NamedTuple):
    params: Dict[str, float]     # fitted values, physical space
    losses: np.ndarray           # loss before each update + final loss
    converged: bool              # final loss <= tol * initial loss


def fit(topology, params: SolverParams, target, *, dt: float,
        fit_params: Sequence[str] = ("edge_compliance",),
        init: Optional[Dict[str, float]] = None,
        state0: Optional[SimState] = None, pinned=None, colliders=None,
        steps: int = 100, learning_rate: float = 0.2, optimizer=None,
        log_space: bool = True, remat: bool = True,
        tol: float = 1e-2, observed=None, mesh=None,
        device=None) -> FitResult:
    """Recover material parameters from an observed trajectory.

    Minimises the mean squared position error of an ``nsteps``-long
    rollout against ``target`` -- (nsteps, V, 3), or (nsteps, K, 3) with
    ``observed`` (K,) vertex ids -- over the named ``fit_params`` (a subset
    of ``FITTABLE[params.dialect]``), from ``init`` (default: the values
    in ``params``).  ``log_space=True`` optimises log(p): positivity is
    structural and the step size scale-free.

    Optimizer: Adam (betas 0.9, 0.999, eps 1e-8) at ``learning_rate``
    decayed exponentially to 1/20 of it over the run, counted from 0 --
    the JAX function's ``optax.adam(optax.exponential_decay(lr, steps,
    0.05))``; or ``optimizer``, a callable ``params -> torch.optim.
    Optimizer`` over the list of parameter tensors (no schedule then).
    The loss is normalised by the first loss (trajectory MSE can be ~1e-10,
    where Adam's eps would swamp sqrt(v)); the returned curve is in raw
    units: the loss before each update, then the final loss."""
    names = tuple(fit_params)
    allowed = FITTABLE[params.dialect]
    bad = set(names) - set(allowed)
    if bad:
        raise ValueError(f"fit_params {sorted(bad)} not fittable for "
                         f"dialect {params.dialect!r}; allowed: {allowed}")
    dev = resolve_device(device)
    loss_of_ov = make_trajectory_loss(
        topology, params, target, dt=dt, state0=state0, pinned=pinned,
        colliders=colliders, remat=remat, observed=observed, mesh=mesh,
        device=dev)

    start = {n: float((init or {}).get(n, getattr(params, n)))
             for n in names}
    theta = {n: torch.tensor(math.log(max(v, 1e-12)) if log_space else v,
                             dtype=torch.float32, device=dev,
                             requires_grad=True)
             for n, v in start.items()}

    def to_physical():
        return {n: torch.exp(t) if log_space else t
                for n, t in theta.items()}

    if optimizer is not None:
        opt, sched = optimizer(list(theta.values())), None
    else:
        opt = torch.optim.Adam(list(theta.values()), lr=learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda t: 0.05 ** (t / steps) if steps > 0 else 1.0)

    with torch.no_grad():
        loss0 = float(loss_of_ov(to_physical()))
    inv_scale = 1.0 / max(loss0, 1e-30)

    losses = []
    for _ in range(int(steps)):
        opt.zero_grad(set_to_none=True)
        val = loss_of_ov(to_physical()) * inv_scale
        val.backward()
        opt.step()
        if sched is not None:
            sched.step()
        losses.append(float(val.detach()) * loss0)
    # the loss before each update is what the loop records: evaluate the
    # final parameters once more, so losses[-1] and `converged` describe
    # the parameters returned
    with torch.no_grad():
        losses.append(float(loss_of_ov(to_physical())))
        fitted = {n: float(v) for n, v in to_physical().items()}
    losses_np = np.asarray(losses, np.float64)
    converged = bool(losses_np[-1] <= tol * max(losses_np[0], 1e-30))
    return FitResult(params=fitted, losses=losses_np, converged=converged)
