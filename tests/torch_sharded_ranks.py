"""The rank side of tests/test_torch_sharded.py and
tests/test_torch_sharded_modes.py: what each gloo process runs.  Imports
torch, numpy and softbodysim_torch only (the processes are spawned, so
they import this module by name and nothing of JAX).

``run_cases(rank, world, cases)`` runs every case of ``cases`` ({name:
(kind, args)}) on this rank's CPU and returns {name: result}, numpy
arrays and plain values.  The single-device references of a case run on
rank 0 only (they call no collective)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DT = 1.0 / 60.0


def _mesh(shape=None):
    from softbodysim_torch.parallel import make_mesh

    if shape is None:
        return make_mesh()
    return make_mesh(shape=shape, axis_names=("data", "model"))


def _topology(spec):
    import softbodysim_torch as sbt
    from softbodysim_torch.core.adjacency import combine_topologies

    kind, args = spec
    if kind == "cloth":
        return sbt.meshes.cloth_patch(*args)[0]
    if kind == "merged":
        return combine_topologies([getattr(sbt.meshes, k)(*a)
                                   for k, a in args])[0]
    return getattr(sbt.meshes, kind)(*args)


def _family_info(step, name):
    fam = step.shard_info.get(name)
    if fam is None:
        return None
    out = {"ghosts": [len(g) for g in fam.ghosts]}
    plans = step.shard_info.get("plans")
    if plans is not None:                      # the xpbd sweeps' packing
        gpu = plans[name]
        perm = np.full(gpu.num_blocks * gpu.width, -1, np.int64)
        perm[gpu.pos_of] = fam.owned
        out.update(scale=gpu.scale, cross=fam.cross, perm=perm)
    return out


def _stepped(args):
    """Build the sharded step of ``args`` and run it; positions after each
    step, the last state's fields, and the partition's maps."""
    from softbodysim_torch.core.state import SolverParams
    from softbodysim_torch.io.from_jax import (colliders_from_numpy,
                                               state_from_numpy,
                                               state_to_numpy)
    from softbodysim_torch.parallel import make_sharded_step

    topo = _topology(args["topology"])
    params = SolverParams(**args["params"])
    cols = (None if args.get("colliders") is None
            else colliders_from_numpy(args["colliders"], device="cpu"))
    step = make_sharded_step(topo, params, _mesh(), colliders=cols,
                             device="cpu")
    state = state_from_numpy(args["state"], device="cpu")
    xs = []
    for _ in range(args["steps"]):
        state = step(state, DT)
        xs.append(state.x.numpy().copy())
    return {"x": np.stack(xs), "state": state_to_numpy(state),
            "backend": step.backend,
            "edges": _family_info(step, "edges"),
            "tets": _family_info(step, "tets")}


def _engine(args):
    """Engine(mesh=...) beside the single-device Engine of the same
    arguments, both run ``steps`` steps on the CPU."""
    import softbodysim_torch as sbt
    from softbodysim_torch.core.state import SolverParams

    topo = _topology(args["topology"])
    params = SolverParams(**args["params"])
    cols = None
    if args.get("box"):
        cols = sbt.Colliders.build([sbt.Colliders.box(*args["box"])],
                                   device="cpu")
    a = sbt.Engine(topo, params, colliders=cols, mesh=_mesh(), device="cpu")
    b = sbt.Engine(topo, params, colliders=cols, device="cpu")
    a.run(args["steps"], DT)
    b.run(args["steps"], DT)
    return {"sharded": a.positions(), "single": b.positions(),
            "sharded_lam": a.state.edge_lambda.numpy(),
            "single_lam": b.state.edge_lambda.numpy(),
            "backends": (a.backend, b.backend)}


def _raises(args):
    """The exception a sharded Engine build raises (its type's name and
    message), or None."""
    import softbodysim_torch as sbt
    from softbodysim_torch.core.state import SolverParams

    try:
        sbt.Engine(_topology(args["topology"]),
                   SolverParams(**args["params"]), mesh=_mesh(),
                   device="cpu")
    except Exception as e:                       # noqa: BLE001
        return type(e).__name__, str(e)
    return None


def _params(args, **kw):
    from softbodysim_torch.core.state import SolverParams

    return SolverParams(**{**args["params"], **kw})


def _cols(args):
    from softbodysim_torch.io.from_jax import colliders_from_numpy

    return (None if args.get("colliders") is None
            else colliders_from_numpy(args["colliders"], device="cpu"))


def _batch(state, b: int):
    from softbodysim_torch.core.state import SimState

    return SimState(**{f: getattr(state, f).unsqueeze(0).repeat(
        (b,) + (1,) * getattr(state, f).dim())
        for f in ("x", "v", "x_star", "inv_mass", "edge_lambda",
                  "tet_lambda")})


DIST_CALLS = ("all_gather", "all_reduce", "all_to_all", "broadcast",
              "reduce_scatter", "batch_isend_irecv", "send", "recv",
              "isend", "irecv", "barrier", "all_gather_into_tensor")


def _counted(fn):
    """``fn()`` with every ``torch.distributed`` collective counted:
    (its result, the count)."""
    import torch.distributed as dist

    calls, saved = [], {n: getattr(dist, n) for n in DIST_CALLS}
    for n, f in saved.items():
        setattr(dist, n, lambda *a, _f=f, **k: (calls.append(1),
                                                 _f(*a, **k))[1])
    try:
        return fn(), len(calls)
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


def _data_parallel(args, rank):
    """make_data_parallel_step over a 1-D "data" mesh of every rank, from
    ``batch`` copies of init_state, against the batched step (rank 0)."""
    from softbodysim_torch.core.state import init_state
    from softbodysim_torch.parallel import (gather_batch, make_batched_step,
                                            make_data_parallel_step,
                                            make_mesh, shard_batch)

    topo, params = _topology(args["topology"]), _params(args)
    mesh = make_mesh(axis_names=("data",))
    mode = "tet" if params.dialect == "xpbd" else "density"
    full = _batch(init_state(topo, inv_mass_mode=mode, device="cpu"),
                  args["batch"])
    step = make_data_parallel_step(topo, params, mesh, device="cpu")
    block = shard_batch(full, mesh)

    def run():
        st = block
        for _ in range(args["steps"]):
            st = step(st, DT)
        return st

    block, calls = _counted(run)
    out = {"x": gather_batch(block, mesh).x.numpy(), "calls": calls,
           "block": int(block.x.shape[0])}
    try:
        shard_batch(_batch(init_state(topo, device="cpu"),
                           args["batch"] + 1), mesh)
        out["uneven"] = ""
    except ValueError as e:
        out["uneven"] = str(e)
    if rank == 0:
        ref, st = make_batched_step(topo, params, device="cpu"), full
        for _ in range(args["steps"]):
            st = ref(st, DT)
        out["ref"] = st.x.numpy()
    return out


def _constraint(args, rank):
    """make_mesh_sharded_step / make_xpbd_sharded_step on a (data, model)
    mesh of ``shape`` from the batched ``state`` arrays: the whole batch
    after ``steps`` steps (gathered), against the single-device step on
    each scene (rank 0)."""
    from softbodysim_torch import Engine
    from softbodysim_torch.core.state import SimState
    from softbodysim_torch.io.from_jax import batched_state_from_numpy
    from softbodysim_torch.parallel import (gather_batch,
                                            make_mesh_sharded_step,
                                            make_xpbd_sharded_step,
                                            shard_batch)

    topo, params = _topology(args["topology"]), _params(args)
    mesh = _mesh(args["shape"])
    full = batched_state_from_numpy(args["state"],
                                    len(args["state"]["x"]), device="cpu")
    make = (make_xpbd_sharded_step if params.dialect == "xpbd"
            else make_mesh_sharded_step)
    step = make(topo, params, mesh, device="cpu")
    block = shard_batch(full, mesh)
    for _ in range(args["steps"]):
        block = step(block, DT)
    out = {f: getattr(gather_batch(block, mesh), f).numpy()
           for f in ("x", "edge_lambda", "tet_lambda")}
    out["block"] = int(block.x.shape[0])
    if rank == 0:
        refs = []
        for b in range(full.x.shape[0]):
            ref = Engine(topo, params, device="cpu")
            ref.state = SimState(**{f: getattr(full, f)[b]
                                    for f in _FIELDS})
            ref.run(args["steps"], DT)
            refs.append(ref.state)
        for f in ("x", "edge_lambda", "tet_lambda"):
            out["ref_" + f] = np.stack([getattr(r, f).numpy()
                                        for r in refs])
    return out


def _vertex(args, rank):
    """A vertex-sharded step (jacobi: make_vertex_sharded_step with
    ``halo``; xpbd: make_xpbd_vertex_sharded_step) from ``state`` arrays,
    against the single-device Engine from the same state (rank 0): the
    public positions after each step, the last lambdas, and the halo's
    attributes."""
    from softbodysim_torch import Engine
    from softbodysim_torch.io.from_jax import state_from_numpy
    from softbodysim_torch.parallel import (make_mesh,
                                            make_vertex_sharded_step,
                                            make_xpbd_vertex_sharded_step)

    topo, params, cols = (_topology(args["topology"]), _params(args),
                          _cols(args))
    s0 = state_from_numpy(args["state"], device="cpu")
    mesh = make_mesh()
    xs = []
    if params.dialect == "jacobi":
        step = make_vertex_sharded_step(topo, params, mesh,
                                        halo=args.get("halo", "auto"),
                                        colliders=cols, device="cpu")
        st = (step.own(s0.x), step.own(s0.v), step.own(s0.inv_mass))
        for _ in range(args["steps"]):
            st = step(st, DT)
            xs.append(step.unpad(st[0]))
        out = {"halo_mode": step.halo_mode, "vpad": step.vpad,
               "comm": (step.comm_bytes_per_sweep,
                        step.comm_bytes_full_gather)}
        lam = None
    else:
        step = make_xpbd_vertex_sharded_step(topo, params, mesh,
                                             colliders=cols, device="cpu")
        st = s0
        for _ in range(args["steps"]):
            st = step(st, DT)
            xs.append(st.x.numpy().copy())
        out = {"halo_mode": step.halo_mode,
               "comm": (step.comm_bytes_per_color, step.full_gather_bytes)}
        lam = st
    out["x"] = np.stack(xs)
    if lam is not None:
        out.update(edge_lambda=lam.edge_lambda.numpy(),
                   tet_lambda=lam.tet_lambda.numpy())
    if rank == 0:
        ref = Engine(topo, params, colliders=cols, device="cpu")
        ref.state = s0
        ref.run(args["steps"], DT)
        out.update(ref=ref.positions(),
                   ref_edge_lambda=ref.state.edge_lambda.numpy(),
                   ref_tet_lambda=ref.state.tet_lambda.numpy())
        if cols is not None or params.self_collision \
                or params.surface_collision:
            # the same run without the colliders and the contact stages
            plain = Engine(topo, params.replace(
                self_collision=False, surface_collision=False),
                device="cpu")
            plain.state = s0
            plain.run(args["steps"], DT)
            out["ref_plain"] = plain.positions()
    return out


def _halo_sizes(args, rank):
    """A vertex-sharded step's halo attributes, built only."""
    from softbodysim_torch.parallel import (make_mesh,
                                            make_vertex_sharded_step,
                                            make_xpbd_vertex_sharded_step)

    topo, params = _topology(args["topology"]), _params(args)
    if params.dialect == "jacobi":
        step = make_vertex_sharded_step(topo, params, make_mesh(),
                                        halo=args.get("halo", "auto"),
                                        device="cpu")
        return {"halo_mode": step.halo_mode,
                "comm": (step.comm_bytes_per_sweep,
                         step.comm_bytes_full_gather)}
    step = make_xpbd_vertex_sharded_step(topo, params, make_mesh(),
                                         device="cpu")
    return {"halo_mode": step.halo_mode,
            "comm": (step.comm_bytes_per_color, step.full_gather_bytes)}


def _grads(args, rank):
    """d sum(x_final^2) / d x0 over ``steps`` steps of the mesh-sharded
    jacobi step (one scene on a (1, world) mesh) and of make_sharded_step's
    vertex-sharded jacobi step; d sum(traj^2) / d x0 of make_rollout(mesh=)
    for xpbd (the custom backward); d loss / d overrides of the jacobi
    mesh rollout; each beside the single-device gradient (rank 0)."""
    import dataclasses as dc

    from softbodysim_torch import diff
    from softbodysim_torch.core.state import SimState, init_state
    from softbodysim_torch.io.from_jax import state_from_numpy
    from softbodysim_torch.parallel import (make_mesh,
                                            make_mesh_sharded_step,
                                            make_sharded_step)
    from softbodysim_torch.solver import make_step

    topo, params = _topology(args["topology"]), _params(args)
    world = torch.distributed.get_world_size()
    mesh = _mesh((1, world))
    s0 = init_state(topo, device="cpu")
    n = args["steps"]

    def final_sq(step_fn):
        x0 = s0.x.clone().requires_grad_(True)
        st = dc.replace(s0, x=x0, x_star=x0)
        for _ in range(n):
            st = step_fn(st, DT)
        return torch.autograd.grad((st.x * st.x).sum(), x0)[0].numpy()

    msh = make_mesh_sharded_step(topo, params, mesh, device="cpu")

    def one(st, dt):
        b = SimState(**{f: getattr(st, f)[None] for f in _FIELDS})
        o = msh(b, dt)
        return SimState(**{f: getattr(o, f)[0] for f in _FIELDS})

    out = {"mesh": final_sq(one),
           "vertex": final_sq(make_sharded_step(topo, params, make_mesh(),
                                                device="cpu"))}
    # the material overrides through the jacobi mesh rollout, from a
    # seeded velocity field (the rest state does no constraint work)
    kick = state_from_numpy(args["kicked"], device="cpu")
    ks = {k: torch.tensor(v, requires_grad=True)
          for k, v in args["overrides"].items()}
    roll = diff.make_rollout(topo, params, dt=DT, nsteps=n, mesh=mesh,
                             remat=False, device="cpu")
    out["overrides"] = [float(g) for g in torch.autograd.grad(
        roll(_batch(kick, 1), ks).square().sum(), list(ks.values()))]
    xp = _params(args["xpbd"])
    xroll = diff.make_rollout(topo, xp, dt=DT, nsteps=args["xpbd_steps"],
                              mesh=mesh, remat=False, device="cpu")
    x0 = s0.x.clone().requires_grad_(True)
    b0 = dc.replace(_batch(s0, 1), x=x0[None], x_star=x0[None])
    out["xpbd"] = torch.autograd.grad(xroll(b0).square().sum(),
                                      x0)[0].numpy()
    if rank == 0:
        out["ref"] = final_sq(make_step(topo, params, device="cpu"))
        sroll = diff.make_rollout(topo, params, dt=DT, nsteps=n,
                                  remat=False, device="cpu")
        ks = {k: torch.tensor(v, requires_grad=True)
              for k, v in args["overrides"].items()}
        out["ref_overrides"] = [float(g) for g in torch.autograd.grad(
            sroll(kick, ks).square().sum(), list(ks.values()))]
        sroll = diff.make_rollout(topo, xp, dt=DT,
                                  nsteps=args["xpbd_steps"], remat=False,
                                  device="cpu")
        x0 = s0.x.clone().requires_grad_(True)
        out["ref_xpbd"] = torch.autograd.grad(sroll(dc.replace(
            s0, x=x0, x_star=x0)).square().sum(), x0)[0].numpy()
    return out


def _fit(args, rank):
    """diff.fit(mesh=...) on a ("data", "model") mesh of (world, 1): a
    hanging cube's edge stiffness from its batched trajectory."""
    from softbodysim_torch import diff
    from softbodysim_torch.core.state import init_state

    world = torch.distributed.get_world_size()
    mesh = _mesh((world, 1))
    topo, true = _topology(args["topology"]), _params(args)
    top = np.where(topo.vertices[:, 1]
                   >= topo.vertices[:, 1].max() - 1e-6)[0]
    s0 = _batch(init_state(topo, pinned=top, inv_mass_mode="density",
                           device="cpu"), world)
    target = diff.make_rollout(topo, true, dt=DT, nsteps=args["nsteps"],
                               mesh=mesh, device="cpu")(s0)
    res = diff.fit(topo, true.replace(edge_stiffness=args["start"]), target,
                   dt=DT, fit_params=("edge_stiffness",), state0=s0,
                   steps=args["steps"], learning_rate=args["lr"],
                   remat=False, mesh=mesh, device="cpu")
    return {"params": res.params, "losses": res.losses,
            "target": target.numpy()}


_FIELDS = ("x", "v", "x_star", "inv_mass", "edge_lambda", "tet_lambda")

KINDS = {"stepped": _stepped, "engine": _engine, "raises": _raises}
RANK_KINDS = {"data_parallel": _data_parallel, "constraint": _constraint,
              "vertex": _vertex, "halo_sizes": _halo_sizes, "grads": _grads,
              "fit": _fit}


def kicked(eng, seed: int, sigma: float):
    """``eng``'s state with velocities N(0, sigma) m/s drawn from
    ``seed``."""
    s = eng.state
    v = np.random.default_rng(seed).normal(0.0, sigma, tuple(s.v.shape))
    return dataclasses.replace(s, v=torch.from_numpy(
        v.astype(np.float32)).to(s.v.device))


def ballistic(s0, params, steps: int) -> np.ndarray:
    """Positions (float64) after ``steps`` steps from ``s0`` with no
    constraint and no contact (each substep v += g sdt, x += v sdt;
    pinned rows stay): the move the constraints correct."""
    ss = max(1, params.substeps)
    n, sdt = steps * ss, DT / ss
    x0 = s0.x.double().cpu().numpy()
    xb = (x0 + (n * sdt) * s0.v.double().cpu().numpy()
          + np.asarray(params.gravity) * (sdt * sdt * n * (n + 1) / 2))
    return np.where((s0.inv_mass.cpu().numpy() != 0.0)[:, None], xb, x0)


def halo_vertices(step, num_particles: int) -> np.ndarray:
    """The public vertices of every window some rank holds as a ghost."""
    wins = np.unique(np.concatenate(
        [np.concatenate(f.fam.ghosts) for f in step.fams.values()]))
    rows = (wins[:, None] * 128 + np.arange(128)).reshape(-1)
    vid = step.part.perm_layout[rows.astype(np.int64)]
    return vid[vid < num_particles]


def run_cuda_engine(rank, world, topology, params, steps, seed, sigma):
    """A sharded Engine on the card (every rank on cuda:0, the group's
    collectives staged through host memory), started with ``kicked``
    velocities: its positions after ``steps`` steps and the vertices of
    the ghost windows."""
    import softbodysim_torch as sbt
    from softbodysim_torch.core.state import SolverParams
    from softbodysim_torch.parallel import make_mesh

    topo = _topology(topology)
    eng = sbt.Engine(topo, SolverParams(**params),
                     mesh=make_mesh(device_type="cuda"), device="cuda:0")
    eng.state = kicked(eng, seed, sigma)
    eng.run(steps, DT)
    return {"x": eng.positions(),
            "halo": halo_vertices(eng._raw_step, topo.num_particles)}


def run_cases(rank, world, cases):
    torch.set_num_threads(1)
    return {name: (RANK_KINDS[kind](args, rank) if kind in RANK_KINDS
                   else KINDS[kind](args))
            for name, (kind, args) in cases.items()}


def run_cases_yielding(rank, world, cases):
    """``run_cases`` at a lower CPU priority, so that the tests other
    workers run beside these ranks keep their share of the host."""
    import os

    os.nice(5)
    return run_cases(rank, world, cases)


def run_timed(rank, world, cases):
    """``run_cases`` with each case's seconds beside its result."""
    import time

    torch.set_num_threads(1)
    out = {}
    for name, (kind, args) in cases.items():
        t0 = time.perf_counter()
        fn = RANK_KINDS.get(kind)
        out[name] = (fn(args, rank) if fn else KINDS[kind](args),
                     time.perf_counter() - t0)
    return out
