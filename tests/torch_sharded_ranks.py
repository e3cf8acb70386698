"""The rank side of tests/test_torch_sharded.py: what each gloo process
runs.  Imports torch, numpy and softbodysim_torch only (the processes are
spawned, so they import this module by name and nothing of JAX).

``run_cases(rank, world, cases)`` runs every case of ``cases`` ({name:
(kind, args)}) on this rank's CPU and returns {name: result}, numpy
arrays and plain values."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DT = 1.0 / 60.0


def _mesh():
    from softbodysim_torch.parallel import make_mesh

    return make_mesh()


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


KINDS = {"stepped": _stepped, "engine": _engine, "raises": _raises}


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
    return {name: KINDS[kind](args) for name, (kind, args) in cases.items()}
