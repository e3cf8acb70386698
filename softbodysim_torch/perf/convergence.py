"""Convergence quality: residual and energy curves per constraint ordering.

The XPBD dialect runs the reference's Gauss-Seidel (CProgram/src/Sim.cpp:
100-173) under several orderings, which change the iterate trajectories;
this module measures them (per-step RMS constraint residual per family and
total mechanical energy), as ``softbodysim_tpu/perf/convergence.py`` does:

  serial        -- the reference's own array order (tests/oracle.py);
  colored       -- colour-major sweeps, the port's coloured 'gather'
                   backend (``solver/xpbd.py``);
  blocks        -- block-synchronous (Jacobi within a 1024-constraint
                   super-block, Gauss-Seidel across blocks): the oracle's
                   replay of the sweep plans;
  blocks_pallas -- the same dialect on the port's CUDA sweep kernels
                   (``xpbd_backend="sweep"``; the JAX name is kept), one
                   step per record: the at-scale ordering;
  serial_golden -- the compiled reference binary (tests/golden_ref.py),
                   which needs a checkout of the reference.

The NumPy oracles are test infrastructure (tests/oracle.py), loaded by
path on use.
"""

from __future__ import annotations

import importlib.util
import pathlib
from typing import Dict

import numpy as np

F = np.float32


def constraint_residuals(topo, x: np.ndarray) -> Dict[str, float]:
    """RMS constraint violation per family at positions ``x``.

    edge: C = |len - rest|, normalized by RMS rest length;
    tet : C = |vol - rest|, normalized by RMS |rest volume|.
    """
    x = np.asarray(x, F)
    out = {}
    if topo.num_edges:
        e = topo.edges.astype(np.int64)
        d = x[e[:, 1]] - x[e[:, 0]]
        ln = np.sqrt((d * d).sum(-1))
        c = ln - topo.edge_rest
        out["edge"] = float(np.sqrt(np.mean(c * c))
                            / max(np.sqrt(np.mean(topo.edge_rest ** 2)),
                                  1e-12))
    if topo.num_tets:
        t = topo.tets.astype(np.int64)
        p = x[t]
        vol = np.einsum(
            "ti,ti->t",
            np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
            p[:, 3] - p[:, 0]) / 6.0
        c = vol - topo.tet_rest_vol
        out["tet"] = float(np.sqrt(np.mean(c * c))
                           / max(np.sqrt(np.mean(topo.tet_rest_vol ** 2)),
                                 1e-12))
    return out


def mechanical_energy(x, v, inv_mass, gravity=(0.0, -9.81, 0.0)) -> float:
    """Kinetic + gravitational potential energy of the free particles."""
    x = np.asarray(x, np.float64)
    v = np.asarray(v, np.float64)
    w = np.asarray(inv_mass, np.float64)
    m = np.where(w > 0.0, 1.0 / np.maximum(w, 1e-30), 0.0)
    g = np.asarray(gravity, np.float64)
    kin = 0.5 * float(np.sum(m * (v * v).sum(-1)))
    pot = -float(np.sum(m * (x @ g)))
    return kin + pot


def _load_test_module(name: str, fname: str):
    root = pathlib.Path(__file__).resolve().parents[2]
    spec = importlib.util.spec_from_file_location(name, root / "tests" / fname)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _oracle():
    return _load_test_module("softbodysim_oracle", "oracle.py")


def run_curves(topo, params, steps: int, dt: float = 1.0 / 60.0,
               orderings=("serial", "colored", "blocks"),
               pinned=None, *, device=None
               ) -> Dict[str, Dict[str, np.ndarray]]:
    """Run ``steps`` and record per-step curves per ordering:
    {ordering: {"edge": (steps,), "tet": (steps,), "energy": (steps,)}}.
    ``device``: where 'colored' and 'blocks_pallas' run (default: the
    card; "cpu" runs the kernels' plain versions); the other orderings
    are NumPy."""
    from ..core.state import init_state
    from ..solver import make_step

    curves: Dict[str, Dict[str, np.ndarray]] = {}
    for ordering in orderings:
        res_e, res_t, energy = [], [], []

        def record(x, v, w):
            r = constraint_residuals(topo, x)
            res_e.append(r.get("edge", 0.0))
            res_t.append(r.get("tet", 0.0))
            energy.append(mechanical_energy(x, v, w, params.gravity))

        if ordering == "serial":
            oracle = _oracle().XpbdOracle(topo, params, pinned=pinned)
            for _ in range(steps):
                oracle.step(dt)
                record(oracle.x, oracle.v, oracle.w)
        elif ordering == "blocks":
            oracle = _oracle().XpbdOracle(topo, params, pinned=pinned)
            eb, tb = block_plans(topo, params)
            sch = block_scheme(params)
            for _ in range(steps):
                oracle.step_blocks(dt, edge_blocks=eb, tet_blocks=tb, **sch)
                record(oracle.x, oracle.v, oracle.w)
        elif ordering in ("colored", "blocks_pallas"):
            backend = "gather" if ordering == "colored" else "sweep"
            state = init_state(topo, pinned=pinned, device=device)
            step = make_step(topo, params.replace(xpbd_backend=backend),
                             device=device)
            w = state.inv_mass.cpu().numpy()
            for _ in range(steps):
                state = step(state, dt)
                record(state.x.cpu().numpy(), state.v.cpu().numpy(), w)
        elif ordering == "serial_golden":
            gr = _load_test_module("softbodysim_golden_ref", "golden_ref.py")
            if not gr.reference_available():
                raise RuntimeError("reference checkout not available")
            out = gr.run_reference(topo, params, dt=dt, nsteps=steps,
                                   sample_every=1, pinned=pinned)
            w = _oracle().XpbdOracle(topo, params, pinned=pinned).w
            for x, v in zip(out["samples"], out["vel_samples"]):
                record(x, v, w)
        else:
            raise ValueError(f"unknown ordering {ordering!r}")

        curves[ordering] = {"edge": np.asarray(res_e),
                            "tet": np.asarray(res_t),
                            "energy": np.asarray(energy)}
    return curves


def block_scheme(params) -> dict:
    """The oracle-replay kwargs (scheme / omega / local_iters, each an
    (edge, tet) pair) of the sweep backend's in-block solve for
    ``params`` (``solver/xpbd_sweep.py::resolve_block_scheme``)."""
    from ..solver.xpbd_sweep import resolve_block_scheme

    fam = resolve_block_scheme(params)
    (se, oe, ke), (st, ot, kt) = fam["edge"], fam["tet"]
    return {"scheme": (se, st), "omega": (oe, ot), "local_iters": (ke, kt)}


def block_plans(topo, params):
    """The sweep backend's packed super-block order for ``topo`` as
    oracle-replayable [(constraint ids, scale)] block lists (edges, tets)."""
    from ..kernels import sweep_plan as sp
    from ..solver.xpbd_sweep import cached_plans

    _, _, _, e_plan, t_plan = cached_plans(topo, True)

    def blocks_of(plan):
        if plan is None:
            return None
        width = sp.block_width(plan)
        scale = plan.scale.reshape(-1)
        out = []
        for b in range(plan.capacity // width):
            seg = plan.perm[b * width:(b + 1) * width]
            live = seg >= 0
            if live.any():
                out.append((seg[live], scale[b * width:(b + 1) * width][live]
                            .astype(np.float32)))
        return out

    return blocks_of(e_plan), blocks_of(t_plan)
