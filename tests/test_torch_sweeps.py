"""One edge sweep and one tet sweep of the port against the JAX Pallas
sweep in interpret mode and against the NumPy oracle's block solves
(tet_cube(7), both block schemes).  The CUDA kernels are held against
these plain versions on the card in test_torch_kernels.py.

Tolerance: positions 1e-5 absolute; lambdas 1e-5 relative to the largest
|lambda| (they are ~1e-7 here).  The three implementations sum a vertex's
corrections in different orders (ULP-level drift), nothing more.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysim_tpu.kernels import sweep as jsw

from softbodysim_torch import SolverParams
from softbodysim_torch.core import meshes as tmeshes
from softbodysim_torch.core.state import init_state
from softbodysim_torch.kernels import sweep as ksw
from softbodysim_torch.kernels import sweep_plan as tsp

from oracle import XpbdOracle

SDT = np.float32(1.0 / 60.0) / np.float32(2)
COMPLIANCE = 5e-4
# family -> (scheme, omega, local_iters): the tuned split defaults, the
# legacy scale scheme, and split with one in-block revisit (the JAX
# interpret-mode comparison skips the last: its compile time doubles)
SCHEMES = {
    "split": {"edges": ("split", 1.5, 1), "tets": ("split", 2.2, 1)},
    "scale": {"edges": ("scale", 1.0, 1), "tets": ("scale", 1.0, 1)},
    "split_k2": {"edges": ("split", 1.5, 2), "tets": ("split", 2.2, 2)},
}


@functools.lru_cache(maxsize=None)
def _scene():
    """tet_cube(7) in natural layout, a perturbed predicted state with
    two pinned vertices, and nonzero starting lambdas (public order)."""
    topo = tmeshes.tet_cube(7, 7, 7, size=1.0, center=(0.0, 0.8, 0.0))
    V = topo.num_particles
    rng = np.random.default_rng(0)
    x = (topo.vertices + rng.normal(0.0, 0.01, (V, 3))).astype(np.float32)
    w = init_state(topo, device="cpu").inv_mass.numpy().copy()
    w[[0, 17]] = 0.0
    lam = {"edges": rng.normal(0.0, 1e-8, topo.num_edges).astype(np.float32),
           "tets": rng.normal(0.0, 1e-8, topo.num_tets).astype(np.float32)}
    return topo, x, w, lam


def _family(topo, family):
    if family == "edges":
        return topo.edges.astype(np.int64), topo.edge_rest, 2
    return topo.tets.astype(np.int64), topo.tet_rest_vol, 3


def _port_sweep(family, scheme):
    topo, x, w, lam = _scene()
    cons, rest, lcap = _family(topo, family)
    sch, omega, k = SCHEMES[scheme][family]
    nwin = -(-topo.num_particles // tsp.LANES)
    plan = tsp.pack_superblocks(cons, rest, layer_cap=lcap)
    g = tsp.build_gpu_plan(plan, cons, scheme=sch, omega=omega)
    dplan = ksw.to_device(g, "cpu")
    xw = torch.zeros((nwin * tsp.LANES, 4))
    xw[:len(x), :3] = torch.from_numpy(x)
    xw[:len(x), 3] = torch.from_numpy(w)
    lam_p = torch.zeros(g.num_blocks * tsp.BLOCK)
    lam_p[torch.from_numpy(g.pos_of)] = torch.from_numpy(lam[family])
    alpha = float(np.float32(COMPLIANCE) * (np.float32(1.0) / (SDT * SDT))) \
        if family == "edges" else 0.0
    wtab = ksw.w_fill(dplan, xw)
    fn = ksw.edge_sweep if family == "edges" else ksw.tet_sweep
    fn(dplan, xw, lam_p, wtab, alpha, k)
    return (xw[:len(x), :3].numpy(), lam_p[torch.from_numpy(g.pos_of)].numpy(),
            plan, alpha)


def _check(x, lam, x_ref, lam_ref):
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lam, lam_ref, rtol=0,
                               atol=1e-5 * np.abs(lam_ref).max())


@pytest.mark.parametrize("scheme", ["split", "scale"])
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_plain_sweep_matches_jax_interpret(family, scheme):
    topo, x, w, lam = _scene()
    cons, rest, lcap = _family(topo, family)
    sch, omega, k = SCHEMES[scheme][family]
    x_port, lam_port, _, alpha = _port_sweep(family, scheme)

    nwin = -(-topo.num_particles // jsw.LANES)
    plan = jsw.pack_superblocks(cons, rest, nwin, layer_cap=lcap)
    sweep = jsw.make_sweep(plan, nwin, interpret=True, scheme=sch,
                           omega=omega, local_iters=k)
    x8 = np.zeros((8, nwin * jsw.LANES), np.float32)
    x8[0:3, :len(x)] = x.T
    x8[3, :len(x)] = w
    lam_packed = jsw.split_lambda(plan, jsw.pack_lambda(
        plan, jnp.asarray(lam[family])))

    @jax.jit
    def run(x8, lam_packed):
        return sweep(x8, lam_packed, jnp.float32(alpha),
                     sweep.fill_w(x8, sweep.tables))

    x8_out, lam_out = run(jnp.asarray(x8), lam_packed)
    lam_ref = np.asarray(jsw.unpack_lambda(plan,
                                           jsw.join_lambda(plan, lam_out)))
    _check(x_port, lam_port, np.asarray(x8_out)[0:3, :len(x)].T, lam_ref)


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_plain_sweep_matches_oracle_blocks(family, scheme):
    topo, x, w, lam = _scene()
    sch, omega, k = SCHEMES[scheme][family]
    x_port, lam_port, plan, _ = _port_sweep(family, scheme)

    params = SolverParams(edge_compliance=COMPLIANCE, volume_compliance=0.0)
    oracle = XpbdOracle(topo, params)
    oracle.w = w.copy()
    oracle.x_star = x.copy()
    oracle.edge_lambda = lam["edges"].copy()
    oracle.tet_lambda = lam["tets"].copy()
    solve = (oracle._solve_edges_block if family == "edges"
             else oracle._solve_tets_block)
    rows = plan.perm.reshape(-1, tsp.BLOCK)
    scl = plan.scale.reshape(-1, tsp.BLOCK)
    for r, s in zip(rows, scl):
        live = r >= 0
        for _ in range(k):
            solve(SDT, r[live], s[live], scheme=sch, omega=np.float32(omega))
    lam_ref = oracle.edge_lambda if family == "edges" else oracle.tet_lambda
    _check(x_port, lam_port, oracle.x_star, lam_ref)
