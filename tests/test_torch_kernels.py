"""The CUDA sweep kernels against their plain PyTorch versions on the card,
and the wrappers' input checks.  Imports no JAX, so it runs on a machine
with a card and no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Without a card the card tests skip (the CUDA kernels have no CPU mode).
Tolerance on the card: positions 1e-5 absolute, lambdas 1e-5 relative to
the largest |lambda|: the kernel sums a vertex's corrections in CSR order,
index_add_ in atomic order.
"""

import numpy as np
import pytest
import torch

import softbodysim_torch as sbt
from softbodysim_torch.kernels import sweep as ksw
from softbodysim_torch.kernels import sweep_plan as tsp

DT = 1.0 / 60.0
SCHEMES = {"split": ("split", 1.5, 1), "scale": ("scale", 1.0, 1),
           "split_k2": ("split", 2.2, 2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _plan_and_table(family, scheme, device):
    topo = sbt.meshes.tet_cube(7, 7, 7, size=1.0, center=(0.0, 0.8, 0.0))
    V = topo.num_particles
    rng = np.random.default_rng(0)
    cons, rest, lcap = ((topo.edges, topo.edge_rest, 2) if family == "edges"
                        else (topo.tets, topo.tet_rest_vol, 3))
    cons = cons.astype(np.int64)
    sch, omega, k = SCHEMES[scheme]
    nwin = -(-V // tsp.LANES)
    plan = tsp.pack_superblocks(cons, rest, layer_cap=lcap)
    dplan = ksw.to_device(
        tsp.build_gpu_plan(plan, cons, scheme=sch, omega=omega), device)
    xw = torch.zeros((nwin * tsp.LANES, 4))
    xw[:V, :3] = torch.from_numpy(
        (topo.vertices + rng.normal(0.0, 0.01, (V, 3))).astype(np.float32))
    xw[:V, 3] = sbt.init_state(topo).inv_mass
    xw[[0, 17], 3] = 0.0
    return dplan, xw.to(device), k


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_kernels_match_plain_on_card(family, scheme, cuda_device):
    dplan, xw, k = _plan_and_table(family, scheme, cuda_device)
    launches = ksw.w_fill.launches
    wk = ksw.w_fill(dplan, xw)
    assert ksw.w_fill.launches == launches + 1
    torch.testing.assert_close(wk, ksw.w_fill_plain(dplan, xw), rtol=0,
                               atol=0)
    fn, plain = ((ksw.edge_sweep, ksw.edge_sweep_plain) if family == "edges"
                 else (ksw.tet_sweep, ksw.tet_sweep_plain))
    lam0 = torch.zeros(dplan.num_blocks * tsp.BLOCK, device=cuda_device)
    xa, la, xb, lb = xw.clone(), lam0.clone(), xw.clone(), lam0.clone()
    launches = fn.launches
    fn(dplan, xa, la, wk, 1e-2, k)
    assert fn.launches == launches + 1
    plain(dplan, xb, lb, wk, 1e-2, k)
    torch.cuda.synchronize()
    assert not torch.equal(xa, xw)
    torch.testing.assert_close(xa, xb, rtol=0, atol=1e-5)
    torch.testing.assert_close(la, lb, rtol=0,
                               atol=1e-5 * lb.abs().max().item())


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda_device):
    """The whole step on the card (kernels) against the same step on the
    CPU (plain versions): 10 steps of tet_cube(4), 1e-4."""
    topo = sbt.meshes.tet_cube(4, 4, 4, size=0.5, center=(0.0, 0.6, 0.0))
    params = sbt.SolverParams(substeps=2, iterations=4, xpbd_backend="sweep")
    before = ksw.launch_counts()
    gpu = sbt.Engine(topo, params, device=cuda_device).run(10, DT)
    after = ksw.launch_counts()
    cpu = sbt.Engine(topo, params).run(10, DT)
    assert after["w_fill"] == before["w_fill"] + 2
    assert after["edge_sweep"] == before["edge_sweep"] + 10 * 2 * 4
    assert after["tet_sweep"] == before["tet_sweep"] + 10 * 2 * 4
    for f in ("x", "v", "edge_lambda", "tet_lambda"):
        torch.testing.assert_close(getattr(gpu.state, f).cpu(),
                                   getattr(cpu.state, f), rtol=0, atol=1e-4)


def test_wrappers_validate_inputs():
    dplan, xw, _ = _plan_and_table("edges", "split", torch.device("cpu"))
    lam_p = torch.zeros(dplan.num_blocks * tsp.BLOCK)
    wtab = ksw.w_fill(dplan, xw)
    with pytest.raises(TypeError):
        ksw.w_fill(dplan, xw.double())
    with pytest.raises(ValueError):
        ksw.edge_sweep(dplan, xw, lam_p[:-1], wtab, 0.0)
    with pytest.raises(ValueError):
        ksw.edge_sweep(dplan, xw.t().contiguous().t(), lam_p, wtab, 0.0)
    with pytest.raises(ValueError):
        ksw.tet_sweep(dplan, xw, lam_p, wtab, 0.0)
    with pytest.raises(ValueError):
        ksw.w_fill(dplan, xw.to("meta"))
    counts = ksw.launch_counts()
    ksw.edge_sweep(dplan, xw, lam_p, wtab, 0.0)   # plain version on the CPU
    assert ksw.launch_counts() == counts
    assert lam_p.abs().max() > 0
