"""The CUDA kernels against their plain PyTorch versions on the card, and
the wrappers' input checks.  Imports no JAX, so it runs on a machine with a
card and no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Without a card the card tests skip (the CUDA kernels have no CPU mode).
A sweep over its dependency schedule on many CTAs equals the same kernel
on one CTA bit for bit; a Jacobi pass gives the same bits on every
launch, and the pass step's CUDA graph replays equal its eager run bit for
bit.  Tolerances on the card: sweeps (both widths) and Jacobi passes,
positions 1e-5 absolute (the kernel sums a vertex's contributions in its
plan's order, index_add_ in atomic order; the Jacobi kernels round as the
TPU kernels, the plain versions as the segment formulation), lambdas 1e-5
relative to the largest |lambda|, Jacobi counts equal; collide 1e-6 (the
same arithmetic, no FMA on either side); whole steps on the card against
the CPU 1e-4 over 10 steps.  The contact stages give the same bits on
every call (their scatter sums integers) and match the CPU within 1e-6 m;
steps with contact on match the CPU within 1e-4 m over 10 steps and a
second card run bit for bit.  The collide Function's gradient equals
autograd through its plain version bit for bit (the backward is those
ops); differentiable rollouts on the card match the CPU within 1e-4 m
and their gradients within 1e-3 of the largest component (the backward's
scatters add in the card's atomic order).  The kernel steps, and the
coloured step's graphed build, raise when handed a tensor that requires
grad, on either device; the jacobi plain steps differentiate as built,
with the same bits under autograd as without.
"""

import dataclasses

import numpy as np
import pytest
import torch

import softbodysim_torch as sbt
from softbodysim_torch.kernels import collide as kc
from softbodysim_torch.kernels import launch_counts
from softbodysim_torch.kernels import jacobi as kj
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
    xw[:V, 3] = sbt.init_state(topo, device="cpu").inv_mass
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
    before = launch_counts()
    gpu = sbt.Engine(topo, params, device=cuda_device).run(10, DT)
    after = launch_counts()
    cpu = sbt.Engine(topo, params, device="cpu").run(10, DT)
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
    counts = launch_counts()
    ksw.edge_sweep(dplan, xw, lam_p, wtab, 0.0)   # plain version on the CPU
    assert launch_counts() == counts
    assert lam_p.abs().max() > 0


# the schedule variants: (superblocks, scheme, omega, local_iters, a
# per-constraint compliance table)
SCHEDULES = {"super": (True, "split", None, 1, False),
             "super_k2_table": (True, "split", None, 2, True),
             "legacy": (False, "scale", 1.0, 1, False),
             "legacy_table": (False, "scale", 1.0, 1, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(SCHEDULES))
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_schedule_matches_one_cta_bitwise(family, variant, cuda_device):
    """A sweep kernel over its plan's dependency schedule on the card's Q
    CTAs against the same kernel on one CTA (plan order): 20 back-to-back
    launches each from the same state, every launch's positions and
    lambdas equal bit for bit (a race would show as a difference)."""
    superblocks, sch, omega, k, table = SCHEDULES[variant]
    topo = sbt.meshes.tet_cube(20, 20, 20, size=1.0, center=(0.0, 0.8, 0.0))
    V = topo.num_particles
    rng = np.random.default_rng(2)
    cons, rest, lcap = ((topo.edges, topo.edge_rest, 2) if family == "edges"
                        else (topo.tets, topo.tet_rest_vol, 3))
    cons = cons.astype(np.int64)
    if omega is None:
        omega = 1.5 if family == "edges" else 2.2
    plan = (tsp.pack_superblocks(cons, rest, layer_cap=lcap) if superblocks
            else tsp.pack_constraints(cons, rest))
    g = tsp.build_gpu_plan(
        plan, cons, scheme=sch, omega=omega,
        compliance=(rng.uniform(0.5, 2.0, len(cons)).astype(np.float32)
                    if table else None))
    many = ksw.to_device(g, cuda_device)
    one = ksw.to_device(g, cuda_device, queues=1)
    assert many.staged.queues > 1 and one.staged.queues == 1
    xw = torch.zeros((-(-V // tsp.LANES) * tsp.LANES, 4))
    xw[:V, :3] = torch.from_numpy(
        (topo.vertices + rng.normal(0.0, 0.01, (V, 3))).astype(np.float32))
    xw[:V, 3] = sbt.init_state(topo, device="cpu").inv_mass
    xw = xw.to(cuda_device)
    width = g.width
    if superblocks:
        wt = ksw.w_fill(many, xw)
        fn = ksw.edge_sweep if family == "edges" else ksw.tet_sweep

        def sweep(p, x, lam):
            fn(p, x, lam, wt, 1e-2, k)
    else:
        fn = (ksw.legacy_edge_sweep if family == "edges"
              else ksw.legacy_tet_sweep)

        def sweep(p, x, lam):
            fn(p, x, lam, 1e-2)
    outs = []
    for p in (many, one):
        x = xw.clone()
        lam = torch.zeros(g.num_blocks * width, device=cuda_device)
        snaps = []
        for _ in range(20):
            sweep(p, x, lam)
            snaps.append(torch.cat([x.reshape(-1), lam]))
        outs.append(torch.stack(snaps))
    torch.cuda.synchronize()
    ksw.raise_on_timeouts()
    assert not torch.equal(outs[1][0][:xw.numel()], xw.reshape(-1))
    assert torch.equal(outs[0], outs[1])


# --------------------------------------------------------------------------
# The bf16 particle table (SolverParams.xpbd_x_dtype="bfloat16"): the w
# fill, the super-block sweeps and the collide stage instantiated on 8-byte
# rows.  The kernel and the plain version sum in f32 in different orders
# (CSR rows against index_add_), so a row may round one bf16 ulp apart:
# coordinates within 1 bf16 ulp of their magnitude, at least 90% of the
# rows bit-equal; the w fill and the schedule against one CTA bit for bit.
# --------------------------------------------------------------------------

BF16_ROWS_EQUAL = 0.9
BF16_COUNTS = ("w_fill_bf16", "edge_sweep_bf16", "tet_sweep_bf16",
               "collide_bf16")


def _assert_bf16_close(got, want):
    a, b = got[:, :3].float(), want[:, :3].float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert ((a - b).abs() <= ulp).all(), ((a - b).abs() / ulp).max()
    equal = (got == want).all(1).float().mean().item()
    assert equal >= BF16_ROWS_EQUAL, equal
    assert torch.equal(got[:, 3], want[:, 3])       # w is never written


def _moved_counts(before):
    after = launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["split", "split_k2"])
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_bf16_kernels_match_plain_on_card(family, scheme, cuda_device):
    dplan, xw, k = _plan_and_table(family, scheme, cuda_device)
    xw = xw.to(torch.bfloat16)
    fn, plain = ((ksw.edge_sweep, ksw.edge_sweep_plain) if family == "edges"
                 else (ksw.tet_sweep, ksw.tet_sweep_plain))
    lam0 = torch.zeros(dplan.num_blocks * tsp.BLOCK, device=cuda_device)
    xa, la, xb, lb = xw.clone(), lam0.clone(), xw.clone(), lam0.clone()
    before = launch_counts()
    wk = ksw.w_fill(dplan, xw)
    fn(dplan, xa, la, wk, 1e-2, k)
    assert _moved_counts(before) == {"w_fill_bf16": 1,
                                     f"{fn.__name__}_bf16": 1}
    assert wk.dtype == torch.float32
    assert torch.equal(wk, ksw.w_fill_plain(dplan, xw))
    plain(dplan, xb, lb, wk, 1e-2, k)
    torch.cuda.synchronize()
    assert xa.dtype == torch.bfloat16 and not torch.equal(xa, xw)
    _assert_bf16_close(xa, xb)
    torch.testing.assert_close(la, lb, rtol=0,
                               atol=1e-5 * lb.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_bf16_schedule_matches_one_cta_bitwise(family, cuda_device):
    """The bf16 sweep over the card's Q CTAs against one CTA: 20 launches
    each from the same table, every launch's rows and lambdas equal bit
    for bit."""
    topo = sbt.meshes.tet_cube(20, 20, 20, size=1.0, center=(0.0, 0.8, 0.0))
    V = topo.num_particles
    rng = np.random.default_rng(3)
    cons, rest, lcap = ((topo.edges, topo.edge_rest, 2) if family == "edges"
                        else (topo.tets, topo.tet_rest_vol, 3))
    cons = cons.astype(np.int64)
    g = tsp.build_gpu_plan(tsp.pack_superblocks(cons, rest, layer_cap=lcap),
                           cons, scheme="split",
                           omega=1.5 if family == "edges" else 2.2)
    many = ksw.to_device(g, cuda_device)
    one = ksw.to_device(g, cuda_device, queues=1)
    xw = torch.zeros((-(-V // tsp.LANES) * tsp.LANES, 4))
    xw[:V, :3] = torch.from_numpy(
        (topo.vertices + rng.normal(0.0, 0.01, (V, 3))).astype(np.float32))
    xw[:V, 3] = sbt.init_state(topo, device="cpu").inv_mass
    xw = xw.to(cuda_device, torch.bfloat16)
    wt = ksw.w_fill(many, xw)
    fn = ksw.edge_sweep if family == "edges" else ksw.tet_sweep
    outs = []
    for p in (many, one):
        x = xw.clone()
        lam = torch.zeros(g.num_blocks * g.width, device=cuda_device)
        snaps = []
        for _ in range(20):
            fn(p, x, lam, wt, 1e-2, 1)
            snaps.append(torch.cat([x.float().reshape(-1), lam]))
        outs.append(torch.stack(snaps))
    torch.cuda.synchronize()
    ksw.raise_on_timeouts()
    assert many.staged.queues > 1
    assert not torch.equal(outs[1][0][:xw.numel()], xw.float().reshape(-1))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_bf16_collide_matches_plain_on_card(cuda_device):
    _, xw, rng = _jacobi_table(SIZES["medium"], cuda_device)
    xw[:, :3] = torch.from_numpy(rng.uniform(
        -0.8, 0.8, (xw.shape[0], 3)).astype(np.float32)).to(cuda_device)
    xw = xw.to(torch.bfloat16)
    packed = kc.pack_colliders(sbt.Colliders.build([
        sbt.Colliders.sphere((0.0, 0.2, 0.0), 0.4),
        sbt.Colliders.box((0.5, 0.0, -0.3), (0.3, 0.2, 0.25))],
        device=cuda_device))
    xa = xw.clone()
    before = launch_counts()
    kc.collide(xa, packed, kc.XPBD_GROUND)
    assert _moved_counts(before) == {"collide_bf16": 1}
    xb = kc.collide_plain(xw, packed, kc.XPBD_GROUND)
    torch.cuda.synchronize()
    assert xa.dtype == xb.dtype == torch.bfloat16
    assert (xa.float() - xw.float()).abs().max() > 0.01
    _assert_bf16_close(xa, xb)
    pinned = xw[:, 3] == 0
    assert torch.equal(xa[pinned], xw[pinned])


@pytest.mark.cuda
def test_bf16_engine_on_card_matches_cpu(cuda_device):
    """The north star's configuration shape (8 x 1) on tet_cube(7) with a
    box under it, on the bf16 table: only the bf16 kernels launch, and 10
    steps on the card stay within 1e-2 m of the CPU's (the f32 engines'
    allowance for chaotic growth, test_torch_engine.py)."""
    topo = sbt.meshes.tet_cube(7, 7, 7, size=0.5, center=(0.0, 0.5, 0.0))
    params = sbt.SolverParams(dialect="xpbd", substeps=8, iterations=1,
                              xpbd_backend="sweep", xpbd_x_dtype="bfloat16")
    runs = {}
    for dev in (torch.device("cpu"), cuda_device):
        box = sbt.Colliders.build(
            [sbt.Colliders.box((0.0, 0.05, 0.0), (0.4, 0.05, 0.4))],
            device=dev)
        before = launch_counts()
        eng = sbt.Engine(topo, params, colliders=box, device=dev).run(10, DT)
        runs[dev.type] = (eng.positions(), _moved_counts(before))
    assert runs["cpu"][1] == {}
    assert runs["cuda"][1] == {"w_fill_bf16": 2, "edge_sweep_bf16": 80,
                               "tet_sweep_bf16": 80, "collide_bf16": 80}
    x_card, x_cpu = runs["cuda"][0], runs["cpu"][0]
    assert np.isfinite(x_card).all()
    assert x_card[:, 1].min() < 0.2                  # it reached the box
    np.testing.assert_allclose(x_card, x_cpu, rtol=0, atol=1e-2)


# --------------------------------------------------------------------------
# Jacobi passes and the fused collide stage
# --------------------------------------------------------------------------

SIZES = {"small": 4, "medium": 12}
BOX = sbt.Colliders.box((0.0, 0.1, 0.0), (0.6, 0.1, 0.6))


def _jacobi_table(n, device, seed=0):
    topo = sbt.meshes.tet_cube(n, n, n, size=1.0, center=(0.0, 0.8, 0.0))
    rng = np.random.default_rng(seed)
    V = topo.num_particles
    xw = torch.zeros((V, 4))
    xw[:, :3] = torch.from_numpy(
        (topo.vertices + rng.normal(0.0, 0.01, (V, 3))).astype(np.float32))
    xw[:, 3] = sbt.init_state(topo, inv_mass_mode="density",
                              device="cpu").inv_mass
    xw[[0, 17], 3] = 0.0
    return topo, xw.to(device), rng


@pytest.mark.cuda
@pytest.mark.parametrize("perk", [False, True])
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_jacobi_passes_match_plain_on_card(family, size, perk, cuda_device):
    topo, xin, rng = _jacobi_table(SIZES[size], cuda_device)
    cons, rest = ((topo.edges, topo.edge_rest) if family == "edges"
                  else (topo.tets, topo.tet_rest_vol))
    table = rng.uniform(0.2, 1.0, len(cons)) if perk else None
    make, fn, plain = ((kj.edge_pass_plan, kj.jacobi_edge_pass,
                        kj.jacobi_edge_pass_plain) if family == "edges"
                       else (kj.tet_pass_plan, kj.jacobi_tet_pass,
                             kj.jacobi_tet_pass_plain))
    plan = make(topo.num_particles, cons, rest, table, device=cuda_device,
                vertices=topo.vertices)
    V = topo.num_particles
    xa, xb = torch.empty_like(xin), torch.empty_like(xin)
    ca = torch.zeros(V, dtype=torch.int32, device=cuda_device)
    cb = torch.zeros_like(ca)
    launches = fn.launches
    fn(plan, xin, xa, 0.9, 1.4, ca)
    assert fn.launches == launches + 1
    plain(plan, xin, xb, 0.9, 1.4, cb)
    torch.cuda.synchronize()
    assert not torch.equal(xa, xin)
    torch.testing.assert_close(xa, xb, rtol=0, atol=1e-5)
    assert torch.equal(ca, cb)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_jacobi_pass_tiles_on_card(family, cuda_device):
    """The tiled pass kernel with per-constraint stiffness against its
    plain version (1e-5, counts equal), and 20 launches from one snapshot
    equal bit for bit (a fixed summation order, no atomics)."""
    topo, xin, rng = _jacobi_table(SIZES["medium"], cuda_device, seed=4)
    cons, rest = ((topo.edges, topo.edge_rest) if family == "edges"
                  else (topo.tets, topo.tet_rest_vol))
    make, fn, plain = ((kj.edge_pass_plan, kj.jacobi_edge_pass,
                        kj.jacobi_edge_pass_plain) if family == "edges"
                       else (kj.tet_pass_plan, kj.jacobi_tet_pass,
                             kj.jacobi_tet_pass_plain))
    V = topo.num_particles
    plan = make(V, cons, rest, rng.uniform(0.2, 1.0, len(cons)),
                device=cuda_device, vertices=topo.vertices)
    assert plan.tiles.num_tiles > 1 and kj.ctas_per_sm(plan) >= 2
    xa, xb = torch.empty_like(xin), torch.empty_like(xin)
    ca = torch.zeros(V, dtype=torch.int32, device=cuda_device)
    cb = torch.zeros_like(ca)
    fn(plan, xin, xa, 0.9, 1.4, ca)
    plain(plan, xin, xb, 0.9, 1.4, cb)
    outs = torch.empty((20, V, 4), device=cuda_device)
    for i in range(20):
        fn(plan, xin, outs[i], 0.9, 1.4)
    torch.cuda.synchronize()
    assert not torch.equal(xa, xin)
    torch.testing.assert_close(xa, xb, rtol=0, atol=1e-5)
    assert torch.equal(ca, cb)
    assert torch.equal(outs, xa.expand_as(outs))


def _pass_step(case, device):
    """A JacobiPassStep on the card and its start state: tet_cube(6) onto
    a box (optionally Chebyshev-blended), or its edges alone with five
    iterations (an odd number of passes per substep: the substeps start
    from alternate tables)."""
    import dataclasses

    from softbodysim_torch.solver.jacobi_pass import JacobiPassStep

    topo = sbt.meshes.tet_cube(6, 6, 6, size=0.5, center=(0.0, 0.45, 0.0))
    kw = dict(dialect="jacobi", jacobi_backend="pass")
    if case == "chebyshev":
        kw.update(chebyshev=True, chebyshev_rho=0.9, chebyshev_delay=2)
    if case == "edges_odd":
        topo = dataclasses.replace(
            topo, tets=np.zeros((0, 4), np.int32),
            tet_rest_vol=np.zeros(0, np.float32))
        kw.update(iterations=5)
    step = JacobiPassStep(topo, sbt.SolverParams(**kw),
                          sbt.Colliders.build([BOX], device=device),
                          device=device)
    state = sbt.init_state(topo, inv_mass_mode="density", device=device)
    return step, state


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cube", "chebyshev", "edges_odd"])
def test_jacobi_pass_graph_matches_eager_bitwise(case, cuda_device):
    """``run_carry`` on the card replays one CUDA graph per substep; it
    equals the same step run eagerly (kernel by kernel) on the same card
    bit for bit, and counts the same kernel launches (the replays add
    what their captures recorded)."""
    from softbodysim_torch.kernels import reset_launch_counts

    step, state = _pass_step(case, cuda_device)
    graphed, eager = step.pack_state(state), step.pack_state(state)
    packed = kc.pack_colliders(step.colliders)
    substeps = step.params.substeps
    reset_launch_counts()
    for n in (3, 1, 4):
        graphed = step.run_carry(graphed, DT, n)
    torch.cuda.synchronize()
    counts = launch_counts()
    reset_launch_counts()
    eager = step._run_eager(eager, 8 * substeps, step._scalars(DT), packed)
    torch.cuda.synchronize()
    assert launch_counts() == counts
    assert len(step._graphs) == (2 if case == "edges_odd" else 1)
    # the collide stage runs inside each iteration's last pass
    last = ("jacobi_edge_pass_collide" if case == "edges_odd"
            else "jacobi_tet_pass_collide")
    assert counts[last] == 8 * substeps * step.params.iterations
    assert counts["collide"] == 0
    assert torch.equal(graphed.xw, eager.xw)
    assert torch.equal(graphed.vv, eager.vv)
    assert not torch.equal(graphed.xw[:, :3], state.x)


@pytest.mark.cuda
def test_jacobi_pass_graph_sees_poses_and_overrides(cuda_device):
    """The replays read the runtime collider poses and the step-time
    stiffness overrides: a moved box and overrides that change every step
    give the eager step's bits, differ from the run without them, and
    capture no further graph."""
    step, state = _pass_step("cube", cuda_device)
    moved = sbt.Colliders.build(
        [sbt.Colliders.box((0.05, 0.14, 0.0), (0.6, 0.1, 0.6))],
        device=cuda_device)
    ov = dict(edge_stiffness=0.5, volume_stiffness=0.7, sor_omega=1.1)
    graphed, eager, plain = (step.pack_state(state) for _ in range(3))
    ss = step.params.substeps
    for _ in range(6):
        graphed = step.run_carry(graphed, DT, 1)
        plain = step.run_carry(plain, DT, 1)
    eager = step._run_eager(eager, 6 * ss, step._scalars(DT),
                            kc.pack_colliders(step.colliders))
    graphs = len(step._graphs)
    for i in range(4):
        o = {key: v + 0.01 * i for key, v in ov.items()}
        graphed = step.run_carry(graphed, DT, 1, colliders_rt=moved, **o)
        plain = step.run_carry(plain, DT, 1)
        eager = step._run_eager(eager, ss, step._scalars(DT, **o),
                                kc.pack_colliders(moved))
    torch.cuda.synchronize()
    assert len(step._graphs) == graphs == 1
    assert torch.equal(graphed.xw, eager.xw)
    assert torch.equal(graphed.vv, eager.vv)
    assert (graphed.xw - plain.xw).abs().max() > 1e-4
    free = graphed.xw[:, 3] != 0
    assert graphed.xw[free, 1].min() >= 0.24 - 1e-3       # the moved top


def _pass_kit(family):
    return ((kj.edge_pass_plan, kj.jacobi_edge_pass,
             kj.jacobi_edge_pass_collide, kj.jacobi_edge_pass_plain)
            if family == "edges"
            else (kj.tet_pass_plan, kj.jacobi_tet_pass,
                  kj.jacobi_tet_pass_collide, kj.jacobi_tet_pass_plain))


def _three_colliders(device):
    """A floor box, a sphere and a capsule, and the ground plane."""
    q = (0.1826, 0.3651, 0.5477, 0.7303)
    cols = sbt.Colliders.build([
        sbt.Colliders.box((0.0, 0.1, 0.0), (1.5, 0.1, 1.5)),
        sbt.Colliders.sphere((0.1, 0.45, 0.0), 0.2),
        sbt.Colliders.capsule((-0.3, 0.5, 0.2), 0.1, 0.3, rotation=q)],
        device=device)
    return kc.pack_colliders(cols), kc.make_ground(sbt.SolverParams(
        dialect="jacobi", particle_radius=0.02))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_fused_collide_pass_equals_pass_then_collide_bitwise(family,
                                                            cuda_device):
    """The pass with the collide stage fused equals the pass followed by
    the stand-alone collide kernel bit for bit, on 20 launches from one
    snapshot (a floor box, a sphere and a capsule the body sinks into,
    pinned rows untouched), and its plain version within 1e-5 m."""
    topo, xin, _ = _jacobi_table(SIZES["medium"], cuda_device, seed=6)
    xin[:, 1] -= 0.45                       # into the box, sphere, capsule
    cons, rest = ((topo.edges, topo.edge_rest) if family == "edges"
                  else (topo.tets, topo.tet_rest_vol))
    make, fn, fused, plain = _pass_kit(family)
    V = topo.num_particles
    plan = make(V, cons, rest, device=cuda_device, vertices=topo.vertices)
    packed, ground = _three_colliders(cuda_device)
    want = torch.empty_like(xin)
    cw = torch.zeros(V, dtype=torch.int32, device=cuda_device)
    fn(plan, xin, want, 0.9, 1.4, cw)
    moved = want.clone()
    kc.collide(want, packed, ground)
    launches = fused.launches
    outs = torch.empty((20, V, 4), device=cuda_device)
    cnt = torch.zeros(V, dtype=torch.int32, device=cuda_device)
    for i in range(20):
        fused(plan, xin, outs[i], 0.9, 1.4, packed, ground,
              cnt if i == 0 else None)
    assert fused.launches == launches + 20
    ref = torch.empty_like(xin)
    plain(plan, xin, ref, 0.9, 1.4)
    ref = kc.collide_plain(ref, packed, ground)
    torch.cuda.synchronize()
    assert (want - moved).abs().max() > 1e-3            # the stage pushed
    assert torch.equal(outs, want.expand_as(outs))
    assert torch.equal(cnt, cw)
    torch.testing.assert_close(outs[0], ref, rtol=0, atol=1e-5)
    pinned = xin[:, 3] == 0
    assert pinned.any() and torch.equal(outs[0][pinned], xin[pinned])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["edges", "tets"])
@pytest.mark.parametrize("subdivisions", [5, 6])
def test_heavy_vertex_pass_on_card(subdivisions, family, cuda_device):
    """tet_ball(5) and tet_ball(6) (the centre in every tet): the centre
    is heavy, summed from per-tile partials by the launch's last CTA.  20
    launches equal bit for bit; within 1e-5 m of the plain version,
    counts equal; the fused collide variant equals pass + collide."""
    from test_torch_jacobi_tiles import fan_ball

    ball = fan_ball(subdivisions)
    V = ball.num_particles
    rng = np.random.default_rng(subdivisions)
    xin = torch.zeros((V, 4))
    xin[:, :3] = torch.from_numpy((ball.vertices + np.array(
        [0.0, 0.45, 0.0], np.float32) + rng.normal(0.0, 0.01, (V, 3))
        ).astype(np.float32))
    xin[:, 3] = torch.from_numpy(rng.uniform(0.5, 2.0, V).astype(
        np.float32))
    xin[[3, 40], 3] = 0.0
    xin = xin.to(cuda_device)
    cons = ball.edges if family == "edges" else ball.tets
    rest = (np.linalg.norm(ball.vertices[cons[:, 0]]
                           - ball.vertices[cons[:, 1]], axis=1)
            if family == "edges" else np.full(len(cons), 1e-5))
    make, fn, fused, plain = _pass_kit(family)
    plan = make(V, cons, rest.astype(np.float32), device=cuda_device,
                vertices=ball.vertices)
    assert plan.tiles.heavy.tolist() == [V - 1]
    xa, xb = torch.empty_like(xin), torch.empty_like(xin)
    ca = torch.zeros(V, dtype=torch.int32, device=cuda_device)
    cb = torch.zeros_like(ca)
    fn(plan, xin, xa, 0.9, 1.4, ca)
    plain(plan, xin, xb, 0.9, 1.4, cb)
    outs = torch.empty((20, V, 4), device=cuda_device)
    for i in range(20):
        fn(plan, xin, outs[i], 0.9, 1.4)
    packed, ground = _three_colliders(cuda_device)
    want = xa.clone()
    kc.collide(want, packed, ground)
    got = torch.empty_like(xin)
    fused(plan, xin, got, 0.9, 1.4, packed, ground)
    torch.cuda.synchronize()
    assert torch.equal(outs, xa.expand_as(outs))
    torch.testing.assert_close(xa, xb, rtol=0, atol=1e-5)
    assert torch.equal(ca, cb)
    assert ca[V - 1] == int((cons == V - 1).any(1).sum())   # all valid
    assert not torch.equal(xa[V - 1], xin[V - 1])
    assert torch.equal(got, want)
    assert plan.tiles.ticket.item() == 0


@pytest.mark.cuda
def test_coloured_step_captures_one_graph_on_card(cuda_device,
                                                  monkeypatch):
    """The coloured step with an edge compliance that changes every step
    captures one graph (the scalars are a device tensor it reads) and
    matches the same steps on the CPU within 1e-4."""
    captures = []
    begin = torch.cuda.CUDAGraph.capture_begin
    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin",
                        lambda self, *a, **k: captures.append(1)
                        or begin(self, *a, **k))
    topo = sbt.meshes.tet_cube(3, 3, 3, size=0.5, center=(0.0, 0.3, 0.0))
    params = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=4,
                              xpbd_backend="gather")
    engines = [sbt.Engine(topo, params, device=d)
               for d in (cuda_device, "cpu")]
    for i in range(5):
        for eng in engines:
            eng.step(DT, edge_compliance=1e-6 * (i + 1),
                     volume_compliance=2e-7 * i)
    torch.cuda.synchronize()
    assert len(captures) == 1
    torch.testing.assert_close(engines[0].state.x.cpu(),
                               engines[1].state.x, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("size", list(SIZES))
def test_collide_matches_plain_on_card(size, cuda_device):
    _, xw, rng = _jacobi_table(SIZES[size], cuda_device)
    xw[:, :3] = torch.from_numpy(rng.uniform(
        -0.8, 0.8, (xw.shape[0], 3)).astype(np.float32)).to(cuda_device)
    q = (0.1826, 0.3651, 0.5477, 0.7303)
    cols = sbt.Colliders.build([
        sbt.Colliders.sphere((0.0, 0.2, 0.0), 0.4), None,
        sbt.Colliders.box((0.5, 0.0, -0.3), (0.3, 0.2, 0.25), rotation=q),
        sbt.Colliders.capsule((-0.5, 0.1, 0.3), 0.2, 0.3, rotation=q)],
        capacity=6, device=cuda_device)
    packed = kc.pack_colliders(cols)
    ground = kc.make_ground(sbt.SolverParams(
        ground_point=(0.0, -0.3, 0.0), particle_radius=0.03))
    xa, xb = xw.clone(), xw.clone()
    launches = kc.collide.launches
    kc.collide(xa, packed, ground)
    assert kc.collide.launches == launches + 1
    xb = kc.collide_plain(xb, packed, ground)
    torch.cuda.synchronize()
    assert (xa - xw).abs().max() > 0.01
    torch.testing.assert_close(xa, xb, rtol=0, atol=1e-6)
    pinned = xw[:, 3] == 0
    assert torch.equal(xa[pinned], xw[pinned])


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pass", "gather"])
def test_jacobi_engine_on_card_matches_cpu(backend, cuda_device):
    """The jacobi Engine on the card (kernels) against the same Engine on
    the CPU (plain versions): 10 steps of tet_cube(4) onto a box, 1e-4."""
    topo = sbt.meshes.tet_cube(4, 4, 4, size=0.5, center=(0.0, 0.55, 0.0))
    params = sbt.SolverParams(dialect="jacobi", jacobi_backend=backend)

    def engine(dev):
        return sbt.Engine(topo, params, device=dev,
                          colliders=sbt.Colliders.build([BOX], device=dev))

    before = launch_counts()
    gpu = engine(cuda_device).run(10, DT)
    after = launch_counts()
    cpu = engine("cpu").run(10, DT)
    stages = 10 * params.substeps * params.iterations
    # the pass backend runs the collide stage inside its tet pass
    fused = backend == "pass"
    for name, n in (("collide", 0 if fused else stages),
                    ("jacobi_edge_pass", stages if fused else 0),
                    ("jacobi_tet_pass", 0),
                    ("jacobi_tet_pass_collide", stages if fused else 0)):
        assert after[name] == before[name] + n, name
    # velocities are position differences over sdt = 1/120 s: 1e-3
    for f, tol in (("x", 1e-4), ("v", 1e-3)):
        torch.testing.assert_close(getattr(gpu.state, f).cpu(),
                                   getattr(cpu.state, f), rtol=0, atol=tol)


@pytest.mark.cuda
def test_jacobi_gather_transform_on_card_uses_collide_kernel(cuda_device):
    """A body simulated in local space on the gather backend: its collide
    stage runs the collide kernel on the card on world-space rows, and 10
    steps match the same Engine on the CPU within 1e-4."""
    topo = sbt.meshes.tet_cube(4, 4, 4, size=0.5, center=(0.0, 0.55, 0.0))
    c, s = np.cos(0.3), np.sin(0.3)
    l2w = np.array([[c, 0, s, 0.05], [0, 1, 0, 0.1], [-s, 0, c, 0.0],
                    [0, 0, 0, 1]], np.float32)
    params = sbt.SolverParams(dialect="jacobi")

    def engine(dev):
        return sbt.Engine(topo, params, device=dev, local_to_world=l2w,
                          world_to_local=np.linalg.inv(l2w).astype(
                              np.float32),
                          colliders=sbt.Colliders.build([BOX], device=dev))

    before = launch_counts()
    gpu = engine(cuda_device)
    assert gpu.backend == "gather"
    gpu.run(10, DT)
    after = launch_counts()
    cpu = engine("cpu").run(10, DT)
    assert after["collide"] == before["collide"] + (
        10 * params.substeps * params.iterations)
    torch.testing.assert_close(gpu.state.x.cpu(), cpu.state.x, rtol=0,
                               atol=1e-4)


# --------------------------------------------------------------------------
# Legacy 128-wide sweeps and the xpbd collider stage
# --------------------------------------------------------------------------

def _legacy_plan_and_table(family, pera, device):
    topo = sbt.meshes.tet_cube(7, 7, 7, size=1.0, center=(0.0, 0.8, 0.0))
    V = topo.num_particles
    rng = np.random.default_rng(1)
    cons, rest = ((topo.edges, topo.edge_rest) if family == "edges"
                  else (topo.tets, topo.tet_rest_vol))
    cons = cons.astype(np.int64)
    table = (rng.uniform(0.5, 2.0, len(cons)).astype(np.float32)
             if pera else None)
    dplan = ksw.to_device(tsp.build_gpu_plan(
        tsp.pack_constraints(cons, rest), cons, scheme="scale", omega=1.0,
        compliance=table), device)
    nwin = -(-V // tsp.LANES)
    xw = torch.zeros((nwin * tsp.LANES, 4))
    xw[:V, :3] = torch.from_numpy(
        (topo.vertices + rng.normal(0.0, 0.01, (V, 3))).astype(np.float32))
    xw[:V, 3] = sbt.init_state(topo, device="cpu").inv_mass
    xw[[0, 17], 3] = 0.0
    return dplan, xw.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("pera", [False, True])
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_legacy_kernels_match_plain_on_card(family, pera, cuda_device):
    dplan, xw = _legacy_plan_and_table(family, pera, cuda_device)
    fn, plain = ((ksw.legacy_edge_sweep, ksw.edge_sweep_plain)
                 if family == "edges"
                 else (ksw.legacy_tet_sweep, ksw.tet_sweep_plain))
    lam0 = torch.zeros(dplan.num_blocks * tsp.LANES, device=cuda_device)
    xa, la, xb, lb = xw.clone(), lam0.clone(), xw.clone(), lam0.clone()
    launches = fn.launches
    fn(dplan, xa, la, 1e-2)
    assert fn.launches == launches + 1
    plain(dplan, xb, lb, None, 1e-2)
    torch.cuda.synchronize()
    assert not torch.equal(xa, xw)
    torch.testing.assert_close(xa, xb, rtol=0, atol=1e-5)
    torch.testing.assert_close(la, lb, rtol=0,
                               atol=1e-5 * lb.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("superblocks", [True, False])
def test_xpbd_sweep_colliders_on_card_match_cpu(superblocks, cuda_device):
    """The xpbd sweep step with a box collider on the card launches the
    collide kernel once per iteration (and, legacy, the legacy sweeps) and
    matches the same step on the CPU: 10 steps of tet_cube(4), 1e-4."""
    topo = sbt.meshes.tet_cube(4, 4, 4, size=0.5, center=(0.0, 0.45, 0.0))
    params = sbt.SolverParams(substeps=2, iterations=4, xpbd_backend="sweep")

    def engine(dev):
        return sbt.Engine(topo, params, device=dev, superblocks=superblocks,
                          colliders=sbt.Colliders.build([BOX], device=dev))

    before = launch_counts()
    gpu = engine(cuda_device).run(10, DT)
    after = launch_counts()
    cpu = engine("cpu").run(10, DT)
    stages = 10 * params.substeps * params.iterations
    assert after["collide"] == before["collide"] + stages
    names = (("edge_sweep", "tet_sweep") if superblocks
             else ("legacy_edge_sweep", "legacy_tet_sweep"))
    for name in names:
        assert after[name] == before[name] + stages, name
    for f in ("x", "edge_lambda", "tet_lambda"):
        torch.testing.assert_close(getattr(gpu.state, f).cpu(),
                                   getattr(cpu.state, f), rtol=0, atol=1e-4)
    assert gpu.positions()[:, 1].min() >= 0.2 - 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gather", "scatter"])
def test_xpbd_coloured_colliders_on_card_use_collide_kernel(backend,
                                                            cuda_device):
    """The coloured backend's collider stage is the collide kernel on the
    card ('scatter' is an alias of 'gather'); 10 steps match the same
    Engine on the CPU within 1e-4."""
    topo = sbt.meshes.tet_cube(3, 3, 3, size=0.5, center=(0.0, 0.45, 0.0))
    params = sbt.SolverParams(xpbd_backend=backend)

    def engine(dev):
        return sbt.Engine(topo, params, device=dev,
                          colliders=sbt.Colliders.build([BOX], device=dev))

    before = launch_counts()
    gpu = engine(cuda_device)
    assert gpu.backend == "gather"
    gpu.run(10, DT)
    after = launch_counts()
    cpu = engine("cpu").run(10, DT)
    assert after["collide"] == before["collide"] + (
        10 * params.substeps * params.iterations)
    for f in ("x", "edge_lambda", "tet_lambda"):
        torch.testing.assert_close(getattr(gpu.state, f).cpu(),
                                   getattr(cpu.state, f), rtol=0, atol=1e-4)


# ---- per-body material tables on a merged two-body mesh (Scene.build_merged)

def _bodies():
    return [sbt.meshes.tet_cube(6, 5, 4, size=0.6, center=(-0.6, 0.8, 0.0)),
            sbt.meshes.tet_ball(2, 0.3, (0.6, 0.8, 0.0))]


def _two_bodies():
    """The merged mesh and body 0's (edge, tet) counts."""
    from softbodysim_torch.core.topology import merge_topologies

    parts = _bodies()
    merged, _ = merge_topologies(parts)
    return merged, {"edges": parts[0].num_edges, "tets": parts[0].num_tets}


def _per_body(counts, values):
    return np.concatenate([np.full(n, v, np.float32)
                           for n, v in zip(counts, values)])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_merged_passes_with_body_stiffness_on_card(family, cuda_device):
    """The pass kernels on a merged mesh whose bodies have their own
    stiffness (the per-constraint table of a mixed-stiffness merge)
    against their plain versions: 1e-5, counts equal."""
    topo, first = _two_bodies()
    V = topo.num_particles
    rng = np.random.default_rng(2)
    xin = torch.zeros((V, 4))
    xin[:, :3] = torch.from_numpy(
        (topo.vertices + rng.normal(0.0, 0.01, (V, 3))).astype(np.float32))
    xin[:, 3] = sbt.init_state(topo, inv_mass_mode="density",
                               device="cpu").inv_mass
    xin = xin.to(cuda_device)
    cons, rest = ((topo.edges, topo.edge_rest) if family == "edges"
                  else (topo.tets, topo.tet_rest_vol))
    n0 = first[family]
    table = _per_body((n0, len(cons) - n0), (0.9, 0.3))
    make, fn, plain = ((kj.edge_pass_plan, kj.jacobi_edge_pass,
                        kj.jacobi_edge_pass_plain) if family == "edges"
                       else (kj.tet_pass_plan, kj.jacobi_tet_pass,
                             kj.jacobi_tet_pass_plain))
    plan = make(V, cons, rest, table, device=cuda_device,
                vertices=topo.vertices)
    xa, xb = torch.empty_like(xin), torch.empty_like(xin)
    ca = torch.zeros(V, dtype=torch.int32, device=cuda_device)
    cb = torch.zeros_like(ca)
    launches = fn.launches
    fn(plan, xin, xa, 1.0, 1.4, ca)
    assert fn.launches == launches + 1
    plain(plan, xin, xb, 1.0, 1.4, cb)
    torch.cuda.synchronize()
    assert not torch.equal(xa, xin)
    torch.testing.assert_close(xa, xb, rtol=0, atol=1e-5)
    assert torch.equal(ca, cb)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_merged_sweeps_with_body_compliance_on_card(family, cuda_device):
    """The super-block sweeps with a per-body compliance table (the
    per-constraint alpha of a mixed-compliance merge) against their plain
    versions, at the tolerances above."""
    topo, first = _two_bodies()
    V = topo.num_particles
    rng = np.random.default_rng(3)
    cons, rest, lcap = ((topo.edges, topo.edge_rest, 2) if family == "edges"
                        else (topo.tets, topo.tet_rest_vol, 3))
    cons = cons.astype(np.int64)
    n0 = first[family]
    table = _per_body((n0, len(cons) - n0), (1e-4, 5e-3))
    plan = tsp.pack_superblocks(cons, rest, layer_cap=lcap)
    dplan = ksw.to_device(tsp.build_gpu_plan(
        plan, cons, scheme="split", omega=1.5, compliance=table),
        cuda_device)
    nwin = -(-V // tsp.LANES)
    xw = torch.zeros((nwin * tsp.LANES, 4))
    xw[:V, :3] = torch.from_numpy(
        (topo.vertices + rng.normal(0.0, 0.01, (V, 3))).astype(np.float32))
    xw[:V, 3] = sbt.init_state(topo, device="cpu").inv_mass
    xw = xw.to(cuda_device)
    wk = ksw.w_fill(dplan, xw)
    fn, plain = ((ksw.edge_sweep, ksw.edge_sweep_plain) if family == "edges"
                 else (ksw.tet_sweep, ksw.tet_sweep_plain))
    lam0 = torch.zeros(dplan.num_blocks * tsp.BLOCK, device=cuda_device)
    xa, la, xb, lb = xw.clone(), lam0.clone(), xw.clone(), lam0.clone()
    alpha = 14400.0                        # the tables' scale: 1 / sdt^2
    fn(dplan, xa, la, wk, alpha, 1)
    plain(dplan, xb, lb, wk, alpha, 1)
    torch.cuda.synchronize()
    assert not torch.equal(xa, xw)
    torch.testing.assert_close(xa, xb, rtol=0, atol=1e-5)
    torch.testing.assert_close(la, lb, rtol=0,
                               atol=1e-5 * lb.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dialect", ["jacobi", "xpbd"])
def test_mixed_material_merge_on_card_matches_cpu(dialect, cuda_device):
    """Scene.build_merged of two bodies with their own stiffness (jacobi:
    the pass kernels with edge_k / tet_k) or compliance (xpbd: the sweep
    kernels with edge_c / tet_c) on the card against the same scene on the
    CPU: 10 steps, 1e-4, from a deformed start (every position moved by
    N(0, 1 cm), the same draws on both), so every constraint's table entry
    weighs from the first step."""
    from softbodysim_torch.api import scenes

    bodies = _bodies()
    if dialect == "jacobi":
        params = [scenes._params(edge=0.9), scenes._params(edge=0.4, vol=0.6)]
        kernels = ("jacobi_edge_pass", "jacobi_tet_pass_collide")
    else:
        base = sbt.SolverParams(substeps=2, iterations=3)
        params = [base, base.replace(edge_compliance=5e-3,
                                     volume_compliance=1e-4)]
        kernels = ("edge_sweep", "tet_sweep")
    scene = scenes.Scene(name="mixed", colliders=[], bodies=[
        (f"b{i}", t, p, {}) for i, (t, p) in enumerate(zip(bodies, params))])
    gpu, _ = scene.build_merged(device=cuda_device)
    cpu, _ = scene.build_merged(device="cpu")
    noise = torch.from_numpy(np.random.default_rng(6).normal(
        0.0, 0.01, tuple(cpu.state.x.shape)).astype(np.float32))
    for eng in (gpu, cpu):
        x = eng.state.x + noise.to(eng.state.x.device)
        eng.state = dataclasses.replace(eng.state, x=x, x_star=x.clone())
    before = launch_counts()
    gpu.run(10, DT)
    after = launch_counts()
    cpu.run(10, DT)
    assert gpu.backend == ("pass" if dialect == "jacobi" else "sweep")
    for k in kernels:
        assert after[k] > before[k], k
    torch.testing.assert_close(gpu.state.x.cpu(), cpu.state.x, rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dialect", ["jacobi", "xpbd"])
def test_batched_step_on_card_matches_cpu(dialect, cuda_device):
    """A batch of 4 scenes with per-scene stiffness (jacobi) or compliance
    (xpbd, through the coloured step's CUDA graph with compliance tables)
    and a box: the card against the CPU, 10 steps, 1e-4; the collide
    kernel launches once per iteration for all scenes."""
    from softbodysim_torch.parallel import BatchedEngine

    topo = sbt.meshes.tet_cube(3, 3, 3, size=0.5, center=(0.0, 0.45, 0.0))
    params = sbt.SolverParams(dialect=dialect, substeps=2, iterations=3)
    per_scene = ((torch.tensor([0.9, 0.7, 0.5, 0.3]), torch.full((4,), 0.98))
                 if dialect == "jacobi" else
                 (torch.tensor([1e-4, 5e-4, 1e-3, 5e-3]), torch.zeros(4)))
    engines = {}
    for dev in (cuda_device, torch.device("cpu")):
        box = sbt.Colliders.build([BOX], device=dev)
        before = launch_counts()
        eng = BatchedEngine(topo, params, 4, colliders=box,
                            randomized_stiffness=True, device=dev)
        for _ in range(10):
            eng.step(DT, *per_scene)
        engines[dev.type] = (eng, launch_counts()["collide"]
                             - before["collide"])
    assert engines["cuda"][1] == 10 * 2 * 3
    torch.testing.assert_close(engines["cuda"][0].state.x.cpu(),
                               engines["cpu"][0].state.x, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_grouped_and_hetero_engines_on_card_match_cpu(cuda_device):
    """FourBodyTest's grouped engine (one batched step per family) and a
    heterogeneous padded batch with a box (the collide kernel once per
    iteration for all scenes): the card against the CPU, 8 steps, 1e-4."""
    from softbodysim_torch.api import scenes
    from softbodysim_torch.parallel import HeteroEngine

    scene = scenes.four_body_test()
    topos = [sbt.meshes.tet_ball(1, 0.2, (0.0, 0.8, 0.0)),
             sbt.meshes.tet_cube(3, 2, 2, 0.4, (1.0, 0.9, 0.0))]
    params = sbt.SolverParams(dialect="jacobi", substeps=2, iterations=4)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        grouped = scene.build_grouped(device=dev)
        het = HeteroEngine(topos, params, device=dev,
                           colliders=sbt.Colliders.build([BOX], device=dev))
        before = launch_counts()["collide"]
        for _ in range(8):
            grouped.step(DT)
            het.step(DT)
        out[dev.type] = (dict(grouped.positions()), het.positions(),
                         launch_counts()["collide"] - before)
    gpu, cpu = out["cuda"], out["cpu"]
    # the floor box: 8 steps x 2 x 6 per family; the hetero box: 8 x 2 x 4
    assert gpu[2] == 8 * 2 * 6 + 8 * 2 * 4
    for name in cpu[0]:
        np.testing.assert_allclose(gpu[0][name], cpu[0][name], rtol=0,
                                   atol=1e-4)
    for g, c in zip(gpu[1], cpu[1]):
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-4)


def _contact_pair():
    from softbodysim_torch.core.adjacency import combine_topologies

    return combine_topologies([
        sbt.meshes.tet_cube(3, 3, 3, size=0.3, center=(0.0, 0.15, 0.0)),
        sbt.meshes.tet_cube(3, 3, 3, size=0.3,
                            center=(0.037, 0.46, 0.023))])[0]


_CONTACT = dict(particle_radius=0.02, self_collision=True,
                self_collision_cell=0.05, self_collision_max_per_cell=0,
                surface_collision=True, surface_thickness=0.02)


@pytest.mark.cuda
def test_contact_stage_same_bits_on_card(cuda_device):
    """The contact stages on the card give the same bits on every call
    (the surface stage's corner reactions are summed as integers), and
    agree with the CPU within 1e-6 m."""
    from softbodysim_torch.solver.contact import make_contact_stage

    topo = _contact_pair()
    params = sbt.SolverParams(**_CONTACT)
    rng = np.random.default_rng(1)
    x = (topo.vertices + rng.normal(0.0, 0.02, topo.vertices.shape)).astype(
        np.float32)
    w = sbt.init_state(topo, device="cpu").inv_mass
    cpu = make_contact_stage(topo, params, device="cpu")(
        torch.from_numpy(x), w)
    st = make_contact_stage(topo, params, device=cuda_device)
    xc, wc = torch.from_numpy(x).to(cuda_device), w.to(cuda_device)
    first = st(xc, wc)
    for _ in range(10):
        assert torch.equal(st(xc, wc), first)
    assert (cpu - torch.from_numpy(x)).abs().max() > 1e-3
    torch.testing.assert_close(first.cpu(), cpu, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dialect,backend", [
    ("xpbd", "gather"), ("xpbd", "sweep"), ("jacobi", "gather"),
    ("jacobi", "segment"), ("jacobi", "pass")])
def test_contact_steps_on_card_match_cpu(dialect, backend, cuda_device):
    """Two bodies that collide, contact on, each backend (the coloured and
    pass steps graphed on the card): 10 steps within 1e-4 m of the CPU, and
    a second card run equal bit for bit ('segment' included: it sums its
    constraint deltas in int64 fixed point, core/fixed.py)."""
    topo = _contact_pair()
    base = (dict(dialect="xpbd", substeps=2, iterations=3)
            if dialect == "xpbd" else
            dict(dialect="jacobi", substeps=2, iterations=4))
    params = sbt.SolverParams(**base, **_CONTACT,
                              **{f"{dialect}_backend": backend})
    a, b = (sbt.Engine(topo, params, device=cuda_device) for _ in range(2))
    cpu = sbt.Engine(topo, params, device="cpu")
    for _ in range(10):
        a.step(DT)
        b.step(DT)
        cpu.step(DT)
    np.testing.assert_allclose(a.positions(), cpu.positions(), rtol=0,
                               atol=1e-4)
    for f in ("x", "v", "edge_lambda", "tet_lambda"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


# --------------------------------------------------------------------------
# The accumulate-only passes, 'segment' bit for bit, the sharded steps
# --------------------------------------------------------------------------

def _accumulate_kit(family):
    return ((kj.edge_pass_plan, kj.jacobi_edge_accumulate,
             kj.jacobi_edge_accumulate_plain) if family == "edges"
            else (kj.tet_pass_plan, kj.jacobi_tet_accumulate,
                  kj.jacobi_tet_accumulate_plain))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["medium", "heavy"])
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_accumulate_kernels_match_plain_on_card(family, case, cuda_device):
    """The passes' accumulate-only mode: (delta, count) per row within
    1e-5 of the plain version (``edge_jacobi_deltas`` /
    ``tet_jacobi_deltas``), counts equal, 20 launches equal bit for bit,
    and the apply of its sums the apply pass's result within 1e-5; on
    tet_ball(5) too (the centre heavy: summed by the last CTA)."""
    make, fn, plain = _accumulate_kit(family)
    if case == "heavy":
        from test_torch_jacobi_tiles import fan_ball

        topo = fan_ball(5)
        rng = np.random.default_rng(5)
        V = topo.num_particles
        xin = torch.zeros((V, 4))
        xin[:, :3] = torch.from_numpy((topo.vertices + rng.normal(
            0.0, 0.01, (V, 3))).astype(np.float32))
        xin[:, 3] = torch.from_numpy(rng.uniform(0.5, 2.0, V).astype(
            np.float32))
        xin = xin.to(cuda_device)
        cons = topo.edges if family == "edges" else topo.tets
        rest = (np.linalg.norm(topo.vertices[cons[:, 0]]
                               - topo.vertices[cons[:, 1]], axis=1)
                if family == "edges" else np.full(len(cons), 1e-5))
    else:
        topo, xin, rng = _jacobi_table(SIZES["medium"], cuda_device, seed=6)
        cons, rest = ((topo.edges, topo.edge_rest) if family == "edges"
                      else (topo.tets, topo.tet_rest_vol))
    V = topo.num_particles
    plan = make(V, cons, np.asarray(rest, np.float32), device=cuda_device,
                vertices=topo.vertices)
    assert (len(plan.tiles.heavy) > 0) == (case == "heavy")
    got, want = torch.empty_like(xin), torch.empty_like(xin)
    before = fn.launches
    fn(plan, xin, got, 0.9)
    assert fn.launches == before + 1
    plain(plan, xin, want, 0.9)
    outs = torch.empty((20, V, 4), device=cuda_device)
    for i in range(20):
        fn(plan, xin, outs[i], 0.9)
    applied = torch.empty_like(xin)
    (kj.jacobi_edge_pass if family == "edges" else kj.jacobi_tet_pass)(
        plan, xin, applied, 0.9, 1.4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[:, :3], want[:, :3], rtol=0, atol=1e-5)
    assert torch.equal(got[:, 3], want[:, 3])
    assert got[:, :3].abs().max() > 1e-4
    assert torch.equal(outs, got.expand_as(outs))
    mine = kj.apply_delta(xin[:, :3], xin[:, 3], got[:, :3], got[:, 3], 1.4)
    torch.testing.assert_close(mine, applied[:, :3], rtol=0, atol=1e-5)
    assert plan.tiles.ticket.item() == 0


def test_fixed_sum_carries_values_it_cannot_hold():
    """``core/fixed.py::index_sum``: a row that takes a NaN, an infinity
    or a value of 2^23 or more sums to NaN in every column, as a float
    scatter would carry it; every other row is the exact sum of its
    values (here multiples of 2^-10, which the cut keeps whole)."""
    from softbodysim_torch.core.fixed import LIMIT, index_sum

    rng = np.random.default_rng(0)
    vals = (rng.integers(-4096, 4096, (40, 3)) / 1024.0).astype(np.float32)
    idx = rng.integers(0, 10, 40)
    idx[:4] = [3, 5, 7, 7]
    vals[0, 1], vals[1, 2], vals[2, 0] = np.nan, np.inf, LIMIT
    vals[3, 0] = -np.inf
    got = index_sum(10, ((torch.from_numpy(idx), torch.from_numpy(vals)),))
    bad = np.zeros(10, bool)
    bad[[3, 5, 7]] = True
    assert torch.isnan(got[bad]).all()
    want = np.zeros((10, 3))
    np.add.at(want, idx, vals.astype(np.float64))
    assert np.array_equal(got[~bad].numpy(), want[~bad].astype(np.float32))


@pytest.mark.parametrize("family", ["edges", "tets"])
def test_jacobi_deltas_carry_a_nan_through(family, monkeypatch):
    """A NaN position comes out of ``edge_jacobi_deltas`` /
    ``tet_jacobi_deltas`` (their int64 sums) as NaN on the rows where a
    float scatter-add of the same contributions gives NaN, and on no
    other row; the other rows are within 1e-6 of that scatter's, and
    where no constraint of the NaN vertex reaches, the same bits as
    without the NaN."""
    topo, xw, _ = _jacobi_table(4, "cpu")
    x, w = xw[:, :3].clone(), xw[:, 3]
    V = topo.num_particles
    if family == "edges":
        def deltas(pos):
            return kj.edge_jacobi_deltas(pos, w, torch.from_numpy(topo.edges),
                                         torch.from_numpy(topo.edge_rest),
                                         0.9, V)[0]
    else:
        def deltas(pos):
            return kj.tet_jacobi_deltas(pos, w, torch.from_numpy(topo.tets),
                                        torch.from_numpy(topo.tet_rest_vol),
                                        0.9, V)[0]

    def float_sum(n, parts):
        parts = list(parts)
        out = torch.zeros((n, parts[0][1].shape[1]))
        for index, values in parts:
            out.index_add_(0, index, values)
        return out

    clean = deltas(x)
    x[40, 1] = float("nan")
    got = deltas(x)
    monkeypatch.setattr(kj, "index_sum", float_sum)
    want = deltas(x)
    bad = torch.isnan(want).any(1)
    assert 0 < int(bad.sum()) < V
    assert torch.equal(torch.isnan(got).any(1), bad)
    assert torch.isnan(got[bad]).all()
    torch.testing.assert_close(got[~bad], want[~bad], rtol=0, atol=1e-6)
    cons = topo.edges if family == "edges" else topo.tets
    far = np.ones(V, bool)
    far[np.unique(cons[(cons == 40).any(1)])] = False
    assert torch.equal(got[far], clean[far])


@pytest.mark.cuda
def test_segment_step_repeats_its_bits_on_card(cuda_device):
    """'segment' sums in int64 fixed point: two card runs of 10 steps on
    the floor box are equal bit for bit, and within 1e-4 m of the CPU."""
    topo = sbt.meshes.tet_cube(6, 6, 6, size=0.5, center=(0.0, 0.45, 0.0))
    params = sbt.SolverParams(dialect="jacobi", substeps=2, iterations=4,
                              jacobi_backend="segment")
    runs = []
    for dev in (cuda_device, cuda_device, "cpu"):
        eng = sbt.Engine(topo, params, colliders=sbt.Colliders.build(
            [BOX], device=dev), device=dev)
        eng.run(10, DT)
        runs.append(eng.state)
    for f in ("x", "v"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
    torch.testing.assert_close(runs[0].x.cpu(), runs[2].x, rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
def test_sharded_steps_on_card(cuda_device, tmp_path):
    """The kernel-sharded steps on the card, from the rest shape with
    seeded velocities N(0, 0.5) m/s: world size 1 on NCCL in this process
    (xpbd bit for bit the single-device sweep step, jacobi within 1e-5 m
    of the single-device pass step), then two spawned ranks on a gloo
    group sharing the card (the same jacobi within 1e-5 m, both ranks the
    same bits).  Each run's constraint correction, over all rows and over
    the ghost windows' rows, is at least 10 times the 1e-5 m limit, so a
    dropped or doubled halo contribution would fail."""
    import torch.distributed as dist

    from softbodysim_torch.parallel import make_mesh, spawn

    import torch_sharded_ranks as tr

    cube = ("tet_cube", (8, 8, 8, 0.7, (0.0, 0.5, 0.0)))
    topo = tr._topology(cube)
    jac = dict(dialect="jacobi", substeps=2, iterations=3,
               jacobi_backend="pass")
    xp = dict(dialect="xpbd", substeps=2, iterations=2,
              xpbd_backend="sweep")
    seed, sigma, steps, need = 3, 0.5, 6, 10 * 1e-5
    single, free_move = {}, {}
    for name, kw in (("jacobi", jac), ("xpbd", xp)):
        e = sbt.Engine(topo, sbt.SolverParams(**kw), device=cuda_device)
        e.state = tr.kicked(e, seed, sigma)
        free_move[name] = tr.ballistic(e.state, e.params, steps)
        e.run(steps, DT)
        single[name] = e.positions()
        assert np.abs(single[name] - free_move[name]).max() >= need
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        for name, kw in (("jacobi", jac), ("xpbd", xp)):
            e = sbt.Engine(topo, sbt.SolverParams(**kw), mesh=mesh,
                           device=cuda_device)
            e.state = tr.kicked(e, seed, sigma)
            e.run(steps, DT)
            if name == "xpbd":
                assert np.array_equal(e.positions(), single[name])
            else:
                np.testing.assert_allclose(e.positions(), single[name],
                                           rtol=0, atol=1e-5)
    finally:
        dist.destroy_process_group()
    res = spawn(tr.run_cuda_engine, 2, cube, jac, steps, seed, sigma,
                backend="gloo", timeout_s=300.0)
    assert np.array_equal(res[0]["x"], res[1]["x"])
    np.testing.assert_allclose(res[0]["x"], single["jacobi"], rtol=0,
                               atol=1e-5)
    halo = res[0]["halo"]
    assert len(halo) > 0
    assert np.abs(res[0]["x"] - free_move["jacobi"])[halo].max() >= need


# --------------------------------------------------------------------------
# Several host threads (server sessions): capture tallies, concurrent graph
# captures, sweep timeouts reported to their own plan
# --------------------------------------------------------------------------

def test_capture_tallies_are_per_thread(monkeypatch):
    """Each thread's launches while it captures go to its own innermost
    tally, whatever another thread captures at the same time; counts
    outside a capture are not lost under contention (8 threads, a short
    switch interval)."""
    import sys
    import threading

    from softbodysim_torch import kernels

    def fake():
        pass

    fake.launches = 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    inside = threading.Barrier(2)
    tallies, errors = {}, []

    def capture(n):
        try:
            with kernels.capture_tally() as tally:
                inside.wait(timeout=30)       # both captures open at once
                for _ in range(n):
                    kernels.count_launch(fake)
                inside.wait(timeout=30)
                tallies[n] = dict(tally)
            assert kernels._captures() == []
        except Exception as e:                # reported below
            errors.append(e)

    threads = [threading.Thread(target=capture, args=(n,)) for n in (3, 7)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert not errors, errors
    assert tallies == {3: {"fake": 3}, 7: {"fake": 7}}
    assert fake.launches == 0

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [kernels.count_launch(fake) for _ in range(2000)])
            for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert fake.launches == 8 * 2000


@pytest.mark.cuda
def test_two_threads_capture_the_coloured_step_at_once(cuda_device):
    """Two threads step their own coloured Engines (a box collider, so the
    collide kernel runs inside the graph), their first steps -- the
    captures -- at once and with no lock between them: each equals its
    solo run bit for bit, and the launch counts are the two solo runs'
    (3 and 6 steps, so tallies swapped between the captures would
    show)."""
    import threading

    from softbodysim_torch.kernels import launch_counts, reset_launch_counts

    box = sbt.Colliders.box((0.0, 0.05, 0.0), (1.0, 0.05, 1.0))
    cases = {3: sbt.meshes.tet_cube(3, 3, 3, size=0.5,
                                    center=(0.0, 0.35, 0.0)),
             6: sbt.meshes.tet_cube(4, 3, 3, size=0.5,
                                    center=(0.0, 0.4, 0.0))}
    params = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=3,
                              xpbd_backend="gather")

    def engine(topo):
        return sbt.Engine(topo, params, colliders=sbt.Colliders.build(
            [box], device=cuda_device), device=cuda_device)

    solo, solo_counts = {}, {}
    for n, topo in cases.items():
        reset_launch_counts()
        eng = engine(topo)
        for _ in range(n):
            eng.step(DT)
        torch.cuda.synchronize()
        solo[n], solo_counts[n] = eng.state, launch_counts()
    assert solo_counts[3]["collide"] > 0

    engines = {n: engine(topo) for n, topo in cases.items()}
    torch.cuda.synchronize()
    reset_launch_counts()
    start = threading.Barrier(2)
    errors = []

    def run(n):
        try:
            start.wait(timeout=60)
            for _ in range(n):
                engines[n].step(DT)
            torch.cuda.current_stream(cuda_device).synchronize()
        except Exception as e:                # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(n,)) for n in cases]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    assert not errors, errors
    torch.cuda.synchronize()
    for n in cases:
        for f in ("x", "v", "edge_lambda", "tet_lambda"):
            assert torch.equal(getattr(engines[n].state, f),
                               getattr(solo[n], f)), (n, f)
    assert launch_counts() == {k: solo_counts[3][k] + solo_counts[6][k]
                               for k in solo_counts[3]}


@pytest.mark.cuda
def test_sweep_timeout_is_reported_to_its_own_plan(cuda_device):
    """A launch of one queue of plan A's schedule -- a queue that waits for
    blocks of other queues, which never run -- aborts after 2 s and sets
    A's word (pinned host memory the kernel writes).  Plan B, launched
    after it on the same stream, reports nothing; A's next check raises
    once."""
    topo = sbt.meshes.tet_cube(20, 20, 20, size=1.0, center=(0.0, 0.8, 0.0))
    cons = topo.edges.astype(np.int64)
    g = tsp.build_gpu_plan(
        tsp.pack_superblocks(cons, topo.edge_rest, layer_cap=2), cons,
        scheme="split", omega=1.5)
    a, b = (ksw.to_device(g, cuda_device) for _ in range(2))
    assert a.staged.queues > 1
    V = topo.num_particles
    xw = torch.zeros((-(-V // tsp.LANES) * tsp.LANES, 4))
    xw[:V, :3] = torch.from_numpy(topo.vertices)
    xw[:V, 3] = sbt.init_state(topo, device="cpu").inv_mass
    xw = xw.to(cuda_device)
    wt = ksw.w_fill(a, xw)
    sched = tsp.build_schedule(g, a.staged.capacity)
    assert sched.queues == a.staged.queues
    q = next(q for q in range(sched.queues)
             if sched.wptr[sched.qptr[q + 1]] > sched.wptr[sched.qptr[q]])
    a.staged.qptr = torch.tensor(sched.qptr[q:q + 2], dtype=torch.int32,
                                 device=cuda_device)
    a.staged.queues = 1
    ksw.edge_sweep(a, xw.clone(), torch.zeros(g.num_blocks * g.width,
                                              device=cuda_device),
                   wt, 1e-2, 1)
    ksw.edge_sweep(b, xw.clone(), torch.zeros(g.num_blocks * g.width,
                                              device=cuda_device),
                   wt, 1e-2, 1)
    torch.cuda.synchronize()
    ksw.raise_on_timeouts(b.staged)
    with pytest.raises(RuntimeError, match="timed out"):
        ksw.raise_on_timeouts(a.staged)
    ksw.raise_on_timeouts()                   # read and reset: none left


# ---- gradients: the collide Function and the steps that refuse grad ------


def _collide_inputs(device, seed=11, v=2000):
    """A (V, 4) table over the three colliders and the ground plane, some
    rows pinned, and the packed table."""
    rng = np.random.default_rng(seed)
    xw = torch.from_numpy(np.concatenate([
        rng.uniform((-0.8, -0.1, -0.8), (0.8, 0.7, 0.8), (v, 3)),
        rng.uniform(0.5, 2.0, (v, 1))], 1).astype(np.float32))
    xw[::7, 3] = 0.0
    packed, ground = _three_colliders(device)
    return xw.to(device), packed, ground


def _plain_vjp(xw, packed, ground, cot):
    """Autograd through collide_plain on the table of (p, w) = xw's
    columns: (positions, d/dp, d/dpacked) of sum(positions * cot)."""
    pi = xw[:, :3].clone().requires_grad_(True)
    qi = packed.detach().clone().requires_grad_(True)
    out = kc.collide_plain(torch.cat([pi, xw[:, 3:]], 1), qi, ground)[:, :3]
    return (out,) + torch.autograd.grad(out, (pi, qi), cot)


def test_collide_plain_is_out_of_place():
    xw, packed, ground = _collide_inputs("cpu")
    before = xw.clone()
    out = kc.collide_plain(xw, packed, ground)
    assert torch.equal(xw, before) and (out - xw).abs().max() > 1e-2
    assert torch.equal(out[:, 3], xw[:, 3])
    assert torch.equal(kc.collide(xw.clone(), packed, ground), out)


def test_collide_function_gradient_on_cpu():
    """On the CPU the Function's forward is the plain version and its
    backward autograd through it: the same bits both ways; the pinned
    rows pass their gradient through."""
    xw, packed, ground = _collide_inputs("cpu")
    cot = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (xw.shape[0], 3)).astype(np.float32))
    want, gx, gp = _plain_vjp(xw, packed, ground, cot)
    xi = xw[:, :3].clone().requires_grad_(True)
    pi = packed.clone().requires_grad_(True)
    before = kc.collide.launches
    out = kc.collide_positions(xi, xw[:, 3], pi, ground)
    assert kc.collide.launches == before                  # plain on CPU
    got = torch.autograd.grad(out, (xi, pi), cot)
    assert torch.equal(out.detach(), want.detach())
    assert torch.equal(got[0], gx) and torch.equal(got[1], gp)
    pinned = xw[:, 3] == 0
    assert torch.equal(got[0][pinned], cot[pinned])
    assert gp.abs().max() > 0


def _refusing_steps(device):
    """The kernel backends ('sweep', legacy 128-wide, 'pass') and the
    coloured step's graphed build, on a small cube."""
    topo = sbt.meshes.tet_cube(3, 3, 3, size=0.5, center=(0.0, 0.4, 0.0))
    box = sbt.Colliders.build([sbt.Colliders.box((0, 0.05, 0),
                                                 (1, 0.05, 1))],
                              device=device)
    xp = sbt.SolverParams(substeps=2, iterations=1)
    jp = sbt.SolverParams(dialect="jacobi", substeps=2, iterations=2)
    steps = {
        "sweep": sbt.make_step(topo, xp.replace(xpbd_backend="sweep"),
                               device=device),
        "legacy": sbt.make_step(topo, xp.replace(xpbd_backend="sweep"),
                                device=device, superblocks=False),
        "pass": sbt.make_step(topo, jp.replace(jacobi_backend="pass"),
                              colliders=box, device=device),
        "coloured": sbt.make_step(topo, xp.replace(xpbd_backend="gather"),
                                  device=device)}
    return topo, steps


REFUSING = ["sweep", "legacy", "pass", "coloured"]


def _check_refusal(step, topo, device):
    s0 = sbt.init_state(topo, device=device)
    v = s0.v.clone().requires_grad_(True)
    grad_state = dataclasses.replace(s0, v=v)
    with pytest.raises(RuntimeError, match="diff.make_rollout"):
        step(grad_state, DT)
    knob = ("edge_compliance" if step.params.dialect == "xpbd"
            else "edge_stiffness")
    with pytest.raises(RuntimeError, match="requires grad"):
        step(s0, DT, **{knob: torch.tensor(0.5, device=device,
                                           requires_grad=True)})
    with torch.no_grad():                       # not under grad: it steps
        out = step(grad_state, DT)
    assert torch.isfinite(out.x).all()
    assert torch.equal(step(s0, DT).x, out.x)


def _check_jacobi_grad(device, backend):
    """The jacobi plain step as ``make_step`` builds it, on the box
    collider: stepped under autograd it gives what it gives under
    torch.no_grad() -- the same bits (both backends repeat their own on
    either device; 'segment' sums in int64 fixed point) -- with the collide
    kernel launched once per iteration on the card (none on the CPU),
    and a finite, nonzero gradient w.r.t. the stiffness, omega and the
    initial velocity."""
    topo = sbt.meshes.tet_cube(3, 3, 3, size=0.5, center=(0.0, 0.4, 0.0))
    box = sbt.Colliders.build([sbt.Colliders.box((0, 0.05, 0),
                                                 (1, 0.05, 1))],
                              device=device)
    p = sbt.SolverParams(dialect="jacobi", substeps=2, iterations=2,
                         jacobi_backend=backend)
    step = sbt.make_step(topo, p, colliders=box, device=device)
    s0 = sbt.init_state(topo, device=device)
    s0 = dataclasses.replace(s0, v=torch.full_like(s0.v, -3.0))
    with torch.no_grad():
        want = step.step_n(s0, DT, 3).x
    k, om = (torch.tensor(a, device=device, requires_grad=True)
             for a in (0.7, 1.3))
    v = s0.v.clone().requires_grad_(True)
    before = kc.collide.launches
    out = step.step_n(dataclasses.replace(s0, v=v), DT, 3,
                      edge_stiffness=k, sor_omega=om).x
    launched = kc.collide.launches - before
    assert launched == (3 * 2 * 2 if str(device) != "cpu" else 0)
    with torch.no_grad():
        again = step.step_n(s0, DT, 3, edge_stiffness=0.7, sor_omega=1.3).x
    assert torch.equal(out.detach(), again)
    assert (want - again).abs().max() > 1e-4    # the overrides are read
    grads = torch.autograd.grad(out[:, 1].sum(), (k, om, v))
    for g in grads:
        assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("backend", ["segment", "gather"])
def test_jacobi_plain_steps_differentiate_on_cpu(backend):
    _check_jacobi_grad("cpu", backend)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["segment", "gather"])
def test_jacobi_plain_steps_differentiate_on_card(backend, cuda_device):
    _check_jacobi_grad(cuda_device, backend)


@pytest.mark.parametrize("backend", REFUSING)
def test_kernel_steps_refuse_grad_on_cpu(backend):
    """Each step autograd cannot follow raises when handed a tensor that
    requires grad (on the CPU through its plain versions), and steps as
    before under torch.no_grad()."""
    topo, steps = _refusing_steps("cpu")
    _check_refusal(steps[backend], topo, "cpu")


@pytest.mark.cuda
def test_collide_function_gradient_on_card(cuda_device):
    """On the card the Function's forward is the kernel (one launch, into
    a fresh table, within 1e-6 of the plain version) and its gradient is
    autograd through collide_plain on the same inputs, bit for bit."""
    xw, packed, ground = _collide_inputs(cuda_device)
    cot = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (xw.shape[0], 3)).astype(np.float32)).to(cuda_device)
    want, gx, gp = _plain_vjp(xw, packed, ground, cot)
    xi = xw[:, :3].clone().requires_grad_(True)
    pi = packed.clone().requires_grad_(True)
    before = kc.collide.launches
    out = kc.collide_positions(xi, xw[:, 3], pi, ground)
    assert kc.collide.launches == before + 1
    assert torch.equal(xi.detach(), xw[:, :3])           # not in place
    got = torch.autograd.grad(out, (xi, pi), cot)
    torch.testing.assert_close(out.detach(), want.detach(), rtol=0,
                               atol=1e-6)
    assert torch.equal(got[0], gx) and torch.equal(got[1], gp)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", REFUSING)
def test_kernel_steps_refuse_grad_on_card(backend, cuda_device):
    topo, steps = _refusing_steps(cuda_device)
    _check_refusal(steps[backend], topo, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dialect", ["xpbd", "jacobi"])
def test_diff_rollout_on_card_matches_cpu(dialect, cuda_device):
    """A differentiable rollout thrown onto a box collider (the collide
    kernel in the forward) on the card against the CPU: trajectory
    1e-4 m; the gradients of sum(trajectory * W) w.r.t. the edge
    compliance (where alpha is twice the median inverse mass: the
    trajectory is sensitive to it) or stiffness and the initial velocity
    1e-3 of their largest component."""
    from softbodysim_torch import diff

    topo = sbt.meshes.tet_cube(3, 3, 3, size=0.5, center=(0.0, 0.4, 0.0))
    knob = "edge_compliance" if dialect == "xpbd" else "edge_stiffness"
    params = sbt.SolverParams(dialect=dialect, substeps=2, iterations=2)
    w0 = sbt.init_state(topo, device="cpu").inv_mass
    value = (float(2.0 * w0.median() * (DT / 2) ** 2) if dialect == "xpbd"
             else 0.5)
    weights = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, topo.num_particles, 3)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda_device):
        box = sbt.Colliders.build([sbt.Colliders.box((0, 0.05, 0),
                                                     (1, 0.05, 1))],
                                  device=dev)
        r = diff.make_rollout(topo, params, dt=DT, nsteps=4, colliders=box,
                              device=dev)
        k = torch.tensor(value, device=dev, requires_grad=True)
        s0 = sbt.init_state(topo, device=dev)
        v = torch.full_like(s0.v, -2.0).requires_grad_(True)
        before = kc.collide.launches
        tr = r(dataclasses.replace(s0, v=v), {knob: k})
        grads = torch.autograd.grad((tr * weights.to(dev)).sum(), (k, v))
        if dev != "cpu":
            assert kc.collide.launches > before
        out[str(dev)] = [tr.detach().cpu()] + [g.cpu() for g in grads]
    (a, *ga), (b, *gb) = out.values()
    torch.testing.assert_close(b, a, rtol=0, atol=1e-4)
    for x, y in zip(gb, ga):
        assert (x - y).abs().max() <= 1e-3 * y.abs().max()
