"""The bfloat16 particle table (``SolverParams.xpbd_x_dtype="bfloat16"``)
of the port against the JAX package's, on the CPU (the plain versions of
the sweep and collide kernels; the kernels themselves are held against
them on the card in test_torch_kernels.py):

- the plain w fill equals the JAX interpret-mode ``_w_fill_kernel``;
- one edge and one tet sweep (split scheme, tet_cube(4)) against
  ``make_sweep(..., x_dtype=jnp.bfloat16, interpret=True)``;
- the slice: Engine on the sweep backend against
  ``make_xpbd_pallas_step(..., xpbd_x_dtype="bfloat16", interpret=True)``,
  tet_cube(3) partly inside a sphere collider, 2 steps;
- the port's bf16 run against its f32 run under the JAX test's own
  physical bound (tests/test_pallas_sweep.py::
  test_bf16_x_table_tolerance_bound);
- the legacy 128-wide path refuses the bf16 table; the kernel-sharded
  step ignores the knob, as the JAX sharded step does.

Tolerances are in bf16 ulps of the coordinate (2^-7 of the power of two
at or below |x|: 0.0078 m at |x| in [1, 2)), never the f32 ones.  The
port sums a row's corrections in CSR order, the JAX kernel by sublane; in
f32 the two differ by ULPs, which at a bf16 rounding boundary become one
bf16 ulp that later blocks read.  So positions: within 1 bf16 ulp, and at
least 90% of the rows bit-equal; lambdas: within 1e-5 of the largest
|lambda| for one sweep (f32 ULPs), 1e-4 over the slice's 2 steps.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysim_tpu import SolverParams as JParams
from softbodysim_tpu.collide import primitives as jprim
from softbodysim_tpu.core import meshes as jmeshes
from softbodysim_tpu.core.state import init_state as j_init_state
from softbodysim_tpu.kernels import sweep as jsw
from softbodysim_tpu.solver.xpbd_pallas import make_xpbd_pallas_step

import softbodysim_torch as sbt
from softbodysim_torch.core.state import init_state
from softbodysim_torch.io.from_jax import (colliders_from_numpy,
                                           params_from_fields,
                                           state_from_numpy, state_to_numpy)
from softbodysim_torch.kernels import sweep as ksw
from softbodysim_torch.kernels import sweep_plan as tsp
from softbodysim_torch.solver.xpbd_sweep import SweepStep

DT = 1.0 / 60.0
SDT = np.float32(DT) / np.float32(2)
COMPLIANCE = 5e-4
SPLIT = {"edges": ("split", 1.5), "tets": ("split", 2.2)}
ROWS_EQUAL = 0.9
CUBE3 = dict(nx=3, ny=3, nz=3, size=0.5, center=(0.0, 0.6, 0.0))
CUBE4 = dict(nx=4, ny=4, nz=4, size=0.5, center=(0.0, 0.6, 0.0))


def bf16_ulp(x):
    """One bf16 ulp of each coordinate's magnitude (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def assert_within_ulps(got, want, label):
    """Coordinates within 1 bf16 ulp, at least ROWS_EQUAL of the rows
    bit-equal."""
    ref = np.maximum(np.abs(got), np.abs(want))
    excess = np.abs(got - want) / bf16_ulp(ref)
    equal = float((got == want).all(axis=1).mean())
    assert excess.max() <= 1.0, (label, excess.max())
    assert equal >= ROWS_EQUAL, (label, equal)


@functools.lru_cache(maxsize=None)
def _scene():
    """tet_cube(4): a perturbed predicted state with two pinned vertices
    and nonzero starting lambdas (public order)."""
    topo = sbt.meshes.tet_cube(4, 4, 4, size=1.0, center=(0.0, 0.8, 0.0))
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


def _alpha(family):
    return (float(np.float32(COMPLIANCE) * (np.float32(1.0) / (SDT * SDT)))
            if family == "edges" else 0.0)


@functools.lru_cache(maxsize=None)
def _port(family):
    """One plain bf16 sweep of the port: (w table in public order,
    positions, lambdas in public order)."""
    topo, x, w, lam = _scene()
    cons, rest, lcap = _family(topo, family)
    sch, omega = SPLIT[family]
    V = topo.num_particles
    nwin = -(-V // tsp.LANES)
    g = tsp.build_gpu_plan(tsp.pack_superblocks(cons, rest, layer_cap=lcap),
                           cons, scheme=sch, omega=omega)
    dplan = ksw.to_device(g, "cpu")
    xw = torch.zeros((nwin * tsp.LANES, 4))
    xw[:V, :3] = torch.from_numpy(x)
    xw[:V, 3] = torch.from_numpy(w)
    xw = xw.to(torch.bfloat16)
    lam_p = torch.zeros(g.num_blocks * tsp.BLOCK)
    lam_p[torch.from_numpy(g.pos_of)] = torch.from_numpy(lam[family])
    wtab = ksw.w_fill(dplan, xw)
    fn = ksw.edge_sweep if family == "edges" else ksw.tet_sweep
    fn(dplan, xw, lam_p, wtab, _alpha(family), 1)
    assert xw.dtype == torch.bfloat16
    return (wtab.numpy()[g.pos_of], xw[:V, :3].float().numpy(),
            lam_p[torch.from_numpy(g.pos_of)].numpy())


@functools.lru_cache(maxsize=None)
def _jax(family):
    """The same sweep on the JAX package's bf16 kernels in interpret
    mode: (w table in public order, positions, lambdas in public
    order)."""
    topo, x, w, lam = _scene()
    cons, rest, lcap = _family(topo, family)
    sch, omega = SPLIT[family]
    V = topo.num_particles
    nwin = -(-V // jsw.LANES)
    plan = jsw.pack_superblocks(cons, rest, nwin, layer_cap=lcap)
    sweep = jsw.make_sweep(plan, nwin, interpret=True, scheme=sch,
                           omega=omega, x_dtype=jnp.bfloat16)
    x8 = np.zeros((8, nwin * jsw.LANES), np.float32)
    x8[0:3, :V] = x.T
    x8[3, :V] = w

    @jax.jit
    def run(x8, lam_packed):
        tables = sweep.fill_w(x8, sweep.tables)
        return sweep(x8, lam_packed, jnp.float32(_alpha(family)),
                     tables), tables[-1]

    (x8_out, lam_out), wtab = run(
        jnp.asarray(x8, jnp.bfloat16),
        jsw.split_lambda(plan, jsw.pack_lambda(plan,
                                               jnp.asarray(lam[family]))))
    assert x8_out.dtype == jnp.bfloat16
    wtab = np.asarray(wtab)
    if family == "tets":          # (nb*32, 128): per block 4 roles x 1024
        wtab = wtab.reshape(-1, 4, tsp.BLOCK).transpose(0, 2, 1)
    return ((wtab.reshape(-1) if family == "edges"
             else wtab.reshape(-1, 4))[plan.pos_of],
            np.asarray(x8_out.astype(jnp.float32))[0:3, :V].T,
            np.asarray(jsw.unpack_lambda(plan,
                                         jsw.join_lambda(plan, lam_out))))


@pytest.mark.parametrize("family", ["edges", "tets"])
def test_plain_w_fill_matches_jax_interpret(family):
    np.testing.assert_array_equal(_port(family)[0], _jax(family)[0])


@pytest.mark.parametrize("family", ["edges", "tets"])
def test_plain_sweep_matches_jax_interpret(family):
    _, x, lam = _port(family)
    _, x_ref, lam_ref = _jax(family)
    assert not np.array_equal(x, _scene()[1])      # the sweep moved rows
    assert_within_ulps(x, x_ref, f"{family} positions")
    np.testing.assert_allclose(lam, lam_ref, rtol=0,
                               atol=1e-5 * np.abs(lam_ref).max())


def test_slice_matches_jax_interpret():
    """Engine (sweep backend, bf16 table, a sphere collider the cube
    starts in) against the JAX Pallas step: x, x_star within 1 bf16 ulp,
    v within 1 bf16 ulp of the coordinate per substep dt, lambdas 1e-4 of
    the largest."""
    item = jprim.Colliders.sphere((0.22, 0.33, 0.21), 0.12)
    jcols = jprim.Colliders.build([item])
    jparams = JParams(dialect="xpbd", substeps=2, iterations=3,
                      xpbd_x_dtype="bfloat16")
    jstep = make_xpbd_pallas_step(jmeshes.tet_cube(**CUBE3), jparams,
                                  jcols, interpret=True)
    jstate = j_init_state(jmeshes.tet_cube(**CUBE3))
    start = {f.name: np.asarray(getattr(jstate, f.name))
             for f in dataclasses.fields(jstate)}
    jstate = jstep.step_n(jstate, DT, 2)

    cols = colliders_from_numpy(
        {k: np.asarray(getattr(jcols, k)) for k in
         ("type", "position", "rotation", "data", "active")}, "cpu")
    params = params_from_fields(jparams).replace(xpbd_backend="sweep")
    eng = sbt.Engine(sbt.meshes.tet_cube(**CUBE3), params, colliders=cols,
                     device="cpu")
    eng.state = state_from_numpy(start, "cpu")
    eng.run(2, DT)
    assert eng._carry.xw.dtype == torch.bfloat16
    got = state_to_numpy(eng.state)
    want = {f: np.asarray(getattr(jstate, f)) for f in got}
    assert np.abs(got["x"] - start["x"]).max() > 0.01   # pushed out
    for f in ("x", "x_star"):
        assert_within_ulps(got[f], want[f], f)
    assert_within_ulps(got["v"] * float(SDT), want["v"] * float(SDT), "v")
    for f in ("edge_lambda", "tet_lambda"):
        np.testing.assert_allclose(got[f], want[f], rtol=0,
                                   atol=1e-4 * np.abs(want[f]).max(),
                                   err_msg=f)


def test_bf16_tracks_f32_within_the_jax_bound():
    """The JAX package's own bound on the bf16 table: after 6 steps the
    positions stay within 0.05 m of the f32 run and the rounding shows
    (more than 1e-7 m)."""
    topo = sbt.meshes.tet_cube(**CUBE4)
    params = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=3,
                              xpbd_backend="sweep")
    a = sbt.Engine(topo, params, device="cpu").run(6, DT)
    b = sbt.Engine(topo, params.replace(xpbd_x_dtype="bfloat16"),
                   device="cpu").run(6, DT)
    xa, xb = a.positions(), b.positions()
    assert np.isfinite(xb).all()
    assert np.abs(xb - xa).max() < 0.05
    assert np.abs(xb - xa).max() > 1e-7
    assert b.state.x_star.dtype == torch.float32


def test_legacy_path_refuses_bf16():
    topo = sbt.meshes.tet_cube(**CUBE4)
    params = sbt.SolverParams(dialect="xpbd", xpbd_backend="sweep",
                              xpbd_x_dtype="bfloat16")
    with pytest.raises(ValueError, match="float32"):
        sbt.Engine(topo, params, device="cpu", superblocks=False)
    with pytest.raises(ValueError, match="xpbd_x_dtype"):
        sbt.Engine(topo, params.replace(xpbd_x_dtype="float16"),
                   device="cpu")
    step = SweepStep(topo, params.replace(xpbd_x_dtype="float32"),
                     device="cpu", superblocks=False)
    xw = step.pack_state(init_state(topo, device="cpu")).xw
    for fam, fn in (("edges", ksw.legacy_edge_sweep),
                    ("tets", ksw.legacy_tet_sweep)):
        plan = step.device_plans[fam]
        lam = torch.zeros(plan.num_blocks * plan.width)
        with pytest.raises(TypeError, match="bfloat16"):
            fn(plan, xw.to(torch.bfloat16), lam, 0.0)


def test_sharded_step_ignores_the_knob(tmp_path):
    """On a gloo group of one the kernel-sharded step with the bf16 knob
    gives the f32 sharded step's bits (its table is f32, as the JAX
    sharded step's)."""
    import torch.distributed as dist

    from softbodysim_torch.parallel import make_mesh

    topo = sbt.meshes.tet_cube(**CUBE4)
    params = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=3,
                              xpbd_backend="sweep")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        a = sbt.Engine(topo, params, device="cpu", mesh=mesh).run(3, DT)
        b = sbt.Engine(topo, params.replace(xpbd_x_dtype="bfloat16"),
                       device="cpu", mesh=mesh).run(3, DT)
        for f in ("x", "v", "x_star", "edge_lambda", "tet_lambda"):
            assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
        with pytest.raises(ValueError, match="xpbd_x_dtype"):
            sbt.Engine(topo, params.replace(xpbd_x_dtype="float16"),
                       device="cpu", mesh=mesh)
    finally:
        dist.destroy_process_group()
