"""The port's Jacobi dialect on the CPU against the JAX package and the NumPy
oracle: the adjacency builders (array-equal), the pass kernels' plain
versions against the JAX segment math, and the 'segment', 'gather' and
'pass' steps against ``JacobiOracle`` and the JAX ``make_jacobi_step``
('gather' and 'segment') on a cube falling onto a box collider.

Tolerances: one pass from one snapshot within 1e-6 m (fp32 summation order
only); whole steps within 1e-4 m over 10 steps (the oracle parity
contract).  The JAX Pallas passes are not run here: the JAX suite holds
them to its gather backend (tests/test_jacobi_pallas.py), which is the
reference here.
"""

import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

import softbodysim_tpu as sbs
from softbodysim_tpu.core import adjacency as jadj
from softbodysim_tpu.core.state import init_state as j_init_state
from softbodysim_tpu.solver import jacobi as jjac

import softbodysim_torch as sbt
from softbodysim_torch.core import adjacency as tadj
from softbodysim_torch.core.topology import ColorGroups, Topology
from softbodysim_torch.io.from_jax import state_from_numpy
from softbodysim_torch.kernels import collide as kc
from softbodysim_torch.kernels import jacobi as kj
from softbodysim_torch.kernels import jacobi_plan as jp
from softbodysim_torch.solver import jacobi_pass as jpass
from softbodysim_torch.solver.select import resolve_backend

from oracle import JacobiOracle
from test_torch_jacobi_tiles import fan_ball

DT = 1.0 / 60.0
STEPS = 10
TOL = 1e-4
CUBE = dict(nx=2, ny=2, nz=2, size=0.5, center=(0.0, 0.55, 0.0))
BOX = dict(type=1, position=(0.0, 0.1, 0.0), data=(0.6, 0.1, 0.6))
MOVED_BOX = dict(BOX, position=(0.15, 0.12, 0.0))
BACKENDS = ["segment", "gather", "pass", "pallas"]


def _params(mod=sbt, **kw):
    base = dict(dialect="jacobi", substeps=2, iterations=6,
                edge_stiffness=0.9, volume_stiffness=0.98, sor_omega=1.4,
                particle_radius=0.02, gravity=(0.0, -10.0, 0.0))
    return mod.SolverParams(**{**base, **kw})


def _engine(topo, backend, items=(BOX,), **kw):
    cols = sbt.Colliders.build(list(items), device="cpu") if items else None
    return sbt.Engine(topo, _params(jacobi_backend=backend,
                                    **kw.pop("params", {})),
                      colliders=cols, device="cpu", **kw)


def _jax_run(jtopo, backend, steps=STEPS, items=(BOX,), params=None,
             pinned=None, **kw):
    """The JAX make_jacobi_step, jitted, from init_state (density masses):
    its final positions."""
    p = _params(sbs, jacobi_backend=backend, **(params or {}))
    cols = sbs.Colliders.build(list(items)) if items else None
    step = jax.jit(jjac.make_jacobi_step(jtopo, p, colliders=cols, **kw))
    s = j_init_state(jtopo, inv_mass_mode="density", pinned=pinned)
    for _ in range(steps):
        s = step(s, DT)
    return np.asarray(s.x)


# The JAX references, computed once per process and shared by the
# parametrized cases (each is a jit compile of about a second).
_CHEB = dict(chebyshev=True, chebyshev_rho=0.9, chebyshev_delay=2)
_ROT = np.array([[np.cos(0.3), 0, np.sin(0.3), 0.05], [0, 1, 0, 0.1],
                 [-np.sin(0.3), 0, np.cos(0.3), 0.0], [0, 0, 0, 1]],
                np.float32)
_TRANSFORMS = dict(local_to_world=_ROT,
                   world_to_local=np.linalg.inv(_ROT).astype(np.float32))


def _stiffness_tables():
    topo = sbt.meshes.tet_cube(**CUBE)
    rng = np.random.default_rng(12)
    return dict(
        edge_k=rng.uniform(0.3, 1.0, topo.num_edges).astype(np.float32),
        tet_k=rng.uniform(0.5, 1.0, topo.num_tets).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_reference(case):
    cube = sbs.meshes.tet_cube(**CUBE)
    if case == "chebyshev":
        return _jax_run(cube, "gather", params=_CHEB)
    if case == "transforms":
        return _jax_run(cube, "gather", **_TRANSFORMS)
    if case == "per_k":
        return _jax_run(cube, "gather", steps=6, **_stiffness_tables())
    if case == "cloth":
        jtopo, pinned = sbs.meshes.cloth_patch(6, 6)
        return _jax_run(jtopo, "gather", items=(),
                        params=dict(ground_enabled=False), pinned=pinned)
    if case == "moving_box":
        jeng = sbs.Engine(cube, _params(sbs, jacobi_backend="gather"),
                          colliders=sbs.Colliders.build([BOX]))
        out = []
        for cols in ([BOX], [MOVED_BOX]):
            jeng.update_colliders(sbs.Colliders.build(cols))
            for _ in range(8):
                jeng.step(DT)
            out.append(jeng.positions())
        return out
    raise ValueError(case)


@functools.lru_cache(maxsize=None)
def _reference():
    """(oracle x, oracle v, JAX gather x, JAX segment x) after 10 steps."""
    topo = sbt.meshes.tet_cube(**CUBE)
    oracle = JacobiOracle(topo, _params(), colliders=[BOX])
    for _ in range(STEPS):
        oracle.step(DT)
    jtopo = sbs.meshes.tet_cube(**CUBE)
    jx = {b: _jax_run(jtopo, b) for b in ("gather", "segment")}
    return oracle.x.copy(), oracle.v.copy(), jx


# --------------------------------------------------------------------------
# core/adjacency.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["cube", "ball"])
def test_adjacency_array_equal(mesh):
    topo = (sbs.meshes.tet_cube(3, 4, 2) if mesh == "cube"
            else sbs.meshes.tet_ball(1, 0.3))
    nv = topo.num_particles

    def same(a, b):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert np.asarray(x).dtype == np.asarray(y).dtype

    for fn, cons in (("build_edge_adjacency", topo.edges),
                     ("build_tet_adjacency", topo.tets),
                     ("padded_edge_adjacency", topo.edges),
                     ("padded_tet_adjacency", topo.tets)):
        same(getattr(tadj, fn)(nv, cons), getattr(jadj, fn)(nv, cons))
    off, other, eidx = jadj.build_edge_adjacency(nv, topo.edges)
    same(tadj.csr_to_padded(off, other, eidx),
         jadj.csr_to_padded(off, other, eidx))
    _, _, mask = jadj.padded_tet_adjacency(nv, topo.tets)
    deg = mask.sum(1)
    assert tadj.degree_buckets(deg) == jadj.degree_buckets(deg)
    caps = jadj.degree_buckets(deg)
    tb, tpos = tadj.bucket_vertices(deg, caps)
    jb, jpos = jadj.bucket_vertices(deg, caps)
    same(tb, jb)
    np.testing.assert_array_equal(tpos, jpos)
    tid, role, mask = jadj.padded_tet_adjacency(nv, topo.tets)
    tout, tpos = tadj.bucketize_padded([tid, role], mask, deg)
    jout, jpos = jadj.bucketize_padded([tid, role], mask, deg)
    np.testing.assert_array_equal(tpos, jpos)
    assert len(tout) == len(jout)
    for (tv, ta, tm), (jv, ja, jm) in zip(tout, jout):
        same([tv, tm, *ta], [jv, jm, *ja])


def test_adjacency_empty_and_degenerate():
    for fn in ("padded_edge_adjacency", "padded_tet_adjacency"):
        empty = np.zeros((0, 2 if "edge" in fn else 4), np.int64)
        for a, b in zip(getattr(tadj, fn)(5, empty),
                        getattr(jadj, fn)(5, empty)):
            np.testing.assert_array_equal(a, b)
    assert tadj.degree_buckets(np.zeros(4, int)) == [1]
    loops = np.array([[0, 1], [2, 2], [1, 3]])     # a self-loop edge
    for a, b in zip(tadj.build_edge_adjacency(4, loops),
                    jadj.build_edge_adjacency(4, loops)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# The pass kernels' plain versions against the JAX segment math
# --------------------------------------------------------------------------

@pytest.mark.parametrize("perk", [False, True])
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_plain_pass_matches_jax(family, perk):
    topo = sbt.meshes.tet_cube(4, 4, 4, size=0.6, center=(0.0, 0.5, 0.0))
    nv = topo.num_particles
    rng = np.random.default_rng(11)
    x = (topo.vertices + rng.normal(0.0, 0.02, (nv, 3))).astype(np.float32)
    w = sbt.init_state(topo, inv_mass_mode="density",
                       device="cpu").inv_mass.numpy().copy()
    w[[0, 7, 30]] = 0.0
    cons, rest = ((topo.edges, topo.edge_rest) if family == "edges"
                  else (topo.tets, topo.tet_rest_vol))
    k, omega = 0.9, 1.4
    table = (rng.uniform(0.2, 1.0, len(cons)).astype(np.float32)
             if perk else None)
    stiff = k if table is None else table * np.float32(k)

    jfn = (jjac.edge_jacobi_deltas if family == "edges"
           else jjac.tet_jacobi_deltas)
    delta, cnt = jfn(jax.numpy.asarray(x), jax.numpy.asarray(w),
                     jax.numpy.asarray(cons), jax.numpy.asarray(rest),
                     stiff, nv)
    want = np.asarray(jjac.apply_delta(jax.numpy.asarray(x),
                                       jax.numpy.asarray(w), delta, cnt,
                                       np.float32(omega)))

    make = kj.edge_pass_plan if family == "edges" else kj.tet_pass_plan
    plan = make(nv, cons, rest, table, device="cpu",
                vertices=topo.vertices)
    xin = torch.from_numpy(np.concatenate([x, w[:, None]], 1))
    xout = torch.full_like(xin, np.nan)
    cnt_out = torch.zeros(nv, dtype=torch.int32)
    fn = kj.jacobi_edge_pass if family == "edges" else kj.jacobi_tet_pass
    before = fn.launches
    fn(plan, xin, xout, k, omega, cnt_out)
    assert fn.launches == before                 # plain version on the CPU
    np.testing.assert_allclose(xout[:, :3].numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(xout[:, 3].numpy(), w)
    np.testing.assert_array_equal(cnt_out.numpy(), np.asarray(cnt))
    assert np.abs(want - x).max() > 1e-4                # the pass moved x
    np.testing.assert_array_equal(xout[w == 0, :3].numpy(), x[w == 0])


def test_pass_wrappers_validate_inputs():
    topo = sbt.meshes.tet_cube(2, 2, 2)
    nv = topo.num_particles
    ep = kj.edge_pass_plan(nv, topo.edges, topo.edge_rest, device="cpu",
                           vertices=topo.vertices)
    xin = torch.zeros((nv, 4))
    with pytest.raises(ValueError, match="snapshot"):
        kj.jacobi_edge_pass(ep, xin, xin, 0.9, 1.4)
    with pytest.raises(ValueError):
        kj.jacobi_edge_pass(ep, xin[:-1], torch.zeros((nv - 1, 4)), 0.9, 1.)
    with pytest.raises(TypeError):
        kj.jacobi_edge_pass(ep, xin.double(), torch.zeros((nv, 4)), 0.9, 1.)
    with pytest.raises(TypeError):
        kj.jacobi_edge_pass(ep, xin, torch.zeros((nv, 4)), 0.9, 1.4,
                            torch.zeros(nv))
    with pytest.raises(ValueError):
        kj.tet_pass_plan(nv, topo.tets, topo.tet_rest_vol,
                         k=np.ones(3), device="cpu", vertices=topo.vertices)


# --------------------------------------------------------------------------
# Whole steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_step_matches_oracle_and_jax(backend):
    ox, ov, jx = _reference()
    eng = _engine(sbt.meshes.tet_cube(**CUBE), backend)
    assert eng.backend == ("pass" if backend == "pallas" else backend)
    eng.run(STEPS, DT)
    x = eng.positions()
    assert 0.2 < ox[:, 1].min() < 0.25        # resting on the box top 0.2
    np.testing.assert_allclose(x, ox, rtol=0, atol=TOL)
    np.testing.assert_allclose(eng.velocities(), ov, rtol=0, atol=1e-2)
    for b, want in jx.items():
        np.testing.assert_allclose(x, want, rtol=0, atol=TOL, err_msg=b)


def test_gather_collide_through_the_collide_wrapper(monkeypatch):
    """The gather backend's collide stage goes through the fused collide
    wrapper (its plain version on the CPU) once per iteration, with a body
    transform too; on the CPU use_pallas 'on' and 'off' give the same
    steps."""
    calls = []
    real = kc.collide_positions
    monkeypatch.setattr(kc, "collide_positions",
                        lambda *a: calls.append(a[0].device) or real(*a))
    topo = sbt.meshes.tet_cube(**CUBE)
    on = _engine(topo, "gather", params=dict(use_pallas="on"))
    off = _engine(topo, "gather", params=dict(use_pallas="off"))
    stages = STEPS * on.params.substeps * on.params.iterations
    on.run(STEPS, DT)
    off.run(STEPS, DT)
    assert len(calls) == 2 * stages
    assert torch.equal(on.state.x, off.state.x)
    moved = _engine(topo, "gather", **_TRANSFORMS).run(STEPS, DT)
    assert len(calls) == 3 * stages
    assert all(d.type == "cpu" for d in calls)
    np.testing.assert_allclose(moved.positions(),
                               _jax_reference("transforms"), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("backend", ["gather", "pass"])
def test_chebyshev_matches_jax(backend):
    eng = _engine(sbt.meshes.tet_cube(**CUBE), backend,
                  params=_CHEB).run(STEPS, DT)
    np.testing.assert_allclose(eng.positions(), _jax_reference("chebyshev"),
                               rtol=0, atol=TOL)
    off = _reference()[2]["gather"]
    assert np.abs(eng.positions() - off).max() > 1e-5   # the blend acted


@pytest.mark.parametrize("backend", ["gather", "pass"])
def test_runtime_collider_poses(backend):
    """update_colliders moves the box for later steps, without a new step
    object, as the JAX Engine's colliders_rt does."""
    eng = _engine(sbt.meshes.tet_cube(**CUBE), backend)
    raw = eng._raw_step
    for cols, want in zip(([BOX], [MOVED_BOX]), _jax_reference("moving_box")):
        eng.update_colliders(sbt.Colliders.build(cols, device="cpu"))
        eng.run(8, DT)
        np.testing.assert_allclose(eng.positions(), want, rtol=0, atol=TOL)
    assert eng._raw_step is raw
    with pytest.raises(ValueError):
        eng.update_colliders(sbt.Colliders.build([BOX, BOX], device="cpu"))


def test_local_space_transforms_gather():
    """A body simulated in local space: collisions in world space, gravity
    turned into the local frame; runtime transforms per step."""
    kw = _TRANSFORMS
    l2w, w2l = kw["local_to_world"], kw["world_to_local"]
    eng = _engine(sbt.meshes.tet_cube(**CUBE), "auto", **kw)
    assert eng.backend == "gather"
    eng.run(STEPS, DT)
    np.testing.assert_allclose(eng.positions(), _jax_reference("transforms"),
                               rtol=0, atol=TOL)
    x0 = eng.positions()
    eng.step(DT, local_to_world_rt=l2w, world_to_local_rt=w2l)
    assert np.isfinite(eng.positions()).all() and not np.array_equal(
        eng.positions(), x0)
    with pytest.raises(ValueError):
        _engine(sbt.meshes.tet_cube(**CUBE), "gather").step(
            DT, local_to_world_rt=l2w, world_to_local_rt=w2l)
    with pytest.raises(ValueError):
        _engine(sbt.meshes.tet_cube(**CUBE), "pass", **kw)


def _port_topology(jt) -> Topology:
    def groups(g):
        return ColorGroups(idx=np.asarray(g.idx), mask=np.asarray(g.mask),
                           order=np.asarray(g.order))

    return Topology(**{f.name: np.asarray(getattr(jt, f.name))
                       for f in dataclasses.fields(Topology)
                       if not f.name.endswith("colors")},
                    edge_colors=groups(jt.edge_colors),
                    tet_colors=groups(jt.tet_colors))


@pytest.mark.parametrize("backend", ["gather", "pass", "segment"])
def test_pinned_cloth_edges_only(backend):
    """No tets (uniform unit masses), two pinned corners, no ground."""
    jtopo, pinned = sbs.meshes.cloth_patch(6, 6)
    eng = _engine(_port_topology(jtopo), backend, items=(), pinned=pinned,
                  params=dict(ground_enabled=False)).run(STEPS, DT)
    x = eng.positions()
    np.testing.assert_array_equal(x[pinned], jtopo.vertices[pinned])
    np.testing.assert_array_equal(eng.velocities()[pinned], 0.0)
    np.testing.assert_allclose(x, _jax_reference("cloth"), rtol=0, atol=TOL)
    assert x[:, 1].min() < jtopo.vertices[:, 1].min() - 0.05     # it sagged


@pytest.mark.parametrize("backend", ["gather", "pass", "segment"])
def test_per_constraint_stiffness_and_overrides(backend):
    """Per-constraint tables with the step-time scalars as multipliers,
    against the JAX gather backend; then per-step overrides."""
    topo = sbt.meshes.tet_cube(**CUBE)
    kw = _stiffness_tables()
    eng = _engine(topo, backend, **kw).run(6, DT)
    np.testing.assert_allclose(eng.positions(), _jax_reference("per_k"),
                               rtol=0, atol=TOL)
    ov = dict(edge_stiffness=0.5, volume_stiffness=0.7, sor_omega=1.1)
    ref = _engine(topo, "gather", **kw).run(6, DT)
    for _ in range(3):
        eng.step(DT, **ov)
        ref.step(DT, **ov)
    np.testing.assert_allclose(eng.positions(), ref.positions(), rtol=0,
                               atol=1e-5)


def test_pass_step_n_and_carry_equal_single_steps():
    topo = sbt.meshes.tet_cube(**CUBE)
    cols = sbt.Colliders.build([BOX], device="cpu")
    step = sbt.make_step(topo, _params(jacobi_backend="pass"), cols,
                         device="cpu")
    s0 = sbt.init_state(topo, inv_mass_mode="density", device="cpu")
    b = s0
    for _ in range(5):
        b = step(b, DT)
    a = step.step_n(s0, DT, 5)
    carry = step.run_carry(step.pack_state(s0), DT, 2)
    carry = step.run_carry(carry, DT, 3)
    c = step.unpack_state(carry, s0)
    for f in ("x", "v", "x_star", "inv_mass"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(getattr(c, f), getattr(b, f)), f
    assert torch.equal(step.carry_positions(carry), b.x)

    chunked = _engine(topo, "pass")
    chunked.RUN_CHUNK = 4
    chunked.run(9, DT)                      # 2 chunks + 1 single step
    single = _engine(topo, "pass")
    for _ in range(9):
        single.step(DT)
    assert torch.equal(chunked.positions_device(), single.positions_device())
    assert torch.equal(chunked.state.v, single.state.v)


def test_gather_step_n_and_dt_zero():
    topo = sbt.meshes.tet_cube(**CUBE)
    step = sbt.make_step(topo, _params(jacobi_backend="gather"),
                         device="cpu")
    s0 = sbt.init_state(topo, inv_mass_mode="density", device="cpu")
    b = s0
    for _ in range(3):
        b = step(b, DT)
    assert torch.equal(step.step_n(s0, DT, 3).x, b.x)
    # dt = 0: inv_dt 0, so velocities are zero; positions stay finite
    for backend in ("gather", "pass"):
        z = _engine(topo, backend).step(0.0)
        assert np.isfinite(z.positions()).all()
        np.testing.assert_array_equal(z.velocities(), 0.0)


def test_engine_switch_params_and_state_transfer():
    topo = sbt.meshes.tet_cube(**CUBE)
    eng = _engine(topo, "pass").run(4, DT)
    x4 = eng.positions()
    eng.switch_params(_params(jacobi_backend="gather"))
    assert eng.backend == "gather" and eng.colliders is not None
    np.testing.assert_array_equal(eng.positions(), x4)
    eng.run(2, DT)
    eng.switch_params(_params(jacobi_backend="pass"), colliders=None)
    assert eng.colliders is None
    eng.run(2, DT)
    assert np.isfinite(eng.positions()).all()
    start = {f: getattr(eng.state, f).numpy()
             for f in ("x", "v", "x_star", "inv_mass", "edge_lambda",
                       "tet_lambda")}
    eng.state = state_from_numpy(start, "cpu")
    eng.step(DT)


def test_backend_resolution(monkeypatch):
    big = types.SimpleNamespace(num_edges=60_000, num_tets=40_000)
    small = types.SimpleNamespace(num_edges=60_000, num_tets=39_999)
    auto = _params()
    # these stand for meshes whose tile plans fit the pass kernels
    # (test_auto_pass_needs_a_fitting_plan builds real ones)
    asked = []
    monkeypatch.setattr(jp, "pass_tiles",
                        lambda t, n: asked.append(t) or (None, None))
    assert resolve_backend(big, auto, device="cpu") == "gather"
    assert resolve_backend(small, auto, device="cpu") == "gather"
    assert resolve_backend(small, auto.replace(jacobi_backend="pallas")) \
        == "pass"
    assert resolve_backend(small, auto.replace(jacobi_backend="segment")) \
        == "segment"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_backend(big, auto, device="cuda") == "pass"
    assert resolve_backend(big, auto) == "pass"          # default: the card
    assert resolve_backend(small, auto, device="cuda") == "gather"
    assert resolve_backend(big, auto, device="cuda",
                           local_to_world=np.eye(4)) == "gather"
    assert asked and all(t is big for t in asked)
    # the xpbd rule is unchanged
    assert resolve_backend(big, auto.replace(dialect="xpbd"),
                           device="cuda") == "sweep"
    with pytest.raises(ValueError):
        sbt.make_step(sbt.meshes.tet_cube(2, 2, 2),
                      auto.replace(jacobi_backend="nope"), device="cpu")


def test_auto_pass_needs_a_fitting_plan(monkeypatch):
    """'auto' on the card: tet_ball(6, 0.3) (245,762 constraints, the
    centre in all 81,920 tets) plans with a heavy centre and gets the pass
    kernels, whose step takes the plans that the check cut (each family
    is cut once); a dense graph whose tiles cannot fit gets 'gather', with
    or without colliders."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    auto = _params()
    ball = fan_ball(6)
    assert ball.num_edges + ball.num_tets == 245_762
    cut, built = [], {}
    tile_plan = jp.tile_plan
    monkeypatch.setattr(jp, "tile_plan",
                        lambda *a, **k: cut.append(a[1]) or tile_plan(*a, **k))
    monkeypatch.setattr(jpass, "JacobiPassStep",
                        lambda *a, tiles, **k: built.setdefault("t", tiles))
    tiles = sbt.make_step(ball, auto, device="cuda")
    assert tiles is built["t"] and len(cut) == 2
    assert [t.heavy.tolist() for t in tiles] == [[ball.num_particles - 1]] * 2
    assert resolve_backend(ball, auto, device="cuda", num_colliders=4) \
        == "pass"
    n = 460                                    # 105,570 edges, 2 tiles
    i, j = np.triu_indices(n, 1)
    dense = types.SimpleNamespace(
        num_particles=n, vertices=np.random.default_rng(1).uniform(
            0.0, 1.0, (n, 3)), edges=np.stack([i, j], 1),
        tets=np.zeros((0, 4), np.int64), num_edges=len(i), num_tets=0)
    for k in (0, 3):
        assert resolve_backend(dense, auto, device="cuda",
                               num_colliders=k) == "gather"
    assert resolve_backend(dense, auto.replace(jacobi_backend="pass"),
                           device="cuda") == "pass"          # as asked


@pytest.mark.parametrize("subdivisions", [5, 6])
def test_pass_step_steps_high_valence_balls(subdivisions):
    """JacobiPassStep builds tet_ball(5) and tet_ball(6) (its centre a
    heavy vertex of both families) and steps it onto the floor box as the
    'segment' step does (1e-5 m after one step; on the CPU both run plain
    tensor code; 'gather' takes a minute to build its padded rows for a
    centre in 81,920 tets)."""
    ball = fan_ball(subdivisions, center=(0.0, 0.45, 0.0))
    box = sbt.Colliders.build([dict(type=1, position=(0.0, 0.1, 0.0),
                                    data=(1.5, 0.1, 1.5))], device="cpu")
    s0 = sbt.init_state(ball, inv_mass_mode="density", device="cpu")
    out = {}
    for backend in ("pass", "segment"):
        step = sbt.make_step(ball, _params(jacobi_backend=backend), box,
                             device="cpu")
        assert step.backend == backend
        out[backend] = step(s0, DT).x.numpy()
        if backend == "pass":
            for plan in (step.edge_plan, step.tet_plan):
                assert plan.tiles.heavy.tolist() == [ball.num_particles - 1]
    assert np.isfinite(out["pass"]).all()
    np.testing.assert_allclose(out["pass"], out["segment"], rtol=0,
                               atol=1e-5)
    assert out["pass"][:, 1].min() >= 0.2 + 0.02 - 1e-4     # on the box


def test_heavy_pass_step_matches_jax(monkeypatch):
    """SampleScene's mesh (every tet holds the centre) with a heavy-vertex
    threshold low enough to make its centre heavy.  On the CPU this checks
    the plan (the pass step's tile plans make the centre heavy) and the
    plain step, which matches the JAX package's jacobi step onto a box
    within 1e-5 m over 6 steps (the JAX Pallas passes are held to its
    gather backend by tests/test_jacobi_pallas.py).  The heavy route's
    arithmetic, the partials and the last CTA's finish, is checked by the
    tiled replay in tests/test_torch_jacobi_tiles.py and the card tests in
    tests/test_torch_kernels.py."""
    monkeypatch.setattr(jp, "HEAVY_RUN", 40)
    jball = sbs.meshes.tet_ball(2, 0.3, center=(0.0, 0.55, 0.0))
    topo = _port_topology(jball)
    step = sbt.make_step(topo, _params(jacobi_backend="pass"),
                         sbt.Colliders.build([BOX], device="cpu"),
                         device="cpu")
    for plan in (step.edge_plan, step.tet_plan):
        assert plan.tiles.heavy.tolist() == [topo.num_particles - 1]
    s = sbt.init_state(topo, inv_mass_mode="density", device="cpu")
    for _ in range(6):
        s = step(s, DT)
    want = _jax_run(jball, "gather", steps=6)
    np.testing.assert_allclose(s.x.numpy(), want, rtol=0, atol=1e-5)
    assert want[:, 1].min() < 0.2 + 0.03              # it reached the box


@pytest.mark.parametrize("case", ["self_collision", "surface_collision",
                                  "rt_without_template", "rt_count",
                                  "use_pallas", "use_pallas_off_on_cuda"])
def test_jacobi_rejects(case, monkeypatch):
    topo = sbt.meshes.tet_cube(2, 2, 2)
    if case == "use_pallas_off_on_cuda":
        # the card has no plain collide stage: refused before any tensor
        # reaches the device
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        for backend in ("gather", "segment"):
            with pytest.raises(ValueError, match="use_pallas"):
                sbt.make_step(topo, _params(jacobi_backend=backend,
                                            use_pallas="off"),
                              device="cuda")
        return
    if case in ("self_collision", "surface_collision"):
        # ported: both backends build the stage and step; the stage moves
        # the cube (a radius over the lattice spacing, or a thickness that
        # reaches across the cube's faces)
        kw = ({case: True, "particle_radius": 0.2,
               "self_collision_cell": 0.4} if case == "self_collision"
              else {case: True, "surface_thickness": 0.3})
        for backend in ("gather", "pass"):
            eng = _engine(topo, backend, params=kw).run(2, DT)
            off = _engine(topo, backend).run(2, DT)
            assert eng._raw_step.contact is not None
            assert np.isfinite(eng.positions()).all()
            assert np.abs(eng.positions() - off.positions()).max() > 1e-3
        return
    if case == "use_pallas":
        with pytest.raises(ValueError):
            _engine(topo, "gather", params=dict(use_pallas="maybe"))
        return
    eng = _engine(topo, "gather", items=() if case == "rt_without_template"
                  else (BOX,))
    with pytest.raises(ValueError):
        eng.step(DT, colliders_rt=sbt.Colliders.build([BOX, BOX],
                                                      device="cpu"))


def test_entry_points_default_to_the_card(monkeypatch):
    """No device argument means the card: without one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = sbt.meshes.tet_cube(2, 2, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        sbt.Engine(topo, _params())
    with pytest.raises(RuntimeError, match="cuda"):
        sbt.Engine(topo, sbt.SolverParams())
    with pytest.raises(RuntimeError, match="cuda"):
        sbt.init_state(topo)
    with pytest.raises(RuntimeError, match="cuda"):
        sbt.make_step(topo, _params(jacobi_backend="gather"))
    with pytest.raises(RuntimeError, match="cuda"):
        sbt.Colliders.build([BOX])
    with pytest.raises(RuntimeError, match="cuda"):
        state_from_numpy({f: np.zeros(1) for f in (
            "x", "v", "x_star", "inv_mass", "edge_lambda", "tet_lambda")})
