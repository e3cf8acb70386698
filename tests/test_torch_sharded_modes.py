"""The data-parallel, constraint-parallel and vertex-sharded steps
(``softbodysim_torch/parallel/{sharding,constraint,vertex}.py``) and the
distributed gradients of ``diff.py`` on gloo process groups on the CPU,
against the JAX package and the port's single-device steps.

The pattern of tests/test_torch_sharded.py: the port's ranks are spawned
processes (``parallel.spawn``) that import only softbodysim_torch
(``tests/torch_sharded_ranks.py``); the inputs are made here (the JAX
package's initial states, velocities drawn from a seeded numpy generator)
and reach the ranks as numpy arrays.  Each world size (2, 4) is spawned
once per module and runs every case of its size; the JAX references run
on the 8-device virtual CPU mesh of tests/conftest.py, each in a process
of its own, while the ranks run.  The single-device references of the
port run on rank 0.

Contracts, at the JAX tests' sizes and tolerances (tests/test_sharding.py,
test_chebyshev_sharded.py, test_sharding_colliders.py,
test_sharding_collision.py, test_diff_sharded.py); the XPBD runs are cut
to a few steps, their cost on the CPU (every colour of every iteration
is a collective):
- data parallelism matches the batched step within 1e-5 m and calls no
  collective;
- make_mesh_sharded_step on (data, model) meshes (1, 2), (2, 1), (2, 2)
  matches the JAX step on the same mesh shape and the single-device step
  within 1e-5 m, Chebyshev too; make_xpbd_sharded_step within 1e-5 m and
  lambdas 1e-4 (public order);
- the vertex-sharded jacobi step in all three halo modes (the same bits in
  each), on the pinned cloth and with Chebyshev: 1e-5 m against the
  single-device Engine; halo_mode, vpad and comm_bytes_* equal to the JAX
  step's on the same mesh; the xpbd vertex-sharded step 1e-5 m, lambdas
  1e-4, its comm_bytes_per_color the JAX step's;
- both vertex-sharded steps with colliders and with self and surface
  contact: 2e-5 m, lambdas 1e-4;
- gradients: mesh-sharded and vertex-sharded jacobi, the xpbd custom
  backward and the material overrides, 1e-3 x max(1, |ref|) of the JAX
  package's single-device gradient; fit(mesh=) recovers the stiffness;
- every rank returns the same bits.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from softbodysim_tpu import SolverParams as JParams
from softbodysim_tpu.collide.primitives import Colliders as JColliders
from softbodysim_tpu.core import meshes as jmeshes
from softbodysim_tpu.core.adjacency import combine_topologies as jcombine
from softbodysim_tpu.core.state import init_state as j_init_state

from softbodysim_torch.parallel import spawn

import torch_sharded_ranks

DT = 1.0 / 60.0
F = np.float32
FIELDS = ("x", "v", "x_star", "inv_mass", "edge_lambda", "tet_lambda")

CUBE2 = ("tet_cube", (2, 2, 2, 1.0, (0.0, 0.5, 0.0)))
CUBE3 = ("tet_cube", (3, 3, 3, 0.5, (0.0, 0.4, 0.0)))
GRAD_CUBE = ("tet_cube", (3, 3, 3, 0.5, (0.0, 0.5, 0.0)))
HANGING = ("tet_cube", (3, 3, 3, 0.4))
HALO = ("tet_cube", (12, 4, 4, 1.0, (0.0, 0.8, 0.0)))
BIG = ("tet_cube", (12, 12, 12))
CLOTH = ("cloth", (10, 10))
BALL = ("tet_ball", (1, 0.2, (0.0, 0.55, 0.0)))
BALLS = ("merged", [("tet_ball", (1, 0.22, (0.0, 0.35, 0.0))),
                    ("tet_ball", (1, 0.22, (0.40, 0.42, 0.0)))])

JAC = dict(dialect="jacobi", substeps=2, iterations=4)
XP = dict(dialect="xpbd", substeps=2, iterations=4)
HALO_P = dict(dialect="jacobi", substeps=2, iterations=3, use_pallas="off")
HALO_P1 = dict(HALO_P, substeps=1)
CHEB = dict(dialect="jacobi", substeps=2, iterations=6, chebyshev=True,
            gravity=(0.0, -10.0, 0.0), particle_radius=0.02)
CLOTH_P = dict(dialect="jacobi", substeps=1, iterations=4,
               ground_enabled=False, use_pallas="off")
BALL_J = dict(dialect="jacobi", substeps=1, iterations=3, use_pallas="off")
BALL_X = dict(dialect="xpbd", substeps=2, iterations=3)
COLL = dict(particle_radius=0.04, self_collision=True,
            self_collision_cell=0.1, self_collision_max_per_cell=32,
            surface_collision=True, surface_thickness=0.03,
            surface_collision_max_per_cell=16)
GRAD_J = dict(dialect="jacobi", substeps=1, iterations=3,
              jacobi_backend="segment", use_pallas="off")
GRAD_X = dict(dialect="xpbd", substeps=1, iterations=3,
              xpbd_backend="scatter", use_pallas="off")
OVERRIDES = dict(edge_stiffness=0.7, volume_stiffness=0.9, sor_omega=1.3)
FIT_P = dict(dialect="jacobi", substeps=2, iterations=2,
             ground_enabled=False, edge_stiffness=0.5,
             jacobi_backend="segment", use_pallas="off")

GRAD_STEPS, XGRAD_STEPS = 4, 3
MESH_STEPS, XMESH_STEPS, XVERTEX_STEPS = 10, 3, 3
SHAPES = ((1, 2), (2, 1), (2, 2))
XSHAPES = ((1, 2), (2, 2))
HALO_STEPS = {"auto": 15, "general": 10, "off": 10}


def _jtopo(spec):
    kind, args = spec
    if kind == "cloth":
        return jmeshes.cloth_patch(*args)
    if kind == "merged":
        return jcombine([getattr(jmeshes, k)(*a) for k, a in args])[0], None
    return getattr(jmeshes, kind)(*args), None


def _start(spec, mode, seed=None, sigma=0.5, pinned=None):
    """The JAX package's initial state of ``spec`` as numpy arrays, the
    velocities N(0, sigma) from ``seed`` when given (pinned rows 0)."""
    topo, _ = _jtopo(spec)
    st = j_init_state(topo, pinned=pinned, inv_mass_mode=mode)
    out = {f: np.asarray(getattr(st, f)) for f in FIELDS}
    if seed is not None:
        v = np.random.default_rng(seed).normal(0.0, sigma,
                                               out["v"].shape).astype(F)
        v[out["inv_mass"] == 0.0] = 0.0
        out["v"] = v
    return out


def _batched(spec, mode, batch, seed):
    """``batch`` scenes of ``spec``, scene b's velocities from seed + b."""
    scenes = [_start(spec, mode, seed=seed + b) for b in range(batch)]
    return {f: np.stack([s[f] for s in scenes]) for f in FIELDS}


def _cols():
    return JColliders.build([
        JColliders.sphere((0.05, 0.18, 0.0), 0.2),
        JColliders.box((0.5, 0.1, 0.0), (0.15, 0.1, 0.15))])


def _col_arrays():
    c = _cols()
    return {k: np.asarray(getattr(c, k))
            for k in ("type", "position", "rotation", "data", "active")}


# --------------------------------------------------------------------------
# The cases: world -> {name: (kind, the ranks' inputs)}
# --------------------------------------------------------------------------

# the constraint-parallel cases: name -> (topology, params, mesh shape,
# batch, steps); every scene from seeded velocities of its own
CONSTRAINT = {
    **{f"mesh_{d}x{m}": (CUBE2, JAC, (d, m), 2 * d, MESH_STEPS)
       for d, m in SHAPES},
    **{f"xmesh_{d}x{m}": (CUBE2, dict(XP, iterations=2), (d, m), 2 * d,
                           XMESH_STEPS) for d, m in XSHAPES},
    "mesh_cheb": (CUBE3, CHEB, (1, 2), 2, 15),
}


def _constraint_start(name):
    spec, p, _, batch, _ = CONSTRAINT[name]
    return _batched(spec, "tet" if p["dialect"] == "xpbd" else "density",
                    batch, seed=10)


def _constraint_case(name):
    spec, p, shape, _, steps = CONSTRAINT[name]
    return ("constraint", dict(topology=spec, params=p, shape=shape,
                               state=_constraint_start(name), steps=steps))

def _cases():
    _, pin = _jtopo(CLOTH)
    halo0 = _start(HALO, "density", seed=4)
    w2 = {
        "dp_jacobi": ("data_parallel", dict(topology=CUBE2, params=JAC,
                                            batch=4, steps=20)),
        "dp_xpbd": ("data_parallel", dict(
            topology=CUBE2, params=dict(XP, substeps=1, iterations=3),
            batch=4, steps=8)),
        **{name: _constraint_case(name) for name in (
            "mesh_1x2", "mesh_2x1", "xmesh_1x2", "mesh_cheb")},
        **{f"halo_{m}": ("vertex", dict(
            topology=HALO, params=HALO_P if m == "auto" else HALO_P1,
            halo=m, state=halo0, steps=HALO_STEPS[m]))
           for m in ("auto", "general", "off")},
        "cloth": ("vertex", dict(topology=CLOTH, params=CLOTH_P,
                                 state=_start(CLOTH, "density", pinned=pin),
                                 steps=20)),
        "vcheb": ("vertex", dict(topology=CUBE3, params=CHEB,
                                 state=_start(CUBE3, "density"), steps=15)),
        "cols_jacobi": ("vertex", dict(topology=BALL, params=BALL_J,
                                       colliders=_col_arrays(),
                                       state=_start(BALL, "density"),
                                       steps=20)),
        "cols_xpbd": ("vertex", dict(topology=BALL, params=BALL_X,
                                     colliders=_col_arrays(),
                                     state=_start(BALL, "tet"), steps=2)),
        "contact_jacobi": ("vertex", dict(
            topology=BALLS, params=dict(BALL_J, **COLL),
            state=_start(BALLS, "density"), steps=15)),
        "contact_xpbd": ("vertex", dict(
            topology=BALLS, params=dict(BALL_X, **COLL),
            state=_start(BALLS, "tet"), steps=2)),
        "xvertex": ("vertex", dict(topology=CUBE2,
                                   params=dict(XP, iterations=3),
                                   state=_start(CUBE2, "tet", seed=6,
                                                sigma=0.2),
                                   steps=XVERTEX_STEPS)),
        "grads": ("grads", dict(
            topology=GRAD_CUBE, params=GRAD_J, steps=GRAD_STEPS,
            kicked=_start(GRAD_CUBE, "density", seed=5),
            overrides=OVERRIDES, xpbd=dict(params=GRAD_X),
            xpbd_steps=XGRAD_STEPS)),
        "fit": ("fit", dict(topology=HANGING, params=FIT_P, nsteps=8,
                            steps=30, lr=0.25, start=0.15)),
    }
    w4 = {
        **{name: _constraint_case(name) for name in (
            "mesh_2x2", "xmesh_2x2")},
        "halo_auto": ("vertex", dict(topology=HALO, params=HALO_P,
                                     state=halo0, steps=HALO_STEPS["auto"])),
        "halo_general": ("halo_sizes", dict(topology=HALO, params=HALO_P1,
                                            halo="general")),
        "xvertex": w2["xvertex"],
        "xbig": ("halo_sizes", dict(topology=BIG,
                                    params=dict(XP, iterations=3))),
    }
    return {2: w2, 4: w4}


# --------------------------------------------------------------------------
# The JAX references, each in a process of its own (spawned, so it imports
# this module; the conftest's environment is inherited), while the ranks
# run
# --------------------------------------------------------------------------

def _jmesh(shape, names=("data", "model")):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _ref_constraint():
    """make_mesh_sharded_step / make_xpbd_sharded_step on each case's
    (data, model) mesh, from the case's batched state."""
    from softbodysim_tpu.core.state import SimState
    from softbodysim_tpu.parallel import (make_mesh_sharded_step,
                                          make_xpbd_sharded_step,
                                          shard_batch)

    out = {}
    for name, (spec, p, shape, _, n) in CONSTRAINT.items():
        topo, _ = _jtopo(spec)
        mesh = _jmesh(shape)
        make = (make_xpbd_sharded_step if p["dialect"] == "xpbd"
                else make_mesh_sharded_step)
        step = jax.jit(make(topo, JParams(**p), mesh))
        st = shard_batch(SimState(**{f: jnp.asarray(v) for f, v in
                                     _constraint_start(name).items()}),
                         mesh, axis="data")
        for _ in range(n):
            st = step(st, DT)
        out[name] = {f: np.asarray(getattr(st, f))
                     for f in ("x", "edge_lambda", "tet_lambda")}
    return out


def _ref_vertex():
    """The vertex-sharded steps' halo attributes at D = 2 and 4; the halo
    cube's 'auto' trajectory at D = 2; the xpbd step on CUBE2 at D = 2."""
    from softbodysim_tpu.core.state import SimState
    from softbodysim_tpu.parallel import (make_vertex_sharded_step,
                                          make_xpbd_vertex_sharded_step)

    out = {}
    topo, _ = _jtopo(HALO)
    for D in (2, 4):
        mesh = _jmesh((D,), ("model",))
        for m in ("auto", "general", "off"):
            s = make_vertex_sharded_step(topo, JParams(
                **(HALO_P if m == "auto" else HALO_P1)), mesh, halo=m)
            out[f"halo_{m}_{D}"] = (s.halo_mode, s.vpad,
                                    s.comm_bytes_per_sweep,
                                    s.comm_bytes_full_gather)
        big, _ = _jtopo(BIG)
        s = make_xpbd_vertex_sharded_step(big, JParams(
            **dict(XP, iterations=3)), mesh)
        out[f"xbig_{D}"] = (s.comm_bytes_per_color, s.full_gather_bytes)
        c2, _ = _jtopo(CUBE2)
        s = make_xpbd_vertex_sharded_step(c2, JParams(
            **dict(XP, iterations=3)), mesh)
        out[f"xvertex_bytes_{D}"] = (s.comm_bytes_per_color,
                                     s.full_gather_bytes)
    mesh = _jmesh((2,), ("model",))
    step = make_vertex_sharded_step(topo, JParams(**HALO_P), mesh)
    a = _start(HALO, "density", seed=4)
    pad = step.vpad - topo.num_particles
    st = tuple(jnp.asarray(np.concatenate(
        [a[f], np.zeros((pad,) + a[f].shape[1:], F)]))
        for f in ("x", "v", "inv_mass"))
    jstep = jax.jit(step)
    for _ in range(HALO_STEPS["auto"]):
        st = jstep(st, DT)
    out["halo_auto_x"] = step.unpad(st[0])
    c2, _ = _jtopo(CUBE2)
    step = jax.jit(make_xpbd_vertex_sharded_step(c2, JParams(
        **dict(XP, iterations=3)), mesh))
    st = SimState(**{f: jnp.asarray(v) for f, v in _start(
        CUBE2, "tet", seed=6, sigma=0.2).items()})
    for _ in range(XVERTEX_STEPS):
        st = step(st, DT)
    out["xvertex"] = {f: np.asarray(getattr(st, f))
                      for f in ("x", "edge_lambda", "tet_lambda")}
    return out


def _ref_grads():
    """The JAX package's single-device gradients of the ranks' losses."""
    import dataclasses

    from softbodysim_tpu import diff
    from softbodysim_tpu.solver import make_step

    topo, _ = _jtopo(GRAD_CUBE)
    s0 = j_init_state(topo)
    step = make_step(topo, JParams(**GRAD_J))

    def final_sq(x0):
        st = dataclasses.replace(s0, x=x0, x_star=x0)
        for _ in range(GRAD_STEPS):
            st = step(st, DT)
        return jnp.sum(st.x * st.x)

    out = {"jacobi": np.asarray(jax.jit(jax.grad(final_sq))(s0.x))}
    kick = _start(GRAD_CUBE, "density", seed=5)
    roll = diff.make_rollout(topo, JParams(**GRAD_J), dt=DT,
                             nsteps=GRAD_STEPS, remat=False)
    from softbodysim_tpu.core.state import SimState

    k0 = SimState(**{f: jnp.asarray(v) for f, v in kick.items()})
    g = jax.jit(jax.grad(lambda ov: jnp.sum(jnp.square(roll(k0, ov)))))(
        {k: jnp.float32(v) for k, v in OVERRIDES.items()})
    out["overrides"] = [float(g[k]) for k in OVERRIDES]
    xroll = diff.make_rollout(topo, JParams(**GRAD_X), dt=DT,
                              nsteps=XGRAD_STEPS)

    def xloss(x0):
        return jnp.sum(jnp.square(xroll(dataclasses.replace(
            s0, x=x0, x_star=x0))))

    out["xpbd"] = np.asarray(jax.jit(jax.grad(xloss))(s0.x))
    return out


REFS = {"constraint": _ref_constraint, "vertex": _ref_vertex,
        "grads": _ref_grads}


def _reference(name):
    # the compiles are the file's heaviest CPU work: they yield the CPU
    # to the tests that other workers run beside them
    import os

    os.nice(10)
    return REFS[name]()


class _Background:
    """The ranks (each world spawned on a thread of its own: their time is
    mostly the collectives' latency) and the JAX references (a process
    each), started when the module's first test runs."""

    def __init__(self):
        import multiprocessing

        self._pool = multiprocessing.get_context("spawn").Pool(len(REFS))
        self._refs = {n: self._pool.apply_async(_reference, (n,))
                      for n in REFS}
        self._out, self._err = {}, {}

        def work(world, c):
            try:
                self._out[world] = spawn(
                    torch_sharded_ranks.run_cases_yielding, world, c,
                    timeout_s=900.0)
            except Exception as e:                # noqa: BLE001
                self._err[world] = e      # raised again by ranks()

        self._threads = {w: threading.Thread(target=work, args=(w, c))
                         for w, c in _cases().items()}
        for t in self._threads.values():
            t.start()

    def ranks(self, world):
        self._threads[world].join()
        if world in self._err:
            raise self._err[world]
        return self._out[world]

    def ref(self, name):
        return self._refs[name].get(timeout=900)

    def close(self):
        for t in self._threads.values():
            t.join()
        self._pool.terminate()
        self._pool.join()


@pytest.fixture(scope="module", autouse=True)
def bg():
    b = _Background()
    yield b
    b.close()


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _lam_rel(got, want):
    """Lambdas are small (1e-5 to 1e-4 here): also within 1e-3 of the
    largest, which must not be 0."""
    top = float(np.abs(want).max())
    assert top > 0.0
    _close(got, want, 1e-3 * top)


# --------------------------------------------------------------------------
# Data parallelism
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dp_jacobi", "dp_xpbd"])
def test_data_parallel_matches_batched_without_collectives(bg, name):
    res = bg.ranks(2)
    r = res[0][name]
    assert r["block"] == 2                  # 4 scenes over 2 data ranks
    _close(r["x"], r["ref"], 1e-5)
    assert all(q[name]["calls"] == 0 for q in res)
    assert "does not split" in r["uneven"]


# --------------------------------------------------------------------------
# Constraint parallelism
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    *(f"mesh_{d}x{m}" for d, m in SHAPES), "mesh_cheb",
    *(f"xmesh_{d}x{m}" for d, m in XSHAPES)])
def test_constraint_sharded_matches_jax_and_single(bg, name):
    _, p, (d, m), batch, _ = CONSTRAINT[name]
    r = bg.ranks(d * m)[0][name]
    ref = bg.ref("constraint")[name]
    assert r["block"] == batch // d and r["x"].shape[0] == batch
    _close(r["x"], ref["x"], 1e-5)
    _close(r["x"], r["ref_x"], 1e-5)
    assert len(np.unique(r["x"][:, 0, 0])) == batch    # distinct scenes
    if p["dialect"] == "xpbd":
        for f in ("edge_lambda", "tet_lambda"):   # public order
            _close(r[f], ref[f], 1e-4)
            _close(r[f], r["ref_" + f], 1e-4)
            _lam_rel(r[f], r["ref_" + f])
    else:
        assert r["ref_x"][..., 1].min() < 0.1       # it reached the ground


# --------------------------------------------------------------------------
# Vertex sharding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "general", "off"])
def test_vertex_sharded_halo_modes(bg, mode):
    r = bg.ranks(2)[0][f"halo_{mode}"]
    jhalo, jvpad, jsweep, jfull = bg.ref("vertex")[f"halo_{mode}_2"]
    assert (r["halo_mode"], r["vpad"]) == (jhalo, jvpad)
    assert r["comm"] == (jsweep, jfull)
    assert r["halo_mode"] == {"auto": "neighbor"}.get(mode, mode)
    _close(r["x"][-1], r["ref"], 1e-5)
    if mode == "auto":
        assert r["comm"][0] < r["comm"][1] / 2
        _close(r["x"][-1], bg.ref("vertex")["halo_auto_x"], 1e-5)
    if mode == "off":   # the same fetched values: the strip run's bits
        np.testing.assert_array_equal(
            r["x"], bg.ranks(2)[0]["halo_general"]["x"])


def test_vertex_sharded_halo_at_four_ranks(bg):
    res = bg.ranks(4)
    r = res[0]["halo_auto"]
    jhalo, jvpad, jsweep, jfull = bg.ref("vertex")["halo_auto_4"]
    assert (r["halo_mode"], r["vpad"], r["comm"]) == (jhalo, jvpad,
                                                      (jsweep, jfull))
    _close(r["x"][-1], r["ref"], 1e-5)
    g = res[0]["halo_general"]
    assert (g["halo_mode"], g["comm"]) == (
        bg.ref("vertex")["halo_general_4"][0],
        tuple(bg.ref("vertex")["halo_general_4"][2:]))


def test_vertex_sharded_cloth(bg):
    topo, pinned = _jtopo(CLOTH)
    r = bg.ranks(2)[0]["cloth"]
    _close(r["x"][-1][pinned], topo.vertices[pinned], 1e-6)
    _close(r["x"][-1], r["ref"], 1e-5)


def test_vertex_sharded_chebyshev(bg):
    r = bg.ranks(2)[0]["vcheb"]
    _close(r["x"][-1], r["ref"], 1e-5)


@pytest.mark.parametrize("dialect", ["jacobi", "xpbd"])
def test_vertex_sharded_colliders(bg, dialect):
    r = bg.ranks(2)[0][f"cols_{dialect}"]
    _close(r["x"][-1], r["ref"], 2e-5)
    # the colliders acted: the run without them ends elsewhere
    assert np.abs(r["ref"] - r["ref_plain"]).max() > 1e-3
    if dialect == "jacobi":
        assert r["ref"][:, 1].min() > 0.05      # the colliders held it up
    else:
        _close(r["edge_lambda"], r["ref_edge_lambda"], 1e-4)


@pytest.mark.parametrize("dialect", ["jacobi", "xpbd"])
def test_vertex_sharded_contact(bg, dialect):
    r = bg.ranks(2)[0][f"contact_{dialect}"]
    _close(r["x"][-1], r["ref"], 2e-5)
    # the stages fired: the run without them ends elsewhere
    assert np.abs(r["ref"] - r["ref_plain"]).max() > 1e-3
    if dialect == "xpbd":
        _close(r["edge_lambda"], r["ref_edge_lambda"], 1e-4)
        _close(r["tet_lambda"], r["ref_tet_lambda"], 1e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_xpbd_vertex_sharded_matches_single_and_jax(bg, world):
    r = bg.ranks(world)[0]["xvertex"]
    _close(r["x"][-1], r["ref"], 1e-5)
    for f in ("edge_lambda", "tet_lambda"):
        _close(r[f], r["ref_" + f], 1e-4)
        _lam_rel(r[f], r["ref_" + f])
    assert r["comm"] == bg.ref("vertex")[f"xvertex_bytes_{world}"]
    if world == 2:
        ref = bg.ref("vertex")["xvertex"]
        _close(r["x"][-1], ref["x"], 1e-5)
        _close(r["edge_lambda"], ref["edge_lambda"], 1e-4)


def test_xpbd_vertex_sharded_strips_are_boundary_sized(bg):
    r = bg.ranks(4)[0]["xbig"]
    assert r["comm"] == bg.ref("vertex")["xbig_4"]
    assert r["comm"][0] < 0.5 * r["comm"][1]


# --------------------------------------------------------------------------
# Gradients
# --------------------------------------------------------------------------

def _grad_close(got, ref):
    _close(got, ref, 1e-3 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("mode", ["mesh", "vertex"])
def test_sharded_jacobi_gradient(bg, mode):
    res = bg.ranks(2)
    ref = bg.ref("grads")["jacobi"]
    _grad_close(res[0]["grads"][mode], ref)
    _grad_close(res[0]["grads"]["ref"], ref)
    np.testing.assert_array_equal(res[1]["grads"][mode],
                                  res[0]["grads"][mode])


def test_sharded_override_gradients(bg):
    r = bg.ranks(2)[0]["grads"]
    ref = np.asarray(bg.ref("grads")["overrides"])
    _grad_close(np.asarray(r["overrides"]), ref)
    _grad_close(np.asarray(r["ref_overrides"]), ref)
    assert np.abs(ref).min() > 1e-3


def test_xpbd_sharded_rollout_gradient_custom_backward(bg):
    res = bg.ranks(2)
    ref = bg.ref("grads")["xpbd"]
    _grad_close(res[0]["grads"]["xpbd"], ref)
    _grad_close(res[0]["grads"]["ref_xpbd"], ref)
    np.testing.assert_array_equal(res[1]["grads"]["xpbd"],
                                  res[0]["grads"]["xpbd"])


def test_sharded_fit_recovers_stiffness(bg):
    import math

    res = bg.ranks(2)
    r = res[0]["fit"]
    assert r["losses"][-1] < 0.05 * r["losses"][0]
    assert abs(math.log(r["params"]["edge_stiffness"] / 0.5)) \
        < math.log(1.25)
    assert r["params"] == res[1]["fit"]["params"]
    # the batch's two scenes (one per data rank) are the same scene
    np.testing.assert_array_equal(r["target"][:, 0], r["target"][:, 1])


# --------------------------------------------------------------------------
# Every rank, the same bits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_returns_the_same_bits(bg, world):
    res = bg.ranks(world)
    for name, r0 in res[0].items():
        for q in res[1:]:
            for k, v in r0.items():
                if k.startswith("ref") or k in ("block", "calls"):
                    continue        # rank 0's references; per-rank sizes
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(q[name][k], v,
                                                  err_msg=f"{name} {k}")
