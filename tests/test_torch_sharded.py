"""The kernel-sharded steps (``solver/xpbd_sweep_sharded.py``,
``solver/jacobi_pass_sharded.py``, behind ``Engine(mesh=...)``) on gloo
process groups on the CPU, against the JAX package.

The port's ranks are spawned processes (``parallel.spawn``) that import
only softbodysim_torch (``tests/torch_sharded_ranks.py``); the inputs are
made here (the JAX package's initial states, velocities drawn from a
seeded numpy generator) and reach the ranks as numpy arrays through
``io/from_jax.py``.  Each world size (1, 2, 4) is spawned once per module
and runs every case of its size; each JAX reference is computed once, in
a process of its own, while the ranks run (the interpret-mode compiles
take a minute each).  Every rank returns the same public state, bit for
bit.

Contracts, at the JAX tests' sizes and tolerances:
- Jacobi sharding is not a dialect change: D = 2 and 4 match the JAX
  single-device pass step (interpret mode) within 1e-5 m at each of 5
  steps, velocities 1e-4 (tests/test_jacobi_sharded.py); the pinned
  cloth, edges only: pinned rows within 1e-6 of rest, all rows within
  1e-5; two balls in self and surface contact at D = 2 within 1e-5
  (tests/test_pallas_sharded_collision.py).  The cloth and the contact
  scene are held to the JAX package's XLA jacobi step ('gather', which
  tests/test_jacobi_pallas.py holds to its Pallas step).
- XPBD at D = 1 is the single-device dialect: within 1e-6 of the JAX sweep
  step with colliders over 12 steps (tests/test_sharding_colliders.py).
- XPBD at D = 2 is the JAX sharded dialect: within 1e-5 m (positions) and
  1e-4 (lambdas) of ``make_xpbd_pallas_sharded_step`` on a 2-device CPU
  mesh, with the same ownership, ghost counts and packed per-lane scales
  (the 1/k fold) (tests/test_pallas_sharded.py).
- ``Engine(mesh=...)`` forced onto the kernel backends matches the
  single-device Engine within 2e-5 (tests/test_engine_sharded.py);
  'split' at D > 1 raises ValueError; a small scene under 'auto' takes the
  vertex-sharded steps, held to the single-device Engine within 2e-5 m
  and 1e-4 (lambdas) on a box collider.
- The accumulate-only mode's plain versions (the CPU side of
  ``jacobi_edge_accumulate`` / ``jacobi_tet_accumulate``) match the JAX
  pass built with ``apply=False`` within 1e-6, counts equal.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from softbodysim_tpu import SolverParams as JParams
from softbodysim_tpu.collide.primitives import Colliders as JColliders
from softbodysim_tpu.core import meshes as jmeshes
from softbodysim_tpu.core.adjacency import combine_topologies as jcombine
from softbodysim_tpu.core.state import init_state as j_init_state
from softbodysim_tpu.kernels import jacobi as jkj
from softbodysim_tpu.kernels import sweep as jsw
from softbodysim_tpu.solver import make_step as j_make_step
from softbodysim_tpu.solver.jacobi_pallas import make_jacobi_pallas_step
from softbodysim_tpu.solver.xpbd_pallas import make_xpbd_pallas_step
from softbodysim_tpu.solver.xpbd_pallas_sharded import (
    make_xpbd_pallas_sharded_step)

import softbodysim_torch as sbt
from softbodysim_torch.kernels import jacobi as kj
from softbodysim_torch.parallel import spawn

import torch_sharded_ranks

DT = 1.0 / 60.0
F = np.float32
FIELDS = ("x", "v", "x_star", "inv_mass", "edge_lambda", "tet_lambda")

JACOBI = dict(dialect="jacobi", substeps=1, iterations=2,
              edge_stiffness=0.9, volume_stiffness=0.98, sor_omega=1.4,
              particle_radius=0.02, gravity=(0.0, -10.0, 0.0),
              jacobi_backend="pallas", use_pallas="off")
CONTACT = dict(dialect="jacobi", substeps=1, iterations=2,
               jacobi_backend="pallas", use_pallas="off",
               particle_radius=0.04, self_collision=True,
               self_collision_cell=0.1, self_collision_max_per_cell=32,
               surface_collision=True, surface_thickness=0.03,
               surface_collision_max_per_cell=16)
XPBD = dict(dialect="xpbd", substeps=2, iterations=2, xpbd_backend="pallas")

CUBE_LOW = ("tet_cube", (7, 7, 7, 0.7, (0.0, 0.4, 0.0)))
CUBE_HIGH = ("tet_cube", (7, 7, 7, 0.7, (0.0, 0.9, 0.0)))
CLOTH = ("cloth", (9, 9))
BALLS = ("merged", [("tet_ball", (1, 0.22, (0.0, 0.35, 0.0))),
                    ("tet_ball", (1, 0.22, (0.40, 0.42, 0.0)))])
BALL = ("tet_ball", (1, 0.2, (0.0, 0.55, 0.0)))
SMALL_BALL = ("tet_ball", (1, 0.25, (0.0, 0.6, 0.0)))
BOX = ((0.0, 0.1, 0.0), (0.4, 0.1, 0.4))


def _jtopo(spec):
    kind, args = spec
    if kind == "cloth":
        return jmeshes.cloth_patch(*args)
    if kind == "merged":
        return jcombine([getattr(jmeshes, k)(*a) for k, a in args])[0], None
    return getattr(jmeshes, kind)(*args), None


def _arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def _start(spec, mode, seed=None, pinned=None):
    """The JAX package's initial state of ``spec`` (and its topology), the
    velocities drawn from ``seed`` when given."""
    topo, _ = _jtopo(spec)
    st = j_init_state(topo, pinned=pinned, inv_mass_mode=mode)
    if seed is not None:
        v = np.random.default_rng(seed).normal(
            0.0, 0.05, st.v.shape).astype(F)
        v[np.asarray(st.inv_mass) == 0.0] = 0.0
        st = dataclasses.replace(st, v=jnp.asarray(v))
    return topo, st


def _cols():
    return JColliders.build([
        JColliders.sphere((0.05, 0.18, 0.0), 0.2),
        JColliders.box((0.5, 0.1, 0.0), (0.15, 0.1, 0.15))])


def _col_arrays(c):
    return {k: np.asarray(getattr(c, k))
            for k in ("type", "position", "rotation", "data", "active")}


def _run(step, st, steps):
    xs = []
    for _ in range(steps):
        st = step(st, DT)
        xs.append(np.asarray(st.x))
    return np.stack(xs), st


# --------------------------------------------------------------------------
# The cases: (world, name) -> the ranks' inputs; the JAX reference of each
# --------------------------------------------------------------------------

def _cases():
    _, cube = _start(CUBE_LOW, "density", seed=1)
    cloth_topo, pinned = _jtopo(CLOTH)
    _, cloth = _start(CLOTH, "density", pinned=pinned)
    _, balls = _start(BALLS, "density")
    _, ball = _start(BALL, "tet")
    _, high = _start(CUBE_HIGH, "tet", seed=2)
    cube_case = ("stepped", dict(topology=CUBE_LOW, params=JACOBI,
                                 state=_arrays(cube), steps=5))
    return {
        1: {"xpbd_d1": ("stepped", dict(
                topology=BALL, params=XPBD, state=_arrays(ball), steps=12,
                colliders=_col_arrays(_cols()))),
            "engine_xpbd": ("engine", dict(
                topology=SMALL_BALL, params=dict(XPBD, iterations=3),
                steps=20, box=BOX))},
        2: {"jacobi_cube": cube_case,
            "jacobi_cloth": ("stepped", dict(
                topology=CLOTH, params=dict(JACOBI, ground_enabled=False),
                state=_arrays(cloth), steps=5)),
            "jacobi_contact": ("stepped", dict(
                topology=BALLS, params=CONTACT, state=_arrays(balls),
                steps=8)),
            "xpbd_d2": ("stepped", dict(
                topology=CUBE_HIGH, params=XPBD, state=_arrays(high),
                steps=3)),
            "engine_jacobi": ("engine", dict(
                topology=SMALL_BALL, params=dict(
                    JACOBI, iterations=3, use_pallas="auto"), steps=20)),
            "split_raises": ("raises", dict(
                topology=SMALL_BALL, params=dict(
                    XPBD, xpbd_block_scheme="split"))),
            "auto_xpbd": ("engine", dict(
                topology=SMALL_BALL, params=dict(
                    XPBD, iterations=3, xpbd_backend="auto"), steps=6,
                box=BOX)),
            "auto_jacobi": ("engine", dict(
                topology=SMALL_BALL, params=dict(
                    JACOBI, iterations=3, jacobi_backend="auto"),
                steps=20, box=BOX))},
        4: {"jacobi_cube": cube_case},
    }


# --------------------------------------------------------------------------
# The JAX references, each in a process of its own (spawned, so it imports
# this module; the conftest's environment -- the CPU platform, 8 host
# devices, no compile cache -- is inherited), while the ranks run
# --------------------------------------------------------------------------

def _ref_jacobi_cube():
    topo, st = _start(CUBE_LOW, "density", seed=1)
    xs, st = _run(make_jacobi_pallas_step(topo, JParams(**JACOBI),
                                          interpret=True), st, 5)
    return {"x": xs, "v": np.asarray(st.v)}


def _ref_jacobi_xla():
    """The cloth and the contact scene on the JAX package's XLA jacobi
    step ('gather'), which tests/test_jacobi_pallas.py holds equal to its
    Pallas step."""
    topo, pinned = _jtopo(CLOTH)
    _, st = _start(CLOTH, "density", pinned=pinned)
    cloth, _ = _run(j_make_step(topo, JParams(**dict(
        JACOBI, ground_enabled=False, jacobi_backend="gather"))), st, 5)
    topo, st = _start(BALLS, "density")
    contact, _ = _run(j_make_step(topo, JParams(**dict(
        CONTACT, jacobi_backend="gather"))), st, 8)
    return {"cloth": cloth, "contact": contact}


def _ref_xpbd_d1():
    topo, st = _start(BALL, "tet")
    xs, _ = _run(make_xpbd_pallas_step(topo, JParams(**XPBD),
                                       interpret=True, colliders=_cols()),
                 st, 12)
    return {"x": xs}


def _ref_xpbd_d2():
    topo, st = _start(CUBE_HIGH, "tet", seed=2)
    step = make_xpbd_pallas_sharded_step(
        topo, JParams(**XPBD), Mesh(np.asarray(jax.devices()[:2]),
                                    ("model",)))
    xs, st = _run(step, st, 3)
    fams = {}
    for name in ("edges", "tets"):
        f = step.shard_info[name]
        fams[name] = {"ghosts": [int(m.sum()) for m in f.ghost_mask],
                      "perm": [np.asarray(p.perm) for p in f.plans],
                      "scale": [np.asarray(p.scale).reshape(-1)
                                for p in f.plans]}
    return {"x": xs, "edge_lambda": np.asarray(st.edge_lambda),
            "tet_lambda": np.asarray(st.tet_lambda), **fams}


REFS = {"jacobi_cube": _ref_jacobi_cube, "jacobi_xla": _ref_jacobi_xla,
        "xpbd_d1": _ref_xpbd_d1, "xpbd_d2": _ref_xpbd_d2}


def _reference(name):
    return REFS[name]()


class _Background:
    """The ranks (the three worlds spawned one after another on a thread)
    and the JAX references (a process each), started when the module's
    first test runs."""

    def __init__(self):
        import multiprocessing

        self._pool = multiprocessing.get_context("spawn").Pool(len(REFS))
        self._refs = {n: self._pool.apply_async(_reference, (n,))
                      for n in REFS}
        self._out, self._err = {}, []
        cases = _cases()

        def work():
            try:
                for world, c in cases.items():
                    self._out[world] = spawn(torch_sharded_ranks.run_cases,
                                             world, c, timeout_s=300.0)
            except Exception as e:                # noqa: BLE001
                self._err.append(e)       # raised again by ranks()

        self._thread = threading.Thread(target=work)
        self._thread.start()

    def ranks(self, world):
        self._thread.join()
        if self._err:
            raise self._err[0]
        return self._out[world]

    def ref(self, name):
        return self._refs[name].get(timeout=600)

    def close(self):
        self._thread.join()
        self._pool.terminate()
        self._pool.join()


@pytest.fixture(scope="module", autouse=True)
def bg():
    b = _Background()
    yield b
    b.close()


def _same_on_every_rank(results, name):
    for r in results[1:]:
        for k in FIELDS:
            np.testing.assert_array_equal(r[name]["state"][k],
                                          results[0][name]["state"][k])


@pytest.mark.parametrize("family", ["edges", "tets"])
def test_accumulate_plain_matches_jax_apply_false(family):
    """The accumulate mode's plain version against the JAX pass built with
    apply=False, on one snapshot (interpret mode)."""
    topo = sbt.meshes.tet_cube(4, 4, 4, size=0.6, center=(0.0, 0.5, 0.0))
    nv = topo.num_particles
    rng = np.random.default_rng(12)
    x = (topo.vertices + rng.normal(0.0, 0.02, (nv, 3))).astype(F)
    w = sbt.init_state(topo, inv_mass_mode="density",
                       device="cpu").inv_mass.numpy().copy()
    w[[0, 7, 30]] = 0.0
    cons, rest, lcap = ((topo.edges, topo.edge_rest, 2) if family == "edges"
                        else (topo.tets, topo.tet_rest_vol, 3))
    nwin = -(-nv // 128)
    plan = jsw.pack_superblocks(np.asarray(cons, np.int64), rest, nwin,
                                layer_cap=lcap)
    jpass = jkj.make_jacobi_pass(plan, nwin, interpret=True, apply=False)
    x8 = np.zeros((8, nwin * 128), F)
    x8[0:3, :nv], x8[3, :nv] = x.T, w
    x8 = jnp.asarray(x8)
    acc = np.asarray(jpass(x8, F(0.9), F(1.4), jpass.fill_w(x8,
                                                            jpass.tables)))

    make = kj.edge_pass_plan if family == "edges" else kj.tet_pass_plan
    tplan = make(nv, cons, rest, device="cpu", vertices=topo.vertices)
    fn = (kj.jacobi_edge_accumulate if family == "edges"
          else kj.jacobi_tet_accumulate)
    out = torch.full((nv, 4), np.nan)
    before = fn.launches
    fn(tplan, torch.from_numpy(np.concatenate([x, w[:, None]], 1)), out,
       0.9)
    assert fn.launches == before                 # plain version on the CPU
    np.testing.assert_allclose(out[:, :3].numpy(), acc[0:3, :nv].T, rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(out[:, 3].numpy(), acc[3, :nv])
    assert np.abs(acc[0:3]).max() > 1e-4


@pytest.mark.parametrize("world", [2, 4])
def test_jacobi_sharded_matches_jax_single_device(bg, world):
    ref = bg.ref("jacobi_cube")
    res = bg.ranks(world)
    r = res[0]["jacobi_cube"]
    assert r["backend"] == "pass"
    # a partition with real ghosts
    assert any(sum(r[f]["ghosts"]) > 0 for f in ("edges", "tets"))
    for s in range(5):
        np.testing.assert_allclose(r["x"][s], ref["x"][s], rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(r["state"]["v"], ref["v"], rtol=0, atol=1e-4)
    assert ref["x"][-1][:, 1].min() < 0.1           # it reached the ground
    _same_on_every_rank(res, "jacobi_cube")


def test_jacobi_sharded_pinned_cloth(bg):
    topo, pinned = _jtopo(CLOTH)
    r = bg.ranks(2)[0]["jacobi_cloth"]
    np.testing.assert_allclose(r["x"][-1][pinned], topo.vertices[pinned],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(r["x"][-1], bg.ref("jacobi_xla")["cloth"][-1],
                               rtol=0, atol=1e-5)
    assert r["tets"] is None
    _same_on_every_rank(bg.ranks(2), "jacobi_cloth")


def test_jacobi_sharded_contact_matches_jax(bg):
    r = bg.ranks(2)[0]["jacobi_contact"]
    np.testing.assert_allclose(r["x"][-1],
                               bg.ref("jacobi_xla")["contact"][-1], rtol=0,
                               atol=1e-5)
    # the stages fired: the same scene without them ends elsewhere
    off = sbt.Engine(
        torch_sharded_ranks._topology(BALLS),
        sbt.SolverParams(**dict(CONTACT, jacobi_backend="segment",
                                self_collision=False,
                                surface_collision=False)), device="cpu")
    off.run(8, DT)
    assert np.abs(off.positions() - r["x"][-1]).max() > 1e-3
    _same_on_every_rank(bg.ranks(2), "jacobi_contact")


def test_xpbd_sharded_d1_matches_jax_single_device(bg):
    r = bg.ranks(1)[0]["xpbd_d1"]
    assert r["backend"] == "sweep"
    np.testing.assert_allclose(r["x"][-1], bg.ref("xpbd_d1")["x"][-1],
                               rtol=0, atol=1e-6)


def test_xpbd_sharded_d2_matches_jax_sharded(bg):
    ref = bg.ref("xpbd_d2")
    res = bg.ranks(2)
    r = res[0]["xpbd_d2"]
    for s in range(3):
        np.testing.assert_allclose(r["x"][s], ref["x"][s], rtol=0,
                                   atol=1e-5)
    for f in ("edge_lambda", "tet_lambda"):
        np.testing.assert_allclose(r["state"][f], ref[f], rtol=0, atol=1e-4)
    _same_on_every_rank(res, "xpbd_d2")
    # the partition: ownership, ghosts, packed order and the 1/k scales
    for name in ("edges", "tets"):
        jf = ref[name]
        assert jf["ghosts"] == r[name]["ghosts"]
        assert sum(r[name]["ghosts"]) > 0
        for d in range(2):
            mine = res[d]["xpbd_d2"][name]
            n = len(mine["perm"])
            np.testing.assert_array_equal(jf["perm"][d][:n], mine["perm"])
            assert (jf["perm"][d][n:] < 0).all()
            np.testing.assert_array_equal(jf["scale"][d][:n], mine["scale"])
        cross = np.concatenate([res[d]["xpbd_d2"][name]["cross"]
                                for d in range(2)])
        assert (cross == F(0.5)).any() and (cross == F(1.0)).any()


def test_engine_mesh_matches_single_device(bg):
    for world, name in ((1, "engine_xpbd"), (2, "engine_jacobi")):
        r = bg.ranks(world)[0][name]
        assert r["backends"][0] in ("sweep", "pass")
        np.testing.assert_allclose(r["sharded"], r["single"], rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(r["sharded_lam"], r["single_lam"],
                                   rtol=0, atol=1e-4)


def test_engine_mesh_refusals(bg):
    """'split' at D > 1 is refused; 'auto' on a small scene on the CPU
    steps on the vertex-sharded modes, as the single-device Engine."""
    r = bg.ranks(2)[0]
    kind, msg = r["split_raises"]
    assert kind == "ValueError" and "split" in msg
    for name in ("auto_xpbd", "auto_jacobi"):
        e = r[name]
        assert e["backends"] == ("gather", "gather")
        np.testing.assert_allclose(e["sharded"], e["single"], rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(e["sharded_lam"], e["single_lam"],
                                   rtol=0, atol=1e-4)
