"""Contact on the port -- the spatial-hash self stage
(``solver/spatial.py``), the vertex-triangle surface stage
(``solver/surface_collide.py``) and their wiring into the four step
backends -- against the JAX package on the CPU, inputs from a numpy seed.

Tolerances:
- the stage functions within 1e-6 (fp32 summation order only: the window
  sums, and the surface stage's integer-summed corner reactions, rounded
  to 2^-40 m each); the overflow counts, the autosized caps, the parking
  table and the suggested cell equal;
- whole steps within 1e-4 on positions and lambdas over 8 steps (the
  oracle parity contract): two tet_cube(2) bodies merged into one mesh,
  the upper one 1 cm over the lower one and shifted off its lattice, so
  both stages push from the first step; each backend against its JAX
  counterpart ('pass' against the JAX XLA jacobi step, the sweep step
  against the JAX Pallas step in interpret mode);
- a batch of coincident copies equal to its solo Engine bit for bit (no
  copy sees another), and to the JAX ``BatchedEngine`` within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import softbodysim_tpu as sbs
from softbodysim_tpu.core.adjacency import combine_topologies as j_combine
from softbodysim_tpu.core.state import init_state as j_init_state
from softbodysim_tpu.parallel.batching import BatchedEngine as JBatched
from softbodysim_tpu.solver import jacobi as jjac
from softbodysim_tpu.solver import spatial as jsp
from softbodysim_tpu.solver import surface_collide as jsc
from softbodysim_tpu.solver import xpbd as jxpbd
from softbodysim_tpu.solver import xpbd_pallas as jxp

import softbodysim_torch as sbt
from softbodysim_torch.core.adjacency import combine_topologies
from softbodysim_torch.io.from_jax import state_to_numpy
from softbodysim_torch.parallel import BatchedEngine, Group, \
    GroupedSceneEngine
from softbodysim_torch.solver import spatial as tsp
from softbodysim_torch.solver import surface_collide as tsc

DT = 1.0 / 60.0
STEPS = 8
CONTACT = dict(particle_radius=0.02, self_collision=True,
               self_collision_cell=0.05, self_collision_max_per_cell=0,
               surface_collision=True, surface_thickness=0.02)
XPBD = dict(dialect="xpbd", substeps=1, iterations=4,
            gravity=(0.0, -10.0, 0.0))
JACOBI = dict(dialect="jacobi", substeps=2, iterations=4,
              edge_stiffness=0.9, volume_stiffness=0.98, sor_omega=1.4,
              gravity=(0.0, -10.0, 0.0))
_ROT = np.array([[np.cos(0.3), 0, np.sin(0.3), 0.05], [0, 1, 0, 0.1],
                 [-np.sin(0.3), 0, np.cos(0.3), 0.0], [0, 0, 0, 1]],
                np.float32)
TRANSFORMS = dict(local_to_world=_ROT,
                  world_to_local=np.linalg.inv(_ROT).astype(np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tiny scenes run fastest on one core: under a parallel test
    run, torch's intra-op threads would only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(mod):
    """Two tet_cube(2) bodies (spacing 0.15 m) merged, the upper 1 cm over
    the lower and off its lattice (small meshes: the JAX steps compile in
    seconds)."""
    lo = mod.meshes.tet_cube(2, 2, 2, size=0.3, center=(0.0, 0.15, 0.0))
    hi = mod.meshes.tet_cube(2, 2, 2, size=0.3,
                             center=(0.037, 0.46, 0.023))
    merge = j_combine if mod is sbs else combine_topologies
    return merge([lo, hi])[0]


class _Static:
    """A hashable array, to pass the triangles as a static jit argument."""

    def __init__(self, a):
        self.a = np.asarray(a)

    def __array__(self, dtype=None, copy=None):
        return self.a if dtype is None else self.a.astype(dtype)

    def __hash__(self):
        return hash(self.a.tobytes())

    def __eq__(self, other):
        return isinstance(other, _Static) and np.array_equal(self.a,
                                                             other.a)


def _rand_points(seed, n, lo=0.0, hi=0.5):
    rng = np.random.default_rng(seed)
    p = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return p, w


# ---- the stage functions --------------------------------------------------

@pytest.mark.parametrize("case", ["all", "pinned", "own_slice"])
def test_self_collision_deltas_match_jax(case):
    p, w = _rand_points(1, 600)
    if case == "pinned":
        w[::7] = 0.0
    kw = dict(own_offset=100, own_count=200) if case == "own_slice" else {}
    jd, jo = jsp.self_collision_deltas(jnp.asarray(p), jnp.asarray(w), 0.03,
                                       0.06, 4, return_overflow=True, **kw)
    td, to = tsp.self_collision_deltas(torch.from_numpy(p),
                                       torch.from_numpy(w), 0.03, 0.06, 4,
                                       return_overflow=True, **kw)
    assert np.abs(np.asarray(jd)).max() > 0.01          # the stage pushes
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-6)
    assert int(jo) == int(to) > 0                       # a cap of 4 drops
    if case == "pinned":                                # pinned rows push
        assert np.abs(td.numpy()[::7]).max() == 0.0     # nothing of theirs


def test_closest_point_triangle_regions_match_jax():
    """A point in each of the seven Voronoi regions of one triangle, then
    random points against random triangles."""
    a, b, c = (np.array(v, np.float32) for v in
               ((0, 0, 0), (1, 0, 0), (0, 1, 0)))
    pts = np.array([[-0.5, -0.5, 0.2], [1.5, -0.2, 0.1], [-0.2, 1.5, -0.1],
                    [0.5, -0.5, 0.3], [-0.5, 0.5, 0.0], [0.8, 0.8, 0.2],
                    [0.2, 0.2, 0.5]], np.float32)
    want_bary = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0.5, 0.5, 0),
                 (0.5, 0, 0.5), (0, 0.5, 0.5), (0.6, 0.2, 0.2)]
    rng = np.random.default_rng(2)
    tri = rng.normal(size=(50, 3, 3)).astype(np.float32)
    q = rng.normal(size=(50, 3)).astype(np.float32)
    for p_, a_, b_, c_ in ((pts, a, b, c),
                           (q, tri[:, 0], tri[:, 1], tri[:, 2])):
        jc, jb = jsc.closest_point_triangle(*(jnp.asarray(v) for v in
                                              (p_, a_, b_, c_)))
        tc, tb = tsc.closest_point_triangle(*(torch.from_numpy(
            np.broadcast_to(v, p_.shape).copy()) for v in (p_, a_, b_, c_)))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
        if p_ is pts:
            np.testing.assert_allclose(tb.numpy(), want_bary, atol=1e-6)


@pytest.mark.parametrize("case", ["all", "own_slice"])
def test_surface_collision_deltas_match_jax(case):
    topo = sbs.meshes.tet_cube(3, 3, 3, size=0.5)
    rng = np.random.default_rng(3)
    v = topo.num_particles
    p = (np.asarray(topo.vertices)
         + rng.normal(0.0, 0.05, (v, 3))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, v).astype(np.float32)
    w[::5] = 0.0
    tris = np.asarray(topo.surface_tris)
    kw = dict(own_offset=10, own_count=30) if case == "own_slice" else {}
    jfn = jax.jit(jsc.surface_collision_deltas, static_argnums=(2, 3, 4, 5, 6),
                  static_argnames=("own_count",))
    jr = jfn(jnp.asarray(p), jnp.asarray(w), _Static(tris), 0.08, 0.2, 6,
             True, **kw)
    tr = tsc.surface_collision_deltas(torch.from_numpy(p),
                                      torch.from_numpy(w), tris, 0.08, 0.2,
                                      6, return_overflow=True, **kw)
    assert len(jr) == len(tr)
    for j, t in zip(jr[:-1], tr[:-1]):
        assert np.abs(np.asarray(j)).max() > 0.01
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-6)
    assert int(jr[-1]) == int(tr[-1]) > 0


def test_autosizers_and_parking_match_jax():
    topo = sbs.meshes.tet_cube(5, 5, 5, size=0.5)
    rest = np.asarray(topo.vertices)
    for cell, n in ((0.05, None), (0.11, None), (0.05, 1000)):
        assert tsp.required_max_per_cell(rest, cell, n) == \
            jsp.required_max_per_cell(rest, cell, n)
        fn_j = jsp.make_self_collision_fn(
            sbs.SolverParams(self_collision_cell=cell,
                             self_collision_max_per_cell=0), rest, n)
        fn_t = tsp.make_self_collision_fn(
            sbt.SolverParams(self_collision_cell=cell,
                             self_collision_max_per_cell=0), rest, n)
        assert fn_t.max_per_cell == fn_j.max_per_cell
    dead = np.random.default_rng(4).random(300) < 0.3
    np.testing.assert_array_equal(tsp.park_offsets(dead, 0.05, 0.02, 0.03),
                                  jsp.park_offsets(dead, 0.05, 0.02, 0.03))
    for h in (0.0, 0.02):
        assert tsc.suggested_cell_size(rest, topo.surface_tris, h) == \
            jsc.suggested_cell_size(rest, topo.surface_tris, h)


def test_spatial_stage_layout_equivalence_with_dead_lanes():
    """The port's form of tests/test_xpbd_collision.py's dead-lane test:
    a padded row layout with dead lanes parked in far cells changes
    nothing -- dead lanes get exactly zero delta, live lanes match the
    public layout within 1e-6 (table size and bucket order differ)."""
    rng = np.random.default_rng(0)
    V, vpad = 64, 128
    cell, radius, cap = 0.3, 0.15, 128
    p = rng.uniform(-0.4, 0.4, (V, 3)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, V).astype(np.float32)
    w[:5] = 0.0
    slots = rng.permutation(vpad)[:V]
    dead = np.ones(vpad, bool)
    dead[slots] = False
    x_rows = tsp.park_offsets(dead, cell, radius)
    x_rows[slots] = p
    w_rows = np.zeros(vpad, np.float32)
    w_rows[slots] = w
    d_pub = tsp.self_collision_deltas(torch.from_numpy(p),
                                      torch.from_numpy(w), radius, cell,
                                      cap).numpy()
    d_rows = tsp.self_collision_deltas(torch.from_numpy(x_rows),
                                       torch.from_numpy(w_rows), radius,
                                       cell, cap).numpy()
    assert np.abs(d_pub).max() > 0.1
    assert np.abs(d_rows[dead]).max() == 0.0
    np.testing.assert_allclose(d_rows[slots], d_pub, atol=1e-6)


def test_copies_hash_alone():
    """Four coincident copies in one table: each copy's deltas, overflow
    and surface reactions equal its solo call bit for bit."""
    topo = sbt.meshes.tet_cube(3, 3, 3, size=0.5)
    rng = np.random.default_rng(5)
    v = topo.num_particles
    p = (topo.vertices + rng.normal(0.0, 0.05, (v, 3))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, v).astype(np.float32)
    tp, tw = torch.from_numpy(p), torch.from_numpy(w)
    tris = torch.from_numpy(topo.surface_tris.astype(np.int64))
    bp, bw = tp.repeat(4, 1), tw.repeat(4)
    btris = torch.cat([tris + k * v for k in range(4)])
    solo = tsp.self_collision_deltas(tp, tw, 0.1, 0.3, 2, True)
    both = tsp.self_collision_deltas(bp, bw, 0.1, 0.3, 2, True, copies=4)
    torch.testing.assert_close(both[0], solo[0].repeat(4, 1), rtol=0,
                               atol=0)
    assert int(both[1]) == 4 * int(solo[1]) > 0
    solo = tsc.surface_collision_deltas(tp, tw, tris, 0.08, 0.2, 2, True)
    both = tsc.surface_collision_deltas(bp, bw, btris, 0.08, 0.2, 2, True,
                                        copies=4)
    torch.testing.assert_close(both[0], solo[0].repeat(4, 1), rtol=0,
                               atol=0)
    assert int(both[1]) == 4 * int(solo[1]) > 0


# ---- the steps ----------------------------------------------------------

def _jax_xpbd(backend):
    topo = _pair(sbs)
    params = sbs.SolverParams(**XPBD, **CONTACT, xpbd_backend=backend)
    if backend == "pallas":
        caps = []
        make = jxp.make_self_collision_fn

        def recording(*a, **k):
            fn = make(*a, **k)
            caps.append(fn.max_per_cell)
            return fn

        jxp.make_self_collision_fn = recording
        try:
            step = jxp.make_xpbd_pallas_step(topo, params, interpret=True)
        finally:
            jxp.make_self_collision_fn = make
    else:
        caps = None
        step = jxpbd.make_xpbd_step(topo, params)
    return topo, jax.jit(lambda s: step(s, DT)), caps


CHEBYSHEV = dict(chebyshev=True, chebyshev_rho=0.9, chebyshev_delay=2)


def _jax_jacobi(backend, variant):
    topo = _pair(sbs)
    params = sbs.SolverParams(**JACOBI, **CONTACT, jacobi_backend=backend,
                              **(CHEBYSHEV if variant == "chebyshev" else {}))
    kw = TRANSFORMS if variant == "transform" else {}
    return topo, jax.jit(lambda s: jjac.make_jacobi_step(
        topo, params, **kw)(s, DT)), None


@functools.lru_cache(maxsize=None)
def _jax_reference(dialect, backend, variant):
    """The JAX run's states after each of STEPS steps, and the JAX step's
    autosized cap where it was recorded."""
    if dialect == "xpbd":
        topo, step, caps = _jax_xpbd(backend)
        s = j_init_state(topo)
    else:
        topo, step, caps = _jax_jacobi(backend, variant)
        s = j_init_state(topo, inv_mass_mode="density")
    out = []
    for _ in range(STEPS):
        s = step(s)
        out.append({f: np.asarray(getattr(s, f)) for f in
                    ("x", "edge_lambda", "tet_lambda")})
    return out, caps


STEP_CASES = [("xpbd", "gather", "gather", None),
              ("xpbd", "sweep", "pallas", None),
              ("jacobi", "gather", "gather", None),
              ("jacobi", "segment", "segment", None),
              ("jacobi", "gather", "gather", "transform"),
              ("jacobi", "segment", "segment", "transform"),
              ("jacobi", "pass", "gather", None),
              ("jacobi", "pass", "gather", "chebyshev")]


@pytest.mark.parametrize("dialect,backend,jax_backend,variant", STEP_CASES)
def test_contact_steps_match_jax(dialect, backend, jax_backend, variant):
    """Each backend with contact on against its JAX counterpart; jacobi
    also under a body transform (the stages in world space) and with the
    Chebyshev blend after the stages."""
    topo = _pair(sbt)
    base = XPBD if dialect == "xpbd" else JACOBI
    knob = "xpbd_backend" if dialect == "xpbd" else "jacobi_backend"
    params = sbt.SolverParams(**base, **CONTACT, **{knob: backend}, **(
        CHEBYSHEV if variant == "chebyshev" else {}))
    kw = TRANSFORMS if variant == "transform" else {}
    eng = sbt.Engine(topo, params, device="cpu", **kw)
    off = sbt.Engine(topo, params.replace(self_collision=False,
                                          surface_collision=False),
                     device="cpu", **kw)
    assert eng.backend == backend
    want, caps = _jax_reference(dialect, jax_backend, variant)
    for k in range(STEPS):
        eng.step(DT)
        off.step(DT)
        got = state_to_numpy(eng.state)
        for f in ("x", "edge_lambda", "tet_lambda"):
            np.testing.assert_allclose(got[f], want[k][f], rtol=0,
                                       atol=1e-4, err_msg=f"{f}, step {k}")
    # the stages fired: contact moves the bodies by far more than 1e-4
    assert np.abs(eng.positions() - off.positions()).max() > 1e-2
    contact = eng._raw_step.contact
    if caps is not None:          # the sweep layout's cap is the JAX one
        assert [contact.self_fn.max_per_cell] == caps
    if backend != "sweep":        # the overflow counts in public order
        x, w = (jnp.asarray(getattr(eng.state, f).numpy())
                for f in ("x", "inv_mass"))
        caps = contact.caps
        want = {"self": jsp.self_collision_deltas(
            x, w, 0.02, caps["self_cell"], caps["self_max_per_cell"],
            True)[1], "surface": jsc.surface_collision_deltas(
            x, w, topo.surface_tris, 0.02, caps["surface_cell"],
            caps["surface_max_per_cell"], True)[1]}
        assert contact.overflow(eng.state.x, eng.state.inv_mass) == \
            {k: int(v) for k, v in want.items()}


def test_jacobi_cap_and_table_follow_public_order():
    """'pass' autosizes its cap off the rest vertices in public order, as
    the JAX XLA jacobi step does ('gather' here)."""
    topo = _pair(sbt)
    params = sbt.SolverParams(**JACOBI, **CONTACT)
    caps = {b: sbt.make_step(topo, params.replace(jacobi_backend=b),
                             device="cpu").contact.caps
            for b in ("pass", "gather", "segment")}
    assert caps["pass"] == caps["gather"] == caps["segment"]
    assert caps["pass"]["self_max_per_cell"] == jsp.make_self_collision_fn(
        sbs.SolverParams(**CONTACT), _pair(sbs).vertices).max_per_cell


def test_contact_off_builds_no_stage():
    """With both flags off, no backend builds a contact stage; surface
    collision on a mesh without surface triangles builds none either."""
    topo = _pair(sbt)
    for kw in (dict(XPBD, xpbd_backend="gather"),
               dict(XPBD, xpbd_backend="sweep"),
               dict(JACOBI, jacobi_backend="gather"),
               dict(JACOBI, jacobi_backend="pass")):
        assert sbt.make_step(topo, sbt.SolverParams(**kw),
                             device="cpu").contact is None
    cloth, _ = sbt.meshes.cloth_patch(4, 4)
    cloth = sbt.build_topology(cloth.vertices, cloth.tets, edges=cloth.edges,
                               surface_tris=np.zeros((0, 3), np.int64),
                               orient=False)
    assert sbt.make_step(cloth, sbt.SolverParams(
        **JACOBI, surface_collision=True), device="cpu").contact is None


# ---- batches: each copy hashed alone ---------------------------------------

def _copy_scene(mod):
    """One body whose contact stages fire on their own: a cube squeezed
    flat (self contact inside the body)."""
    return mod.meshes.tet_cube(3, 3, 3, size=0.3, center=(0.0, 0.4, 0.0))


BATCH_CONTACT = dict(CONTACT, particle_radius=0.06,
                     self_collision_cell=0.13)


@pytest.mark.parametrize("dialect", ["xpbd", "jacobi"])
def test_batch_copies_equal_solo_and_jax(dialect):
    """B = 4 coincident copies with contact on: each copy equals the solo
    Engine bit for bit (in one hash, coincident copies would push each
    other apart), and the JAX BatchedEngine (vmap) within 1e-4."""
    base = XPBD if dialect == "xpbd" else JACOBI
    params = sbt.SolverParams(**base, **BATCH_CONTACT)
    topo = _copy_scene(sbt)
    bat = BatchedEngine(topo, params, 4, device="cpu")
    solo = sbt.Engine(topo, params, device="cpu")
    bare = sbt.Engine(topo, params.replace(self_collision=False,
                                           surface_collision=False),
                      device="cpu")
    for _ in range(STEPS):
        bat.step(DT)
        solo.step(DT)
        bare.step(DT)
    x = bat.positions()
    for k in range(4):
        np.testing.assert_array_equal(x[k], solo.positions())
    assert np.abs(solo.positions() - bare.positions()).max() > 1e-3
    if dialect == "jacobi":       # (the JAX xpbd batch compiles for 15 s)
        jb = JBatched(_copy_scene(sbs),
                      sbs.SolverParams(**base, **BATCH_CONTACT), 4)
        for _ in range(STEPS):
            jb.step(DT)
        np.testing.assert_allclose(x, jb.positions(), rtol=0, atol=1e-4)


def test_grouped_family_copies_keep_to_themselves():
    """A grouped family of 3 instances at one spot, contact on: each
    instance equals the solo Engine bit for bit."""
    params = sbt.SolverParams(**JACOBI, **BATCH_CONTACT)
    topo = _copy_scene(sbt)
    eng = GroupedSceneEngine([Group(topo, np.zeros((3, 3)), params)],
                             device="cpu")
    solo = sbt.Engine(topo, params, device="cpu")
    for _ in range(4):
        eng.step(DT)
        solo.step(DT)
    for _, x in eng.positions():
        np.testing.assert_array_equal(x, solo.positions())
