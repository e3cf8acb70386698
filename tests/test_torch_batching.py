"""The port's batched, grouped-family and heterogeneous scene steps against
the JAX package's vmapped ones, on the CPU.

Tolerances: a batch of B = 3 scenes (tet_cube(2), 3 steps, plain and
per-scene stiffness, both dialects) within 1e-5 m of the JAX vmapped step
(velocities within 1e-5 m per substep, lambdas within 1e-4) from the same
start (the JAX batch's jittered state carried across as
NumPy); each scene of a port batch bitwise equal to its solo step (the
union's ops are per-row, each row's inputs are its own scene's); the
heterogeneous batch within 2e-5 m of its solo Engines over 15 steps (the
JAX test's bound) and within 1e-5 m of the JAX HeteroEngine.
"""

import numpy as np
import pytest
import torch

import jax

from softbodysim_tpu import SolverParams as JParams
from softbodysim_tpu.core import meshes as jmeshes
from softbodysim_tpu.parallel import batching as jbatching
from softbodysim_tpu.parallel.hetero import HeteroEngine as JHeteroEngine

import softbodysim_torch as sbt
from softbodysim_torch.core import meshes
from softbodysim_torch.io.from_jax import (batched_state_from_numpy,
                                           params_from_fields, state_to_numpy)
from softbodysim_torch.kernels import collide as kc
from softbodysim_torch.parallel import (BatchedEngine, HeteroEngine,
                                        init_batch_state, make_batched_step,
                                        sample_stiffness)

DT = 1.0 / 60.0
B = 3
JAX_TOL = 1e-5
CUBE = dict(nx=2, ny=2, nz=2, size=0.5, center=(0.0, 0.5, 0.0))
DIALECTS = {
    "xpbd": dict(dialect="xpbd", substeps=2, iterations=4),
    "jacobi": dict(dialect="jacobi", substeps=2, iterations=4,
                   jacobi_backend="gather"),
}
# per-scene (edge, volume) values: compliance for xpbd, stiffness for jacobi
PER_SCENE = {"xpbd": ([1e-4, 5e-4, 2e-3], [0.0, 1e-5, 1e-4]),
             "jacobi": ([0.9, 0.5, 0.2], [0.98, 0.7, 0.4])}


@pytest.fixture(scope="module", params=sorted(DIALECTS))
def jax_batches(request):
    """The JAX batched step from a jittered start: (dialect, start arrays,
    {randomized: end arrays after 3 steps})."""
    dialect = request.param
    jtopo = jmeshes.tet_cube(**CUBE)
    jparams = JParams(**DIALECTS[dialect])
    inv_mode = "tet" if dialect == "xpbd" else "density"
    s0 = jbatching.init_batch_state(jtopo, B, inv_mass_mode=inv_mode,
                                    key=jax.random.PRNGKey(3),
                                    pos_jitter=0.01)
    start = state_to_numpy_like(s0)
    ends = {}
    for randomized in (False, True):
        step = jax.jit(jbatching.make_batched_step(
            jtopo, jparams, randomized_stiffness=randomized))
        s = s0
        extra = ([np.asarray(a, np.float32) for a in PER_SCENE[dialect]]
                 if randomized else [])
        for _ in range(3):
            s = step(s, DT, *extra)
        ends[randomized] = state_to_numpy_like(s)
    return dialect, start, ends


def state_to_numpy_like(s):
    return {k: np.asarray(getattr(s, k)) for k in (
        "x", "v", "x_star", "inv_mass", "edge_lambda", "tet_lambda")}


@pytest.mark.parametrize("randomized", [False, True])
def test_batched_step_matches_jax_vmap(jax_batches, randomized):
    dialect, start, ends = jax_batches
    topo = meshes.tet_cube(**CUBE)
    params = params_from_fields(JParams(**DIALECTS[dialect]))
    step = make_batched_step(topo, params, randomized_stiffness=randomized,
                             device="cpu")
    assert step.backend == "gather"
    s = batched_state_from_numpy(start, B, "cpu")
    extra = [torch.tensor(a) for a in PER_SCENE[dialect]] if randomized \
        else []
    for _ in range(3):
        s = step(s, DT, *extra)
    got = state_to_numpy(s)
    assert got["x"].shape == (B, topo.num_particles, 3)
    # positions in m; a velocity is a position difference over a substep;
    # lambdas at the oracle parity bound
    sdt = DT / params.substeps
    for f, tol in (("x", JAX_TOL), ("v", JAX_TOL / sdt),
                   ("edge_lambda", 1e-4), ("tet_lambda", 1e-4)):
        np.testing.assert_allclose(got[f], ends[randomized][f], rtol=0,
                                   atol=tol, err_msg=f)
    if randomized:                   # the scenes differ
        assert np.abs(got["x"][0] - got["x"][2]).max() > 1e-5


@pytest.mark.parametrize("dialect", sorted(DIALECTS))
def test_batched_scenes_equal_solo_steps(dialect, monkeypatch):
    """Each scene of a batch is its solo step, bitwise; with colliders the
    collide stage runs once per iteration for all B scenes."""
    topo = meshes.tet_cube(**CUBE)
    params = sbt.SolverParams(**DIALECTS[dialect])
    box = sbt.Colliders.build([sbt.Colliders.box((0.1, 0.25, 0.0),
                                                 (0.3, 0.05, 0.3))],
                              device="cpu")
    calls = []
    plain = kc.collide_positions
    monkeypatch.setattr(kc, "collide_positions",
                        lambda p, *a: calls.append(len(p)) or plain(p, *a))
    eng = BatchedEngine(topo, params, B, colliders=box, device="cpu")
    solo = sbt.Engine(topo, params, colliders=box, device="cpu")
    for _ in range(4):
        eng.step(DT)
        solo.step(DT)
    pos = eng.positions()
    for b in range(B):
        np.testing.assert_array_equal(pos[b], solo.positions())
    per_step = params.substeps * params.iterations
    assert calls[:per_step] == [B * topo.num_particles] * per_step


def test_batch_refuses_kernel_backends():
    """With the JAX package's words for its Pallas steps."""
    topo = meshes.tet_cube(**CUBE)
    for kw in (dict(xpbd_backend="sweep"),
               dict(dialect="jacobi", jacobi_backend="pallas")):
        with pytest.raises(ValueError, match="cannot be vmapped") as got:
            BatchedEngine(topo, sbt.SolverParams(**kw), 2, device="cpu")
        with pytest.raises(ValueError) as want:
            jbatching.make_batched_step(
                jmeshes.tet_cube(**CUBE),
                JParams(**{k: "pallas" if k.endswith("backend") else v
                           for k, v in kw.items()}))
        assert str(got.value) == str(want.value)


def test_init_batch_state_and_sampling():
    topo = meshes.tet_cube(**CUBE)
    g = torch.Generator().manual_seed(11)
    st = init_batch_state(topo, 4, pos_jitter=0.01, key=g, device="cpu")
    assert tuple(st.x.shape) == (4, topo.num_particles, 3)
    assert not torch.equal(st.x[0], st.x[1])
    assert torch.equal(st.x_star, st.x) and st.x_star is not st.x
    again = init_batch_state(topo, 4, pos_jitter=0.01,
                             key=torch.Generator().manual_seed(11),
                             device="cpu")
    assert torch.equal(again.x, st.x)                 # seeded
    flat = init_batch_state(topo, 2, device="cpu")
    assert torch.equal(flat.x[1], torch.from_numpy(topo.vertices))
    ks = sample_stiffness(torch.Generator().manual_seed(7), 8, 0.2, 1.0,
                          device="cpu")
    assert ks.shape == (8,) and ks.min() >= 0.2 and ks.max() < 1.0
    with pytest.raises(ValueError):
        batched_state_from_numpy(state_to_numpy(flat), 3, "cpu")


def test_randomized_stiffness_diversifies():
    topo = meshes.tet_cube(2, 2, 2, center=(0.0, 0.4, 0.0))
    params = sbt.SolverParams(dialect="jacobi", substeps=2, iterations=4)
    ks = sample_stiffness(torch.Generator().manual_seed(7), 6, 0.2, 1.0,
                          device="cpu")
    eng = BatchedEngine(topo, params, 6, randomized_stiffness=True,
                        device="cpu")
    for _ in range(20):
        eng.step(DT, ks, torch.full((6,), 0.98))
    pos = eng.positions()
    assert np.isfinite(pos).all()
    assert (np.abs(pos - pos[:1]).max(axis=(1, 2))[1:] > 1e-4).all()
    with pytest.raises(TypeError):
        eng.step(DT)


# ---- heterogeneous batches --------------------------------------------------

def _hetero_bodies(mod):
    cloth, pins = mod.cloth_patch(6, 6, size=0.5, height=0.8)
    return [cloth, mod.tet_ball(1, 0.2, (1.0, 0.8, 0.0)),
            mod.tet_cube(2, 2, 2, 0.4, (-1.0, 0.9, 0.0))], pins


HETERO = dict(dialect="jacobi", substeps=2, iterations=4,
              jacobi_backend="gather", ground_enabled=True)


def test_hetero_matches_solo_engines_and_jax():
    topos, pins = _hetero_bodies(meshes)
    params = sbt.SolverParams(**HETERO)
    box = [sbt.Colliders.box((1.0, 0.35, 0.0), (0.4, 0.05, 0.4))]
    het = HeteroEngine(topos, params, pinned=[pins, None, None],
                       colliders=sbt.Colliders.build(box, device="cpu"),
                       device="cpu")
    solos = [sbt.Engine(t, params, pinned=p, device="cpu",
                        colliders=sbt.Colliders.build(box, device="cpu"))
             for t, p in zip(topos, [pins, None, None])]
    jtopos, jpins = _hetero_bodies(jmeshes)
    from softbodysim_tpu.collide.primitives import Colliders as JColliders
    jhet = JHeteroEngine(jtopos, JParams(**HETERO),
                         colliders=JColliders.build(box),
                         pinned=[jpins, None, None])
    for _ in range(15):
        het.step(DT)
        jhet.step(DT)
        for s in solos:
            s.step(DT)
    got = het.positions()
    for i, (g, s, j) in enumerate(zip(got, solos, jhet.positions())):
        np.testing.assert_allclose(g, s.positions(), rtol=0, atol=2e-5,
                                   err_msg=f"body {i} vs solo")
        np.testing.assert_allclose(g, j, rtol=0, atol=JAX_TOL,
                                   err_msg=f"body {i} vs JAX")
    np.testing.assert_allclose(got[0][pins], topos[0].vertices[pins],
                               atol=1e-6)
    assert got[1][:, 1].mean() < topos[1].vertices[:, 1].mean()
    # padded rows: pinned at the origin, untouched
    xs = het.state.x.numpy()
    for i, t in enumerate(topos):
        assert np.abs(xs[i, t.num_particles:]).max(initial=0.0) == 0.0


def test_hetero_rejects_xpbd():
    topos, _ = _hetero_bodies(meshes)
    with pytest.raises(ValueError):
        HeteroEngine(topos[1:], sbt.SolverParams(), device="cpu")
