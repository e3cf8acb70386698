"""The port's xpbd dialect at every scene size on the CPU: the coloured
Gauss-Seidel backend ('gather', and 'scatter', its alias) against the NumPy
oracle in colour order (serial Gauss-Seidel in colour-major order is the
coloured sweep exactly) and against the JAX package's ``make_xpbd_step``
with each of its two coloured backends, the backend 'auto' picks, the card
as default device, and what the coloured backend refuses.  Colliders and the step's overrides
against the JAX package are in test_torch_xpbd_colliders.py.

Tolerance: positions and lambdas 1e-4, velocities 1e-3, over 10-15 steps
through ground contact.  The port's tet_cube(3) run is made once per module
and held against the oracle and both JAX backends.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from softbodysim_tpu import SolverParams as JParams
from softbodysim_tpu.core import meshes as jmeshes
from softbodysim_tpu.core.state import init_state as j_init_state
from softbodysim_tpu.solver import make_xpbd_step as j_make_xpbd_step

import softbodysim_torch as sbt
from softbodysim_torch.io.from_jax import state_to_numpy
from softbodysim_torch.solver import make_xpbd_step
from softbodysim_torch.solver.select import resolve_backend

from oracle import XpbdOracle

DT = 1.0 / 60.0
CUBES = {"cube2": (2, 0.5, (0.0, 0.27, 0.0)),
         "cube3": (3, 0.5, (0.0, 0.3, 0.0))}


STEPS = {"cube2": 10, "cube3": 15}
PARAMS = dict(dialect="xpbd", substeps=2, iterations=4)


def _cube(spec):
    n, size, center = spec
    return sbt.meshes.tet_cube(n, n, n, size=size, center=center)


@functools.lru_cache(maxsize=None)
def _port_run(cube):
    """(topology, state) after STEPS[cube] steps of the port's coloured
    step on the CPU."""
    topo = _cube(CUBES[cube])
    step = make_xpbd_step(topo, sbt.SolverParams(**PARAMS), device="cpu")
    assert step.backend == "gather"
    s = sbt.init_state(topo, device="cpu")
    for _ in range(STEPS[cube]):
        s = step(s, DT)
    return topo, s


@pytest.mark.parametrize("cube", list(CUBES))
def test_coloured_matches_oracle_colour_order(cube):
    """Through ground contact: the serial oracle in colour-major order is
    the coloured sweep exactly."""
    topo, s = _port_run(cube)
    oracle = XpbdOracle(topo, sbt.SolverParams(**PARAMS))
    for _ in range(STEPS[cube]):
        oracle.step(DT, edge_order=topo.edge_colors.order,
                    tet_order=topo.tet_colors.order)
    np.testing.assert_allclose(s.x.numpy(), oracle.x, rtol=0, atol=1e-4)
    np.testing.assert_allclose(s.v.numpy(), oracle.v, rtol=0, atol=1e-3)
    np.testing.assert_allclose(s.edge_lambda.numpy(), oracle.edge_lambda,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(s.tet_lambda.numpy(), oracle.tet_lambda,
                               rtol=0, atol=1e-4)
    assert s.x[:, 1].min() <= 1e-6          # the cube reached the ground


@pytest.mark.parametrize("backend", ["gather", "scatter"])
def test_coloured_matches_jax_make_xpbd_step(backend):
    """tet_cube(3) through ground contact, 15 steps, against the JAX step
    with each JAX backend name (the port's 'scatter' is its 'gather', which
    test_scatter_is_an_alias_of_gather holds bit for bit)."""
    n, size, center = CUBES["cube3"]
    jtopo = jmeshes.tet_cube(n, n, n, size=size, center=center)
    jstep = jax.jit(lambda s: j_make_xpbd_step(
        jtopo, JParams(**PARAMS, xpbd_backend=backend))(s, DT))
    js = j_init_state(jtopo)
    for _ in range(STEPS["cube3"]):
        js = jstep(js)
    out = state_to_numpy(_port_run("cube3")[1])
    for f, tol in (("x", 1e-4), ("v", 1e-3), ("edge_lambda", 1e-4),
                   ("tet_lambda", 1e-4)):
        np.testing.assert_allclose(out[f], np.asarray(getattr(js, f)),
                                   rtol=0, atol=tol, err_msg=f)
    assert out["x"][:, 1].min() <= 1e-6


def test_scatter_is_an_alias_of_gather():
    """'scatter' resolves to 'gather' on every device and steps bit for bit
    as 'gather' does."""
    topo = _cube(CUBES["cube2"])
    params = sbt.SolverParams(dialect="xpbd", substeps=1, iterations=2,
                              xpbd_backend="scatter")
    for dev in ("cpu", "cuda"):
        assert resolve_backend(topo, params, device=dev) == "gather"
    a = make_xpbd_step(topo, params, device="cpu")
    b = make_xpbd_step(topo, params.replace(xpbd_backend="gather"),
                       device="cpu")
    assert a.backend == b.backend == "gather"
    sa = sb = sbt.init_state(topo, device="cpu")
    for _ in range(2):
        sa, sb = a(sa, DT), b(sb, DT)
    for f in ("x", "v", "edge_lambda", "tet_lambda"):
        torch.testing.assert_close(getattr(sa, f), getattr(sb, f), rtol=0,
                                   atol=0)


def test_engine_auto_gives_gather_on_cpu():
    topo = _cube(CUBES["cube2"])
    eng = sbt.Engine(topo, sbt.SolverParams(dialect="xpbd"), device="cpu")
    assert eng.backend == "gather"
    eng.run(5)
    assert np.isfinite(eng.positions()).all()
    assert eng.state.edge_lambda.abs().max() > 0


def test_xpbd_without_device_raises_without_card(monkeypatch):
    """Entry points default to the card: without one, a call that does not
    pass device="cpu" raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = _cube(CUBES["cube2"])
    for make in (lambda: sbt.Engine(topo, sbt.SolverParams()),
                 lambda: make_xpbd_step(topo, sbt.SolverParams())):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_coloured_backends_refuse_what_they_lack():
    topo = _cube(CUBES["cube2"])
    params = sbt.SolverParams(xpbd_backend="gather")
    with pytest.raises(ValueError):
        make_xpbd_step(topo, params, device="cpu",
                       edge_c=np.ones(topo.num_edges, np.float32))
    with pytest.raises(ValueError):
        make_xpbd_step(topo, params, device="cpu", superblocks=False)
    # self collision is ported: the step builds and its stage fires (a
    # radius over the lattice spacing pushes neighbours apart)
    step = make_xpbd_step(topo, params.replace(
        self_collision=True, particle_radius=0.2, self_collision_cell=0.4),
        device="cpu")
    plain = make_xpbd_step(topo, params, device="cpu")
    s = sbt.init_state(topo, device="cpu")
    assert step.contact.self_fn is not None and plain.contact is None
    assert (step(s, 1.0 / 60.0).x - plain(s, 1.0 / 60.0).x).abs().max() \
        > 1e-3


@pytest.mark.parametrize("alpha", [(0.0, 0.0), (3.6e-3, 1.25e-4)])
def test_coloured_solve_reads_alpha_tensors_bitwise(alpha):
    """The coloured iteration with the compliance scalars as 0-dim float32
    tensors (views of one (2,) tensor, as the card's graph reads them)
    gives the bits of the same float32-exact floats."""
    topo = _cube(CUBES["cube3"])
    step = make_xpbd_step(topo, sbt.SolverParams(**PARAMS), device="cpu")
    s = sbt.init_state(topo, device="cpu")
    rng = np.random.default_rng(5)
    x = s.x + torch.from_numpy(rng.normal(0.0, 0.01, s.x.shape).astype(
        np.float32))
    floats = [float(np.float32(a)) for a in alpha]
    tensor = torch.tensor(floats, dtype=torch.float32)
    lam0 = {fam: torch.from_numpy(rng.normal(0.0, 1e-3, n).astype(
        np.float32)) for fam, n in (("edges", topo.num_edges),
                                    ("tets", topo.num_tets))}
    outs = []
    for a in (floats, tensor.unbind()):
        lam = {fam: v.clone() for fam, v in lam0.items()}
        outs.append((step._solve(x, s.inv_mass, lam, *a), lam))
    assert torch.equal(outs[0][0], outs[1][0])
    for fam in lam0:
        assert torch.equal(outs[0][1][fam], outs[1][1][fam])
    assert not torch.equal(outs[0][0], x)


@pytest.mark.parametrize("alpha", [(0.0, 0.0), (3.6e-3, 1.25e-4)])
def test_coloured_solve_reads_alpha_tables_bitwise(alpha):
    """The coloured iteration with the compliance as uniform colour-major
    (n,) tables, as the card's graph reads them, gives the bits of the
    same float32-exact floats; a table that is not uniform changes the
    result."""
    topo = _cube(CUBES["cube3"])
    step = make_xpbd_step(topo, sbt.SolverParams(**PARAMS), device="cpu")
    s = sbt.init_state(topo, device="cpu")
    rng = np.random.default_rng(5)
    x = s.x + torch.from_numpy(rng.normal(0.0, 0.01, s.x.shape).astype(
        np.float32))
    floats = [float(np.float32(a)) for a in alpha]
    counts = (topo.num_edges, topo.num_tets)
    lam0 = {fam: torch.from_numpy(rng.normal(0.0, 1e-3, n).astype(
        np.float32)) for fam, n in zip(("edges", "tets"), counts)}
    uniform = [torch.full((n,), a, dtype=torch.float32)
               for a, n in zip(floats, counts)]
    ramp = [t * torch.linspace(0.5, 1.5, len(t)) + 1e-3 for t in uniform]
    outs = []
    for a in (floats, uniform, ramp):
        lam = {fam: v.clone() for fam, v in lam0.items()}
        outs.append((step._solve(x, s.inv_mass, lam, *a), lam))
    assert torch.equal(outs[0][0], outs[1][0])
    for fam in lam0:
        assert torch.equal(outs[0][1][fam], outs[1][1][fam])
    assert not torch.equal(outs[0][0], outs[2][0])
