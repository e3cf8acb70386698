"""The port's slice end to end: Engine on the sweep backend against the JAX
package's Pallas step in interpret mode (tet_cube(4), 2 substeps x
4 iterations), the carry API, and the errors of what is not ported yet.

Tolerances: x, v and both lambdas within 1e-4 over 10 steps (the oracle
parity contract); x within 1e-2 over 40 steps, through ground contact,
where ULP-level sum-order differences grow chaotically.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from softbodysim_tpu import SolverParams as JParams
from softbodysim_tpu.core import meshes as jmeshes
from softbodysim_tpu.core.state import init_state as j_init_state
from softbodysim_tpu.solver.xpbd_pallas import make_xpbd_pallas_step

import softbodysim_torch as sbt
from softbodysim_torch.io.from_jax import (params_from_fields,
                                           state_from_numpy, state_to_numpy)
from softbodysim_torch.kernels import launch_counts
from softbodysim_torch.solver.select import resolve_backend

DT = 1.0 / 60.0
CUBE4 = dict(nx=4, ny=4, nz=4, size=0.5, center=(0.0, 0.6, 0.0))


def _topo():
    return sbt.meshes.tet_cube(**CUBE4)


def _sweep_params(**kw):
    return sbt.SolverParams(**{**dict(dialect="xpbd", substeps=2,
                                      iterations=4, xpbd_backend="sweep"),
                               **kw})


def test_slice_matches_jax_interpret():
    jtopo = jmeshes.tet_cube(**CUBE4)
    jparams = JParams(dialect="xpbd", substeps=2, iterations=4)
    jstep = make_xpbd_pallas_step(jtopo, jparams, interpret=True)
    jstate = j_init_state(jtopo)
    start = {f.name: np.asarray(getattr(jstate, f.name))
             for f in dataclasses.fields(jstate)}

    params = params_from_fields(jparams).replace(xpbd_backend="pallas")
    assert params == _sweep_params().replace(xpbd_backend="pallas")
    eng = sbt.Engine(_topo(), params, device="cpu")
    assert eng.backend == "sweep"
    eng.state = state_from_numpy(start, "cpu")
    step = eng._raw_step
    assert step.block_scheme == jstep.block_scheme
    for fam in ("edges", "tets"):
        np.testing.assert_array_equal(step.block_order[fam].perm,
                                      jstep.block_order[fam].perm)

    for burst in range(4):
        jstate = jstep.step_n(jstate, DT, 10)
        eng.run(10, DT)
        if burst == 0:
            got = state_to_numpy(eng.state)
            for f in ("x", "v", "x_star", "edge_lambda", "tet_lambda"):
                np.testing.assert_allclose(got[f], np.asarray(
                    getattr(jstate, f)), rtol=0, atol=1e-4, err_msg=f)
    x = eng.positions()
    np.testing.assert_allclose(x, np.asarray(jstate.x), rtol=0, atol=1e-2)
    assert x[:, 1].min() > -1e-4
    assert x[:, 1].min() < 0.01          # the cube reached the ground


def test_run_carry_equals_single_steps():
    step = sbt.make_step(_topo(), _sweep_params(), device="cpu")
    s0 = sbt.init_state(_topo(), device="cpu")
    carry = step.pack_state(s0)
    step.run_carry(carry, DT, 5)
    a = step.unpack_state(carry, s0)
    b = s0
    for _ in range(5):
        b = step(b, DT)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert torch.equal(step.carry_positions(carry), a.x)
    c = step.step_n(s0, DT, 5)
    assert torch.equal(c.x, a.x)


def test_engine_step_run_and_lazy_state():
    eng = sbt.Engine(_topo(), _sweep_params(), device="cpu")
    eng.run(3, DT)
    assert eng._state_stale
    p = eng.positions()
    assert p.shape == (_topo().num_particles, 3) and np.isfinite(p).all()
    eng.step(DT, edge_compliance=1e-3)
    v = eng.velocities()
    assert not eng._state_stale and np.isfinite(v).all()
    assert v[:, 1].mean() < 0.0                 # falling
    eng.switch_params(_sweep_params(iterations=2))
    eng.run(2, DT)
    eng.reset()
    np.testing.assert_array_equal(eng.positions(), _topo().vertices)


def test_disconnected_pinned_mesh_matches_block_oracle():
    """Two bodies (component-aligned layout with dead slots between them)
    and pinned vertices, against the block oracle replaying the port's
    plans: 10 steps at 1e-4."""
    from oracle import XpbdOracle
    from test_torch_plans import two_bodies

    topo = sbt.build_topology(*two_bodies())
    params = _sweep_params(substeps=2, iterations=3)
    pinned = [0, 5, 70]
    eng = sbt.Engine(topo, params, pinned=pinned, device="cpu")
    step = eng._raw_step
    oracle = XpbdOracle(topo, params, pinned=pinned)
    oracle.w = eng.state.inv_mass.numpy().copy()

    def blocks(plan):
        rows, scl = plan.perm.reshape(-1, 1024), plan.scale.reshape(-1, 1024)
        return [(r[r >= 0], s[r >= 0]) for r, s in zip(rows, scl)
                if (r >= 0).any()]

    eb = blocks(step.block_order["edges"])
    tb = blocks(step.block_order["tets"])
    for _ in range(10):
        eng.step(DT)
        oracle.step_blocks(DT, edge_blocks=eb, tet_blocks=tb,
                           **step.block_scheme)
    s = eng.state
    np.testing.assert_allclose(s.x.numpy(), oracle.x, rtol=0, atol=1e-4)
    np.testing.assert_allclose(s.edge_lambda.numpy(), oracle.edge_lambda,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(s.tet_lambda.numpy(), oracle.tet_lambda,
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(s.x.numpy()[pinned],
                                  topo.vertices[pinned])


def test_per_constraint_compliance_identity():
    """Uniform per-constraint compliance tables equal to the scalars
    reproduce the scalar path exactly."""
    topo = sbt.meshes.tet_cube(3, 3, 3, size=0.5, center=(0.0, 0.4, 0.0))
    params = _sweep_params(edge_compliance=5e-4, volume_compliance=1e-5)
    a = sbt.make_step(topo, params, device="cpu")
    b = sbt.make_step(
        topo, params, device="cpu",
        edge_c=np.full(topo.num_edges, 5e-4, np.float32),
        tet_c=np.full(topo.num_tets, 1e-5, np.float32))
    sa = sb = sbt.init_state(topo, device="cpu")
    for _ in range(6):
        sa = a(sa, DT)
        sb = b(sb, DT)
    assert torch.equal(sa.x, sb.x)
    assert torch.equal(sa.edge_lambda, sb.edge_lambda)
    assert torch.equal(sa.tet_lambda, sb.tet_lambda)


def test_no_kernel_launch_on_cpu():
    before = launch_counts()
    sbt.Engine(_topo(), _sweep_params(), device="cpu").run(2, DT).positions()
    assert launch_counts() == before


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        sbt.Engine(_topo(), _sweep_params(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        sbt.init_state(_topo(), device="cuda")


@pytest.mark.parametrize("case", [
    "colliders", "bfloat16", "gather", "auto_small", "jacobi", "mesh",
    "self_collision", "colliders_rt"])
def test_unported_features_raise(case, tmp_path):
    """What is not ported raises NotImplementedError pointing at ROADMAP.md.
    Cases ported since ("colliders" on the sweep backend, the "bfloat16"
    particle table on it, the coloured "gather" backend, "auto" on a small
    scene, the "jacobi" dialect with self collision and "self_collision"
    on the sweep backend) now step; a runtime collider set without a
    make-time template ("colliders_rt") is refused.  "mesh" is ported: on a
    gloo group of one the kernel-sharded step and the vertex-sharded step
    ('auto' on a small scene) step to the single-device Engine's bits."""
    topo = _topo()
    kw = {}
    params = _sweep_params()
    if case == "colliders":           # colliders on the xpbd sweep backend
        kw["colliders"] = sbt.Colliders.build(
            [sbt.Colliders.sphere((0.0, 0.0, 0.0), 0.1)], device="cpu")
    elif case == "bfloat16":
        params = params.replace(xpbd_x_dtype="bfloat16")
    elif case == "gather":
        params = params.replace(xpbd_backend="gather")
    elif case == "auto_small":
        params = params.replace(xpbd_backend="auto")
    elif case == "jacobi":            # with self collision
        params = params.replace(dialect="jacobi", self_collision=True)
    elif case == "mesh":
        return _check_mesh_of_one(topo, params, tmp_path)
    elif case == "self_collision":
        params = params.replace(self_collision=True)
    if case == "colliders_rt":
        eng = sbt.Engine(topo, params, device="cpu")
        with pytest.raises(ValueError, match="template"):
            eng.step(DT, colliders_rt=sbt.Colliders.build(
                [sbt.Colliders.sphere((0.0, 0.0, 0.0), 0.1)], device="cpu"))
        return
    eng = sbt.Engine(topo, params, device="cpu", **kw).run(2, DT)
    assert np.isfinite(eng.positions()).all()
    assert eng.backend == ("sweep" if case in ("colliders", "bfloat16",
                                               "self_collision")
                           else "gather")
    if case == "bfloat16":
        assert eng._carry.xw.dtype == torch.bfloat16
    if case in ("jacobi", "self_collision"):
        assert eng._raw_step.contact.self_fn is not None


def _check_mesh_of_one(topo, params, tmp_path):
    import torch.distributed as dist

    from softbodysim_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        eng = sbt.Engine(topo, params, device="cpu", mesh=mesh).run(2, DT)
        ref = sbt.Engine(topo, params, device="cpu").run(2, DT)
        assert eng.backend == "sweep"
        assert np.array_equal(eng.positions(), ref.positions())
        auto = params.replace(xpbd_backend="auto")
        eng = sbt.Engine(topo, auto, device="cpu", mesh=mesh).run(2, DT)
        ref = sbt.Engine(topo, auto, device="cpu").run(2, DT)
        assert eng.backend == "gather"
        assert np.array_equal(eng.positions(), ref.positions())
        assert np.array_equal(eng.state.edge_lambda.numpy(),
                              ref.state.edge_lambda.numpy())
    finally:
        dist.destroy_process_group()


def test_backend_selection(monkeypatch):
    big = types.SimpleNamespace(num_edges=60_000, num_tets=40_000)
    small = types.SimpleNamespace(num_edges=60_000, num_tets=39_999)
    auto = sbt.SolverParams()
    assert resolve_backend(big, auto, device="cpu") == "gather"
    assert resolve_backend(small, auto, device="cpu") == "gather"
    assert resolve_backend(small, auto.replace(xpbd_backend="pallas")) \
        == "sweep"
    with pytest.raises(ValueError):
        resolve_backend(small, auto.replace(dialect="pbd"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_backend(big, auto, device="cuda") == "sweep"
    assert resolve_backend(small, auto, device="cuda") == "gather"
    with pytest.raises(ValueError):
        sbt.make_step(_topo(), auto.replace(xpbd_backend="nope"),
                      device="cpu")
