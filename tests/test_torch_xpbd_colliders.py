"""Colliders with a runtime pose and the step's overrides on the port's
xpbd dialect, against the JAX package on the CPU: the coloured backend
(under both JAX names, 'gather' and 'scatter', its alias) against
``make_xpbd_step`` with the same backend, and
the super-block sweep step against the JAX Pallas step in interpret mode
(the legacy 128-wide width is in test_torch_legacy_sweep.py).  The scene:
tet_cube(2) falling onto a box that overlaps its bottom layer, the box
rising after step 4.

Tolerance: positions, velocities and lambdas 1e-4 over 8 steps (the two
sides run the same float32 operations in the same order up to fused
rounding).  The JAX steps are compiled once per module, with every override
an argument; the overrides are the JAX package's shared wrapper code for
both of its coloured backends, so they are held against 'gather' only.
"""

import functools

import jax
import numpy as np
import pytest

from softbodysim_tpu import SolverParams as JParams
from softbodysim_tpu.collide.primitives import Colliders as JColliders
from softbodysim_tpu.core import meshes as jmeshes
from softbodysim_tpu.core.state import init_state as j_init_state
from softbodysim_tpu.solver import make_xpbd_step as j_make_xpbd_step
from softbodysim_tpu.solver.xpbd_pallas import make_xpbd_pallas_step

import softbodysim_torch as sbt
from softbodysim_torch.io.from_jax import (colliders_from_numpy,
                                           state_from_numpy, state_to_numpy)
from softbodysim_torch.solver.xpbd_sweep import SweepStep

DT = 1.0 / 60.0
CUBE2_BOX = (2, 0.5, (0.0, 0.36, 0.0))
POSES = [(0.0, 0.02, 0.0)] * 4 + [(0.0, 0.05, 0.0)] * 4
BOX_HALF = (0.6, 0.1, 0.6)
FIELDS = ("x", "v", "edge_lambda", "tet_lambda")


def _cube(pkg, spec):
    n, size, center = spec
    return pkg.tet_cube(n, n, n, size=size, center=center)


def _jbox(center):
    return JColliders.build([JColliders.box(center, BOX_HALF)])


def _tcols(jc):
    return colliders_from_numpy({k: np.asarray(getattr(jc, k)) for k in
                                 ("type", "position", "rotation", "data",
                                  "active")}, "cpu")


def _jstate(js):
    return {f: np.asarray(getattr(js, f)) for f in
            ("x", "v", "x_star", "inv_mass", "edge_lambda", "tet_lambda")}


def _close(ts, js, tol=1e-4):
    out = state_to_numpy(ts)
    for f in FIELDS:
        np.testing.assert_allclose(out[f], np.asarray(getattr(js, f)),
                                   rtol=0, atol=tol, err_msg=f)


@functools.lru_cache(maxsize=None)
def _jax_coloured(backend):
    """The JAX coloured step on tet_cube(2) over the box, jitted with every
    override an argument (one compile per backend)."""
    topo = _cube(jmeshes, CUBE2_BOX)
    params = JParams(dialect="xpbd", substeps=2, iterations=2,
                     xpbd_backend=backend)
    step = j_make_xpbd_step(topo, params, _jbox(POSES[0]))
    assert step.backend == backend
    return topo, jax.jit(
        lambda s, ec, vc, fr, g, c: step(
            s, DT, edge_compliance=ec, volume_compliance=vc, friction=fr,
            gravity_override=g, colliders_rt=c))


# per-step overrides: the params' own values, then each knob moved
BASE = dict(edge_compliance=5e-4, volume_compliance=0.0, friction=0.2,
            gravity_override=(0.0, -9.81, 0.0))
OVERRIDES = {
    "base": {},
    "compliances": dict(edge_compliance=2e-3, volume_compliance=1e-6),
    "friction": dict(friction=0.9),
    "gravity": dict(gravity_override=(1.5, -4.0, 0.5)),
}


@pytest.mark.parametrize("backend,which", [
    *(("gather", w) for w in OVERRIDES), ("scatter", "base")])
def test_coloured_colliders_and_overrides_match_jax(backend, which):
    """A box collider whose pose moves after step 4, and the step's
    overrides, against the JAX step with the same backend name: 8 steps."""
    jtopo, jstep = _jax_coloured(backend)
    topo = _cube(sbt.meshes, CUBE2_BOX)
    params = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=2,
                              xpbd_backend=backend)
    eng = sbt.Engine(topo, params, colliders=_tcols(_jbox(POSES[0])),
                     device="cpu")
    assert eng.backend == "gather"
    kw = {**BASE, **OVERRIDES[which]}
    jkw = [np.float32(kw[k]) for k in ("edge_compliance", "volume_compliance",
                                       "friction")]
    js = j_init_state(jtopo)
    eng.state = state_from_numpy(_jstate(js), "cpu")
    for pose in POSES:
        jc = _jbox(pose)
        js = jstep(js, *jkw, np.asarray(kw["gravity_override"], np.float32),
                   jc)
        eng.update_colliders(_tcols(jc))
        eng.step(DT, **({} if which == "base" else OVERRIDES[which]))
    _close(eng.state, js)
    if which == "base":
        assert eng.positions()[:, 1].min() > topo.vertices[:, 1].min()


@functools.lru_cache(maxsize=None)
def _jax_super_step():
    topo = _cube(jmeshes, CUBE2_BOX)
    params = JParams(dialect="xpbd", substeps=2, iterations=3)
    step = make_xpbd_pallas_step(topo, params, _jbox(POSES[0]),
                                 interpret=True)
    return topo, jax.jit(lambda s, c: step(s, DT, colliders_rt=c))


def test_superblock_sweep_colliders_match_jax():
    """SweepStep (1024-wide super-blocks) with the moving box against the
    JAX Pallas step in interpret mode: 8 steps, 1e-4."""
    jtopo, jstep = _jax_super_step()
    topo = _cube(sbt.meshes, CUBE2_BOX)
    params = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=3)
    step = SweepStep(topo, params, _tcols(_jbox(POSES[0])), device="cpu")
    js = j_init_state(jtopo)
    ts = state_from_numpy(_jstate(js), "cpu")
    carry = step.pack_state(ts)
    for pose in POSES:
        jc = _jbox(pose)
        js = jstep(js, jc)
        step.run_carry(carry, DT, 1, colliders_rt=_tcols(jc))
    _close(step.unpack_state(carry, ts), js)
    with pytest.raises(ValueError):       # runtime poses need a template
        SweepStep(topo, params, device="cpu")(ts, DT,
                                              colliders_rt=_tcols(jc))
