"""The port's convergence module against the JAX package's, on the CPU.

'serial' and 'blocks' replay tests/oracle.py on both sides, so the curves
agree to 1e-5 relative once the block plans and scheme agree (which are
array-equal); 'colored' runs the port's coloured backend and is held
against the oracle's serial sweep in colour order (the same
Gauss-Seidel order), as chip_smoke.py does on the card -- not against the
JAX coloured step, whose cold compile on the CPU is slow: residuals
within 1e-5 (they sit at fp32 noise, ~1e-7, before contact, so a relative
bound would compare noise), energy within 1e-5 relative.
"""

import numpy as np
import pytest

from softbodysim_tpu import SolverParams as JParams
from softbodysim_tpu.core import meshes as jmeshes
from softbodysim_tpu.perf import convergence as jconv

import softbodysim_torch as sbt
from softbodysim_torch.core import meshes
from softbodysim_torch.io.from_jax import params_from_fields
from softbodysim_torch.perf import convergence as conv

from oracle import XpbdOracle

STEPS = 20
DT = 1.0 / 60.0
CUBE = dict(nx=3, ny=3, nz=3, size=0.6, center=(0.0, 0.7, 0.0))
PARAMS = dict(dialect="xpbd", substeps=2, iterations=6)


@pytest.fixture(scope="module")
def curves():
    topo = meshes.tet_cube(**CUBE)
    params = sbt.SolverParams(**PARAMS)
    port = conv.run_curves(topo, params, STEPS,
                           orderings=("serial", "blocks", "colored"),
                           device="cpu")
    jax_side = jconv.run_curves(jmeshes.tet_cube(**CUBE), JParams(**PARAMS),
                                STEPS, orderings=("serial", "blocks"))
    return topo, params, port, jax_side


@pytest.mark.parametrize("ordering", ["serial", "blocks"])
def test_oracle_orderings_match_jax(curves, ordering):
    _, _, port, jax_side = curves
    for key in ("edge", "tet", "energy"):
        assert port[ordering][key].shape == (STEPS,)
        np.testing.assert_allclose(port[ordering][key],
                                   jax_side[ordering][key], rtol=1e-5,
                                   atol=0, err_msg=key)


def test_colored_matches_oracle_in_colour_order(curves):
    topo, params, port, _ = curves
    oracle = XpbdOracle(topo, params)
    ref = {"edge": [], "tet": [], "energy": []}
    for _ in range(STEPS):
        oracle.step(DT, edge_order=topo.edge_colors.order,
                    tet_order=topo.tet_colors.order)
        r = conv.constraint_residuals(topo, oracle.x)
        ref["edge"].append(r["edge"])
        ref["tet"].append(r["tet"])
        ref["energy"].append(conv.mechanical_energy(
            oracle.x, oracle.v, oracle.w, params.gravity))
    # residuals (dimensionless; at fp32 noise, ~1e-7, until contact)
    # within 1e-5, energy within 1e-5 relative
    for key, want in ref.items():
        np.testing.assert_allclose(
            port["colored"][key], want, err_msg=key,
            **(dict(rtol=1e-5, atol=0) if key == "energy"
               else dict(rtol=0, atol=1e-5)))
    assert max(ref["edge"][-3:]) > 1e-5        # contact: residuals grew


def test_curves_settle_without_energy_injection(curves):
    _, _, port, _ = curves
    for name, c in port.items():
        e = c["energy"]
        assert e[-1] <= e[0] + 1e-3 * abs(e[0]), name
        assert float(np.mean(c["edge"][-5:])) < 0.1, name


@pytest.mark.parametrize("mesh", ["cube3", "two_bodies"])
def test_block_scheme_and_plans_match_jax(mesh):
    if mesh == "cube3":
        topo, jtopo = meshes.tet_cube(**CUBE), jmeshes.tet_cube(**CUBE)
    else:
        topo, _ = sbt.core.topology.merge_topologies(
            [meshes.tet_cube(3, 2, 2, 0.5), meshes.tet_ball(1, 0.2,
                                                            (1, 1, 0))])
        from softbodysim_tpu.core.topology import merge_topologies
        jtopo, _ = merge_topologies([jmeshes.tet_cube(3, 2, 2, 0.5),
                                     jmeshes.tet_ball(1, 0.2, (1, 1, 0))])
    for kw in (dict(), dict(xpbd_block_scheme="scale"),
               dict(xpbd_block_omega=(1.2, 1.7),
                    xpbd_block_local_iters=2)):
        jp = JParams(**PARAMS, **kw)
        assert conv.block_scheme(params_from_fields(jp)) == \
            jconv.block_scheme(jp)
    got = conv.block_plans(topo, sbt.SolverParams(**PARAMS))
    want = jconv.block_plans(jtopo, JParams(**PARAMS))
    for fam_got, fam_want in zip(got, want):
        assert len(fam_got) == len(fam_want)
        for (ids, scl), (jids, jscl) in zip(fam_got, fam_want):
            np.testing.assert_array_equal(ids, jids)
            np.testing.assert_array_equal(scl, jscl)


def test_unknown_and_unavailable_orderings(monkeypatch):
    topo = meshes.tet_cube(1, 1, 1)
    params = sbt.SolverParams(**PARAMS)
    with pytest.raises(ValueError):
        conv.run_curves(topo, params, 1, orderings=("nope",), device="cpu")
    monkeypatch.setenv("SOFTBODYSIM_REFERENCE", "/nonexistent/reference")
    with pytest.raises(RuntimeError, match="reference checkout not "
                                           "available"):
        conv.run_curves(topo, params, 1, orderings=("serial_golden",),
                        device="cpu")
