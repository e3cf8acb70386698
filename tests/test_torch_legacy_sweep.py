"""The legacy 128-wide sweep path (``superblocks=False``) of the port
against the JAX package on the CPU: the host packer array for array, one
sweep of each plain version against the JAX legacy kernels in interpret
mode, and the whole step against the JAX Pallas step (interpret mode, with
a collider whose pose moves mid-run) and against the NumPy oracle's
block replay at width 128.  The CUDA kernels are held against these plain
versions on the card in test_torch_kernels.py.

Tolerances: one sweep, positions 1e-5 m and lambdas 1e-5 relative to the
largest |lambda| (the implementations sum a vertex's corrections in
different orders); whole steps 1e-4 over 3 steps.  JAX steps are compiled
once per module (interpret-mode compiles take ~20 s).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysim_tpu import SolverParams as JParams
from softbodysim_tpu.collide.primitives import Colliders as JColliders
from softbodysim_tpu.core import meshes as jmeshes
from softbodysim_tpu.core.state import init_state as j_init_state
from softbodysim_tpu.kernels import sweep as jsw
from softbodysim_tpu.solver import xpbd_pallas as jxp

from softbodysim_torch import SolverParams
from softbodysim_torch.core import meshes as tmeshes
from softbodysim_torch.core.state import init_state
from softbodysim_torch.io.from_jax import (colliders_from_numpy,
                                           state_from_numpy, state_to_numpy)
from softbodysim_torch.kernels import sweep as ksw
from softbodysim_torch.kernels import sweep_plan as tsp
from softbodysim_torch.solver import xpbd_sweep as txs
from softbodysim_torch.solver.xpbd_sweep import SweepStep

from oracle import XpbdOracle

DT = 1.0 / 60.0
SDT = np.float32(DT) / np.float32(2)
COMPLIANCE = 5e-4
PLAN_FIELDS = ("arity", "num_blocks", "nslots", "dmax", "slots", "rel",
               "inv", "rest", "perm", "pos_of", "scale")
MESHES = {"cube5": ("tet_cube", dict(nx=5, ny=5, nz=5, size=1.0)),
          "ball2": ("tet_ball", dict(subdivisions=2, radius=0.3,
                                     center=(0.0, 1.0, 0.0)))}
# tet_cube(3) dropped onto a box that overlaps its bottom layer; the box
# rises between steps 2 and 3 (runtime pose)
CUBE3 = dict(nx=3, ny=3, nz=3, size=0.5, center=(0.0, 0.36, 0.0))
BOX_POSES = [(0.0, 0.02, 0.0), (0.0, 0.02, 0.0), (0.0, 0.04, 0.0)]
BOX_HALF = (0.6, 0.1, 0.6)


def _mesh(pkg, name):
    fn, kw = MESHES[name]
    return getattr(pkg, fn)(**kw)


def _family(topo, family):
    if family == "edges":
        return topo.edges.astype(np.int64), topo.edge_rest
    return topo.tets.astype(np.int64), topo.tet_rest_vol


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_pack_constraints_matches_jax(family, mesh):
    """The packer, and the GPU plan built from it, array for array."""
    jt, tt = _mesh(jmeshes, mesh), _mesh(tmeshes, mesh)
    cons, rest = _family(tt, family)
    nwin = -(-tt.num_particles // tsp.LANES)
    jp = jsw.pack_constraints(cons, rest, nwin)
    tp = tsp.pack_constraints(cons, rest)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)
    assert tsp.block_width(tp) == jsw.block_width(jp) == tsp.LANES

    g = tsp.build_gpu_plan(tp, cons, scheme="scale", omega=1.0)
    assert g.width == tsp.LANES and g.counts is None
    live = jp.perm >= 0
    np.testing.assert_array_equal(g.verts[live], cons[jp.perm[live]])
    assert (g.verts[~live] == -1).all()
    np.testing.assert_array_equal(g.scale, jp.scale.reshape(-1))
    np.testing.assert_array_equal(g.rest, jp.rest.reshape(-1))
    np.testing.assert_array_equal(g.pos_of, jp.pos_of)
    # every live (lane, role) once in its block's CSR, in ascending order
    seen = np.zeros_like(g.verts, dtype=np.int64)
    for b in range(g.num_blocks):
        for u in range(g.blk_vptr[b], g.blk_vptr[b + 1]):
            ent = g.centry[g.cptr[u]:g.cptr[u + 1]]
            assert (np.diff(ent) > 0).all()
            p = b * tsp.LANES + (ent >> 2)
            assert (g.verts[p, ent & 3] == g.cvert[u]).all()
            seen[p, ent & 3] += 1
    np.testing.assert_array_equal(seen, (g.verts >= 0).astype(np.int64))
    with pytest.raises(ValueError):
        tsp.build_gpu_plan(tp, cons, scheme="split", omega=1.0)


def test_cached_legacy_plans_match_jax():
    jt, tt = _mesh(jmeshes, "ball2"), _mesh(tmeshes, "ball2")
    jres = jxp._cached_plans(jt, "auto", None, None, False)
    tres = txs.cached_plans(tt, superblocks=False)
    for a, b in zip(tres[:3], jres[:3]):
        np.testing.assert_array_equal(a, b)
    for tp, jp in zip(tres[3:], jres[3:]):
        assert isinstance(tp, tsp.SweepPlan)
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)
    assert txs.cached_plans(tt, superblocks=True)[3] is not tres[3]


@functools.lru_cache(maxsize=None)
def _sweep_scene():
    """tet_cube(5) (one 128-lane window), a perturbed state with two pinned
    vertices, nonzero starting lambdas (public order)."""
    topo = tmeshes.tet_cube(5, 5, 5, size=1.0, center=(0.0, 0.8, 0.0))
    V = topo.num_particles
    rng = np.random.default_rng(0)
    x = (topo.vertices + rng.normal(0.0, 0.01, (V, 3))).astype(np.float32)
    w = init_state(topo, device="cpu").inv_mass.numpy().copy()
    w[[0, 17]] = 0.0
    lam = {"edges": rng.normal(0.0, 1e-8, topo.num_edges).astype(np.float32),
           "tets": rng.normal(0.0, 1e-8, topo.num_tets).astype(np.float32)}
    return topo, x, w, lam


@pytest.mark.parametrize("family", ["edges", "tets"])
def test_plain_legacy_sweep_matches_jax_interpret(family):
    topo, x, w, lam = _sweep_scene()
    cons, rest = _family(topo, family)
    nwin = -(-topo.num_particles // tsp.LANES)
    alpha = (float(np.float32(COMPLIANCE) * (np.float32(1.0) / (SDT * SDT)))
             if family == "edges" else 0.0)

    plan = tsp.pack_constraints(cons, rest)
    dplan = ksw.to_device(tsp.build_gpu_plan(plan, cons, scheme="scale",
                                             omega=1.0), "cpu")
    xw = torch.zeros((nwin * tsp.LANES, 4))
    xw[:len(x), :3] = torch.from_numpy(x)
    xw[:len(x), 3] = torch.from_numpy(w)
    lam_p = torch.zeros(dplan.num_blocks * tsp.LANES)
    pos_of = torch.from_numpy(plan.pos_of)
    lam_p[pos_of] = torch.from_numpy(lam[family])
    fn = (ksw.legacy_edge_sweep if family == "edges"
          else ksw.legacy_tet_sweep)
    fn(dplan, xw, lam_p, alpha)

    jplan = jsw.pack_constraints(cons, rest, nwin)
    sweep = jsw.make_sweep(jplan, nwin, interpret=True)
    x8 = np.zeros((8, nwin * jsw.LANES), np.float32)
    x8[0:3, :len(x)] = x.T
    x8[3, :len(x)] = w
    x8_out, lam_out = jax.jit(lambda a, b: sweep(
        a, b, jnp.float32(alpha), sweep.tables))(
        jnp.asarray(x8), jsw.pack_lambda(jplan, jnp.asarray(lam[family])))
    lam_ref = np.asarray(jsw.unpack_lambda(jplan, lam_out))
    np.testing.assert_allclose(xw[:len(x), :3].numpy(),
                               np.asarray(x8_out)[0:3, :len(x)].T, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(lam_p[pos_of].numpy(), lam_ref, rtol=0,
                               atol=1e-5 * np.abs(lam_ref).max())
    assert np.abs(xw[:len(x), :3].numpy() - x).max() > 1e-4


def _jbox(center):
    return JColliders.build([JColliders.box(center, BOX_HALF)])


def _jstate(js):
    return {f: np.asarray(getattr(js, f)) for f in
            ("x", "v", "x_star", "inv_mass", "edge_lambda", "tet_lambda")}


def _t_colliders(jc):
    return colliders_from_numpy({k: np.asarray(getattr(jc, k)) for k in
                                 ("type", "position", "rotation", "data",
                                  "active")}, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_legacy_step():
    topo = jmeshes.tet_cube(**CUBE3)
    params = JParams(dialect="xpbd", substeps=2, iterations=3)
    step = jxp.make_xpbd_pallas_step(
        topo, params, _jbox(BOX_POSES[0]), interpret=True,
        superblocks=False)
    return topo, params, jax.jit(lambda s, c: step(s, DT, colliders_rt=c))


def test_legacy_step_with_moving_collider_matches_jax():
    """SweepStep(superblocks=False) with a box collider whose pose moves
    between steps, against the JAX legacy Pallas step: 3 steps, 1e-4."""
    jtopo, jparams, jstep = _jax_legacy_step()
    topo = tmeshes.tet_cube(**CUBE3)
    params = SolverParams(dialect="xpbd", substeps=2, iterations=3)
    poses = [_jbox(c) for c in BOX_POSES]
    step = SweepStep(topo, params, _t_colliders(poses[0]), device="cpu",
                     superblocks=False)
    assert step.block_scheme["scheme"] == ("scale", "scale")
    js = j_init_state(jtopo)
    ts = state_from_numpy(_jstate(js), "cpu")
    for jc in poses:
        js = jstep(js, jc)
        ts = step(ts, DT, colliders_rt=_t_colliders(jc))
    out = state_to_numpy(ts)
    for f in ("x", "edge_lambda", "tet_lambda"):
        np.testing.assert_allclose(out[f], np.asarray(getattr(js, f)),
                                   rtol=0, atol=1e-4, err_msg=f)
    # the box pushed the bottom layer up out of free fall
    assert out["x"][:, 1].min() > topo.vertices[:, 1].min()


def test_legacy_step_matches_oracle_blocks_at_width_128():
    topo = tmeshes.tet_cube(3, 3, 3, size=0.5, center=(0.0, 0.6, 0.0))
    params = SolverParams(dialect="xpbd", substeps=2, iterations=4)
    step = SweepStep(topo, params, device="cpu", superblocks=False)

    def blocks(plan):
        width = tsp.block_width(plan)
        assert width == tsp.LANES
        rows = plan.perm.reshape(-1, width)
        scl = plan.scale.reshape(-1, width)
        return [(r[r >= 0], s[r >= 0]) for r, s in zip(rows, scl)
                if (r >= 0).any()]

    eb, tb = (blocks(step.block_order[k]) for k in ("edges", "tets"))
    oracle = XpbdOracle(topo, params)
    s = init_state(topo, device="cpu")
    oracle.w = s.inv_mass.numpy().copy()
    for _ in range(3):
        s = step(s, DT)
        oracle.step_blocks(DT, edge_blocks=eb, tet_blocks=tb,
                           **step.block_scheme)
    np.testing.assert_allclose(s.x.numpy(), oracle.x, rtol=0, atol=1e-4)
    np.testing.assert_allclose(s.edge_lambda.numpy(), oracle.edge_lambda,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(s.tet_lambda.numpy(), oracle.tet_lambda,
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("knob", [
    dict(xpbd_block_scheme="split"), dict(xpbd_block_omega=1.5),
    dict(xpbd_block_local_iters=2), dict(xpbd_x_dtype="bfloat16")])
def test_legacy_auto_is_scale_and_other_schemes_raise(knob):
    params = SolverParams(dialect="xpbd")
    want = {"edge": ("scale", 1.0, 1), "tet": ("scale", 1.0, 1)}
    assert txs.resolve_block_scheme(params, legacy=True) == want
    assert jxp._resolve_block_scheme(JParams(dialect="xpbd"),
                                     legacy=True) == want
    assert txs.resolve_block_scheme(params)["edge"][0] == "split"
    topo = tmeshes.tet_cube(2, 2, 2)
    with pytest.raises(ValueError):
        SweepStep(topo, params.replace(**knob), device="cpu",
                  superblocks=False)


def test_legacy_per_constraint_compliance_identity():
    """edge_c / tet_c tables equal to the scalar compliances reproduce the
    scalar path exactly on the legacy path."""
    topo = tmeshes.tet_cube(3, 3, 3, size=0.5, center=(0.0, 0.4, 0.0))
    params = SolverParams(dialect="xpbd", substeps=1, iterations=3,
                          edge_compliance=5e-4, volume_compliance=1e-5)
    a = SweepStep(topo, params, device="cpu", superblocks=False)
    b = SweepStep(topo, params, device="cpu", superblocks=False,
                  edge_c=np.full(topo.num_edges, 5e-4, np.float32),
                  tet_c=np.full(topo.num_tets, 1e-5, np.float32))
    sa = sb = init_state(topo, device="cpu")
    for _ in range(6):
        sa, sb = a(sa, DT), b(sb, DT)
    for f in ("x", "edge_lambda", "tet_lambda"):
        torch.testing.assert_close(getattr(sb, f), getattr(sa, f), rtol=0,
                                   atol=0)
    assert sa.tet_lambda.abs().max() > 0


def test_plan_store_roundtrip_skips_packing(tmp_path, monkeypatch):
    """cached_plans writes both widths to the port's own disk cache; a new
    topology object with the same content loads them without packing,
    array-equal; the JAX package's key for the same parts differs."""
    from softbodysim_tpu.io import plan_store as jstore
    from softbodysim_torch.io import plan_store

    monkeypatch.delenv("SOFTBODYSIM_NO_PLAN_CACHE", raising=False)
    monkeypatch.setenv("SOFTBODYSIM_TORCH_PLAN_CACHE", str(tmp_path))
    fresh = {sb: txs.cached_plans(tmeshes.tet_cube(3, 3, 3), sb)
             for sb in (False, True)}
    assert len(list(tmp_path.glob("*.pkl"))) == 2

    def no_packing(*a, **k):
        raise AssertionError("packed despite a disk hit")

    monkeypatch.setattr(tsp, "pack_constraints", no_packing)
    monkeypatch.setattr(tsp, "pack_superblocks", no_packing)
    for sb, want in fresh.items():
        got = txs.cached_plans(tmeshes.tet_cube(3, 3, 3), sb)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        for tp, wp in zip(got[3:], want[3:]):
            assert type(tp) is type(wp)
            np.testing.assert_array_equal(tp.perm, wp.perm)
            np.testing.assert_array_equal(tp.inv, wp.inv)
    parts = ["plans", np.arange(4)]
    assert plan_store.content_key(parts) != jstore.content_key(parts)
    monkeypatch.setenv("SOFTBODYSIM_NO_PLAN_CACHE", "1")
    assert plan_store.load(plan_store.content_key(parts)) is None
