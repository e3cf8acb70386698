"""Port host layers vs the JAX package, array for array: topology,
init_state, the packed sweep plans (perm / old2new / block order / scale)
and the GPU plan derived from them -- with the native library on and off.
"""

import dataclasses

import numpy as np
import pytest
import torch

from softbodysim_tpu.core import meshes as jmeshes
from softbodysim_tpu.core import native as jnative
from softbodysim_tpu.core.state import init_state as j_init_state
from softbodysim_tpu.core.topology import build_topology as j_build
from softbodysim_tpu.kernels import sweep as jsw
from softbodysim_tpu.solver import xpbd_pallas as jxp

from softbodysim_torch.core import meshes as tmeshes
from softbodysim_torch.core import native as tnative
from softbodysim_torch.core.state import SimState, init_state
from softbodysim_torch.core.topology import build_topology as t_build
from softbodysim_torch.kernels import sweep_plan as tsp
from softbodysim_torch.solver import xpbd_sweep as txs

# (cells per axis, size, center); cube20 is the smallest cube whose edge
# and tet plans both regroup (>= 32 blocks per family)
CUBES = {
    "cube4": (4, 0.5, (0.0, 0.6, 0.0)),
    "cube7": (7, 1.0, (0.0, 0.8, 0.0)),
    "cube20": (20, 1.0, (0.0, 2.0, 0.0)),
}
TOPO_FIELDS = ("vertices", "edges", "tets", "surface_tris", "edge_rest",
               "tet_rest_vol")
PLAN_FIELDS = ("arity", "num_super", "nslots", "dmax", "slots", "rel",
               "inv", "rest", "perm", "pos_of", "scale", "groups")


@pytest.fixture(params=["native", "numpy"])
def native_mode(request, monkeypatch):
    """Both packages with their native library, or both on the NumPy
    fallbacks."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    else:
        assert tnative.get_lib() is not None, "port native build failed"
    return request.param


def two_bodies():
    """(vertices, tets) of two disjoint cubes: a disconnected mesh, so the
    layout is component-aligned with dead slots between the bodies."""
    a = tmeshes.tet_cube(3, 3, 3, size=0.5, center=(-0.6, 0.4, 0.0))
    b = tmeshes.tet_cube(4, 3, 3, size=0.5, center=(0.6, 0.4, 0.0))
    return (np.concatenate([a.vertices, b.vertices]),
            np.concatenate([a.tets, b.tets + a.num_particles]))


def _pair(cube):
    if cube == "ball2":
        kw = dict(subdivisions=2, radius=0.3, center=(0.0, 1.0, 0.0))
        return jmeshes.tet_ball(**kw), tmeshes.tet_ball(**kw)
    if cube == "two_bodies":
        v, t = two_bodies()
        return j_build(v, t), t_build(v, t)
    n, size, center = CUBES[cube]
    return (jmeshes.tet_cube(n, n, n, size=size, center=center),
            tmeshes.tet_cube(n, n, n, size=size, center=center))


def _relaid_counts(plan):
    """block_counts (rel layout) re-laid to packed (position, role)."""
    a, nb = plan.arity, plan.num_super
    bc = jsw.block_counts(plan).reshape(nb, a, 8, jsw.LANES)
    return bc.transpose(0, 2, 3, 1).reshape(-1, a)


@pytest.mark.parametrize("cube", list(CUBES) + ["ball2", "two_bodies"])
def test_plans_match_jax(cube, native_mode):
    jt, tt = _pair(cube)
    for f in TOPO_FIELDS:
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f), f)
    for fam in ("edge_colors", "tet_colors"):
        for f in ("idx", "mask", "order"):
            np.testing.assert_array_equal(getattr(getattr(tt, fam), f),
                                          getattr(getattr(jt, fam), f))

    js, ts = j_init_state(jt), init_state(tt, device="cpu")
    for f in (f.name for f in dataclasses.fields(SimState)):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), f)

    jperm, jo2n, jnwin, je, jtp = jxp._cached_plans(jt, "auto", None, None,
                                                     True)
    tperm, to2n, tnwin, te, ttp = txs.cached_plans(tt)
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(to2n, jo2n)
    assert tnwin == jnwin
    if cube == "cube20":
        assert je.groups is not None and jtp.groups is not None
    if cube == "two_bodies":          # aligned layout: dead slots inside
        assert (tperm[:-1] == tt.num_particles).any()

    for jp, tp, cons in ((je, te, tt.edges), (jtp, ttp, tt.tets)):
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)
        # the GPU plan, under both schemes, against the tables the JAX
        # sweep construction streams (kernels/sweep.py:1452-1459)
        for scheme, omega in (("split", 2.2), ("scale", 1.0),
                              ("scale", 1.5)):
            g = tsp.build_gpu_plan(tp, to2n[cons.astype(np.int64)],
                                   scheme=scheme, omega=omega)
            if scheme == "split":
                want_scale = np.full_like(jp.scale, np.float32(omega))
                want_cnt = _relaid_counts(jp)
            else:
                want_scale = (jp.scale * np.float32(omega)
                              if omega != 1.0 else jp.scale)
                want_cnt = np.ones_like(g.counts)
            np.testing.assert_array_equal(g.scale, want_scale.reshape(-1))
            np.testing.assert_array_equal(g.counts, want_cnt)
            np.testing.assert_array_equal(g.rest, jp.rest.reshape(-1))
            np.testing.assert_array_equal(g.pos_of, jp.pos_of)
            live = jp.perm >= 0
            np.testing.assert_array_equal(
                g.verts[live], jo2n[cons[jp.perm[live]].astype(np.int64)])
            assert (g.verts[~live] == -1).all()


@pytest.mark.parametrize("family", ["edges", "tets"])
def test_gpu_plan_csr_covers_each_lane_role_once(family):
    """Every live (lane, role) of a block appears exactly once in its
    block's CSR, under the row of the vertex it references; each vertex
    has one row per block; entries ascend within a row."""
    _, tt = _pair("cube20")
    perm, o2n, nwin, e_plan, t_plan = txs.cached_plans(tt)
    plan, cons = ((e_plan, tt.edges) if family == "edges"
                  else (t_plan, tt.tets))
    g = tsp.build_gpu_plan(plan, o2n[cons.astype(np.int64)],
                           scheme="split", omega=1.0)
    a = g.arity
    seen = np.zeros((g.num_blocks * tsp.BLOCK, a), np.int64)
    for b in range(g.num_blocks):
        rows = np.arange(g.blk_vptr[b], g.blk_vptr[b + 1])
        assert len(np.unique(g.cvert[rows])) == len(rows)
        for u in rows:
            ent = g.centry[g.cptr[u]:g.cptr[u + 1]]
            assert (np.diff(ent) > 0).all()
            lane, role = ent >> 2, ent & 3
            p = b * tsp.BLOCK + lane
            assert (g.verts[p, role] == g.cvert[u]).all()
            assert (g.counts[p, role] == len(ent)).all()
            seen[p, role] += 1
    np.testing.assert_array_equal(seen, (g.verts >= 0).astype(np.int64))


def test_native_and_numpy_packers_agree(monkeypatch):
    """The port's native packer (built in the port's own build directory)
    and its Python fallback give the same plan."""
    _, tt = _pair("cube7")
    cons = tt.tets.astype(np.int64)
    nat = tsp.pack_superblocks(cons, tt.tet_rest_vol, layer_cap=3)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    py = tsp.pack_superblocks(cons, tt.tet_rest_vol, layer_cap=3)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(py, f), getattr(nat, f), f)


def test_init_state_device_and_dtype():
    _, tt = _pair("cube4")
    s = init_state(tt, pinned=[0, 3], device="cpu")
    for f in dataclasses.fields(SimState):
        t = getattr(s, f.name)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert s.inv_mass[0] == 0 and s.inv_mass[3] == 0
    assert torch.equal(s.x, s.x_star) and s.x.data_ptr() != s.x_star.data_ptr()
