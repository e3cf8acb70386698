"""The Jacobi pass kernels' tile plans (``kernels/jacobi_plan.py``) on the
CPU, and a plain PyTorch replay of the tiled pass in the kernel's tile and
slot order against the plain passes.

The CUDA pass runs one CTA per tile: it stages the tile's referenced rows,
computes every listed constraint once, writes each owned corner's
contribution to its slot and sums each owned vertex's run of slots in
order.  ``_replay`` does the same with tensor ops, tile by tile and with
the kernel's arithmetic, so these tests hold the plan's tables and the
kernel's order of work without a card.  Tolerance: the replay against the
plain version within 1e-6 m (fp32 summation order and a few ulps of
rounding), counts equal.
"""

import types

import numpy as np
import pytest
import torch

import softbodysim_torch as sbt
from softbodysim_torch.collide.primitives import cross3, dot3
from softbodysim_torch.kernels import jacobi as kj
from softbodysim_torch.kernels import jacobi_plan as jp


def _meshes():
    ball = sbt.meshes.tet_ball(2, 0.3)
    return {
        "cube4": sbt.meshes.tet_cube(4, 4, 4, size=0.6,
                                     center=(0.0, 0.5, 0.0)),
        "cube6": sbt.meshes.tet_cube(6, 6, 6, size=0.6,
                                     center=(0.0, 0.5, 0.0)),
        # SampleScene's body: every tet holds the centre vertex
        "ball": sbt.build_topology(
            ball.vertices - ball.vertices.mean(0)
            + np.array([0.0, 1.0, 0.0], np.float32), ball.tets),
    }


MESHES = _meshes()
CAPS = [16, 64]
SIXTH = float(np.float32(1.0 / 6.0))


def _family(topo, family):
    return ((topo.edges, topo.edge_rest) if family == "edges"
            else (topo.tets, topo.tet_rest_vol))


def _table(topo, seed=11):
    """A predicted, perturbed (V, 4) table with three pinned rows."""
    rng = np.random.default_rng(seed)
    V = topo.num_particles
    x = (topo.vertices + rng.normal(0.0, 0.02, (V, 3))).astype(np.float32)
    w = sbt.init_state(topo, inv_mass_mode="density",
                       device="cpu").inv_mass.numpy().copy()
    w[[0, 7, 30]] = 0.0
    return torch.from_numpy(np.concatenate([x, w[:, None]], 1)), rng


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("family", ["edges", "tets"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_owned_incidence_has_one_slot(mesh, family, cap):
    """Every (vertex, incident constraint, role) has exactly one slot, in
    the tile that owns the vertex; slots of one owned vertex form its run;
    every local row is in int16 range and maps back to the constraint's
    vertex; each vertex is owned by exactly one tile of at most ``cap``."""
    topo = MESHES[mesh]
    cons, _ = _family(topo, family)
    cons = np.asarray(cons, np.int64)
    V, a = topo.num_particles, cons.shape[1]
    p = jp.tile_plan(V, cons, topo.vertices, cap)
    own_cnt = np.diff(p.own_ptr)
    assert p.num_tiles > 1 and own_cnt.max() <= cap and own_cnt.min() > 0
    owned = np.concatenate([p.rows[p.row_ptr[t]:p.row_ptr[t] + own_cnt[t]]
                            for t in range(p.num_tiles)])
    np.testing.assert_array_equal(np.sort(owned), np.arange(V))
    assert p.rec.dtype == np.int16 and p.slot_end.dtype == np.int16

    seen = []
    for t in range(p.num_tiles):
        r0, r1 = p.row_ptr[t], p.row_ptr[t + 1]
        c0, c1 = p.con_ptr[t], p.con_ptr[t + 1]
        rows = p.rows[r0:r1]
        assert len(np.unique(rows)) == len(rows)
        loc, dst = p.rec[c0:c1, :a].astype(np.int64), p.rec[c0:c1, a:]
        gid = p.cons[c0:c1]
        assert (np.diff(gid) > 0).all()                # ascending, once
        assert (loc >= 0).all() and (loc < r1 - r0).all()
        np.testing.assert_array_equal(rows[loc], cons[gid])
        n_own = own_cnt[t]
        assert ((loc < n_own) == (dst >= 0)).all()     # owned <-> slot
        assert ((loc < n_own).any(1)).all()            # an owned corner
        o0 = p.own_ptr[t]
        ends = p.slot_end[o0:o0 + n_own].astype(np.int64)
        starts = np.concatenate([[0], ends[:-1]])
        ci, ri = np.nonzero(dst >= 0)
        slot = dst[ci, ri].astype(np.int64)
        np.testing.assert_array_equal(np.sort(slot), np.arange(ends[-1]))
        o = np.searchsorted(ends, slot, side="right")  # the run's owner
        np.testing.assert_array_equal(loc[ci, ri], o)
        assert (slot >= starts[o]).all()
        seen.append(np.stack([rows[o], gid[ci], ri], 1))
    seen = np.concatenate(seen)
    want = np.stack([cons.ravel(), np.repeat(np.arange(len(cons)), a),
                     np.tile(np.arange(a), len(cons))], 1)
    order = lambda s: s[np.lexsort(s.T[::-1])]      # noqa: E731
    np.testing.assert_array_equal(order(seen), order(want))


def test_spatial_tiles_split_a_grid_into_cubes():
    """A 12 x 12 x 12 grid with cap 216 splits at the median of the
    longest extent into eight 6 x 6 x 6 cubes."""
    g = np.stack(np.meshgrid(*[np.arange(12.0)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    tile = jp.spatial_tiles(g, 216)
    assert tile.max() == 7
    for t in range(8):
        p = g[tile == t]
        assert len(p) == 216
        np.testing.assert_array_equal(p.max(0) - p.min(0), [5, 5, 5])


@pytest.mark.parametrize("family", ["edges", "tets"])
def test_pass_scalars_as_tensors(family):
    """k and omega given as 0-dim float32 tensors (what the pass step's
    CUDA graph reads) give the bits of the same floats; a tensor of
    another shape or type is refused."""
    topo = MESHES["cube4"]
    cons, rest = _family(topo, family)
    xin, _ = _table(topo)
    make, fn = ((kj.edge_pass_plan, kj.jacobi_edge_pass) if family == "edges"
                else (kj.tet_pass_plan, kj.jacobi_tet_pass))
    plan = make(topo.num_particles, cons, rest, device="cpu",
                vertices=topo.vertices)
    want, got = torch.empty_like(xin), torch.empty_like(xin)
    fn(plan, xin, want, 0.9, 1.4)
    fn(plan, xin, got, torch.tensor(0.9), torch.tensor(1.4))
    assert torch.equal(got, want)
    assert not torch.equal(got, xin)
    scal = torch.tensor([0.9, 1.4])          # views at an offset, as the
    got.zero_()                              # step's scalar table gives
    fn(plan, xin, got, scal[0], scal[1])
    assert torch.equal(got, want)
    for bad in (torch.tensor([1.4]), torch.tensor(1.4, dtype=torch.float64)):
        with pytest.raises(ValueError, match="omega"):
            fn(plan, xin, got, 0.9, bad)


def _replay(p, rest, k, xin, scale, omega):
    """The tiled pass with tensor ops, tile by tile in the kernel's order
    and with its arithmetic (the TPU kernels': lambda = (-k C) / w, the
    edge direction as lambda / |d|, the tet gradients times the f32
    sixth): (x_out (V, 4), counts (V,) int32)."""
    a = p.arity
    xout = xin.clone()
    cnt = torch.zeros(xin.shape[0], dtype=torch.int32)
    parts = torch.zeros((len(p.part_dst), 3))        # heavy-major
    pcnt = torch.zeros(len(p.part_dst), dtype=torch.int32)
    for t in range(p.num_tiles):
        r0, r1 = int(p.row_ptr[t]), int(p.row_ptr[t + 1])
        c0, c1 = int(p.con_ptr[t]), int(p.con_ptr[t + 1])
        o0, o1 = int(p.own_ptr[t]), int(p.own_ptr[t + 1])
        rows = torch.from_numpy(p.rows[r0:r1].astype(np.int64))
        srow = xin[rows]
        x, w = srow[:, :3], srow[:, 3]
        loc = torch.from_numpy(p.rec[c0:c1, :a].astype(np.int64))
        dst = torch.from_numpy(p.rec[c0:c1, a:].astype(np.int64))
        gid = p.cons[c0:c1]
        crest = torch.from_numpy(rest[gid])
        kk = scale if k is None else torch.from_numpy(k[gid]) * scale
        if a == 2:
            A, B = srow[loc[:, 0]], srow[loc[:, 1]]
            wsum = A[:, 3] + B[:, 3]
            d = A[:, :3] - B[:, :3]
            len2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            valid = (wsum != 0.0) & (len2 >= kj.EPS_LEN2)
            length = torch.sqrt(len2.clamp_min(kj.EPS_SQRT))
            sl = torch.where(valid, ((-kk * (length - crest)) / torch.where(
                wsum == 0.0, 1.0, wsum)) / length, 0.0)
            sd = d * sl[:, None]
            contrib = [sd * A[:, 3:], -(sd * B[:, 3:])]
            flags = [valid, valid]
        else:
            p4 = [x[loc[:, r]] for r in range(4)]
            ws = [w[loc[:, r]] for r in range(4)]
            pa, pb, pc, pd = p4
            gs = [cross3(pd - pb, pc - pb), cross3(pc - pa, pd - pa),
                  cross3(pd - pa, pb - pa), cross3(pb - pa, pc - pa)]
            gs = [g * SIXTH for g in gs]
            wsum = ws[0] * dot3(gs[0], gs[0])
            for r in range(1, 4):
                wsum = wsum + ws[r] * dot3(gs[r], gs[r])
            valid = ((((ws[0] + ws[1]) + ws[2]) + ws[3]) != 0.0) \
                & (wsum >= kj.EPS_WSUM)
            vol = dot3(gs[3], pd - pa)
            lam = torch.where(valid, (-kk * (vol - crest)) / torch.where(
                wsum == 0.0, 1.0, wsum), 0.0)
            contrib = [g * (lam * wr)[:, None] for g, wr in zip(gs, ws)]
            flags = [valid & (wr != 0.0) for wr in ws]
        q0, q1 = int(p.part_ptr[t]), int(p.part_ptr[t + 1])
        nown = int(p.slot_end[o1 - 1]) if o1 > o0 else 0
        nslot = int(p.part_end[q1 - 1]) if q1 > q0 else nown
        slots = torch.zeros((nslot, 4))
        for r in range(a):
            m = dst[:, r] >= 0
            slots[dst[m, r]] = torch.cat(
                [contrib[r][m], flags[r][m, None].float()], 1)
        acc, c = _run_sums(slots, 0, p.slot_end[o0:o1])
        own = rows[:o1 - o0]
        xo = kj.apply_delta(x[:o1 - o0], w[:o1 - o0], acc, c, omega)
        xout[own, :3] = xo
        cnt[own] = c
        # the tile's heavy runs, after its owned ones: one partial each
        dst = torch.from_numpy(p.part_dst[q0:q1].astype(np.int64))
        parts[dst], pcnt[dst] = _run_sums(slots, nown, p.part_end[q0:q1])
    # each heavy vertex: its partials (contiguous, in tile order) summed in
    # order, then applied
    for h, v in enumerate(p.heavy):
        acc, c = torch.zeros((1, 3)), torch.zeros(1, dtype=torch.int32)
        for i in range(p.heavy_ptr[h], p.heavy_ptr[h + 1]):
            acc, c = acc + parts[i], c + pcnt[i]
        xout[v, :3] = kj.apply_delta(xin[v:v + 1, :3], xin[v:v + 1, 3], acc,
                                     c, omega)[0]
        cnt[v] = c[0]
    return xout, cnt


def _run_sums(slots, first, ends):
    """Each run's sum (xyz) and count, its slots in order: the runs end at
    ``ends`` and the first starts at ``first``."""
    ends = torch.from_numpy(np.asarray(ends, np.int64))
    starts = torch.cat([torch.tensor([first]), ends[:-1]])
    acc = torch.zeros((len(ends), 3))
    c = torch.zeros(len(ends), dtype=torch.int32)
    for j in range(int((ends - starts).max()) if len(ends) else 0):
        live = starts + j < ends
        s = slots[torch.where(live, starts + j, 0)]
        acc = torch.where(live[:, None], acc + s[:, :3], acc)
        c = c + (live & (s[:, 3] != 0.0)).to(torch.int32)
    return acc, c


@pytest.mark.parametrize("perk", [False, True])
@pytest.mark.parametrize("family", ["edges", "tets"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tiled_replay_matches_plain(mesh, family, perk):
    topo = MESHES[mesh]
    cons, rest = _family(topo, family)
    xin, rng = _table(topo)
    table = (rng.uniform(0.2, 1.0, len(cons)).astype(np.float32)
             if perk else None)
    V = topo.num_particles
    p = jp.tile_plan(V, cons, topo.vertices, 32)
    got, got_cnt = _replay(p, np.asarray(rest, np.float32), table, xin,
                           0.9, 1.4)
    make, plain = ((kj.edge_pass_plan, kj.jacobi_edge_pass_plain)
                   if family == "edges"
                   else (kj.tet_pass_plan, kj.jacobi_tet_pass_plain))
    plan = make(V, cons, rest, table, device="cpu", vertices=topo.vertices)
    want = torch.full_like(xin, np.nan)
    want_cnt = torch.zeros(V, dtype=torch.int32)
    plain(plan, xin, want, 0.9, 1.4, want_cnt)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(got_cnt, want_cnt)
    assert (got - xin).abs().max() > 1e-4                 # the pass moved x


@pytest.mark.parametrize("family", ["edges", "tets"])
def test_device_tiles_are_the_host_plan(family):
    """The wrappers' plans carry the host tile plan's tables, with each
    listed constraint's rest value and stiffness."""
    topo = MESHES["cube6"]
    cons, rest = _family(topo, family)
    k = np.random.default_rng(3).uniform(0.2, 1.0, len(cons)).astype(
        np.float32)
    make = kj.edge_pass_plan if family == "edges" else kj.tet_pass_plan
    tiles = make(topo.num_particles, cons, rest, k, device="cpu",
                 vertices=topo.vertices).tiles
    p = jp.tile_plan(topo.num_particles, cons, topo.vertices)
    assert (tiles.num_tiles, tiles.smem_bytes) == (p.num_tiles,
                                                   p.smem_bytes)
    for name in ("row_ptr", "rows", "own_ptr", "slot_end", "con_ptr",
                 "rec"):
        np.testing.assert_array_equal(getattr(tiles, name).numpy(),
                                      getattr(p, name))
    np.testing.assert_array_equal(tiles.rest.numpy(),
                                  np.asarray(rest, np.float32)[p.cons])
    np.testing.assert_array_equal(tiles.k.numpy(), k[p.cons])


# --------------------------------------------------------------------------
# Heavy vertices (a vertex in more constraints than a tile can hold)
# --------------------------------------------------------------------------

# the plans of tet_cube(12, 12, 12) before heavy vertices existed: sha256 of
# (name, dtype, bytes) of each table, first 32 hex digits
SINGLE_OWNER_DIGESTS = {
    ("edges", 64): "e28fe0df5688da2f83cd937d5a4fb056",
    ("edges", 256): "4b5137f943d1bddba64271e5c5bec800",
    ("tets", 64): "a5c8712ae28f8aec77c58d967e02b64f",
    ("tets", 256): "3383d689e45f674e14ffab94acb185ba",
}


def _digest(p) -> str:
    import hashlib

    h = hashlib.sha256()
    for f in ("row_ptr", "rows", "own_ptr", "slot_end", "con_ptr", "cons",
              "rec"):
        a = np.ascontiguousarray(getattr(p, f))
        h.update(f.encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:32]


@pytest.mark.parametrize("cap", [64, 256])
@pytest.mark.parametrize("family", ["edges", "tets"])
def test_plan_without_heavy_vertices_is_unchanged(family, cap):
    """A mesh of normal valence has no heavy vertex, and its plan is the
    one the pass kernels ran before heavy vertices existed, array for
    array (tet_cube(12) standing in for the north star's tet_cube(47))."""
    topo = sbt.meshes.tet_cube(12, 12, 12)
    cons, _ = _family(topo, family)
    p = jp.tile_plan(topo.num_particles, cons, topo.vertices, cap)
    assert len(p.heavy) == 0 and len(p.part_dst) == 0
    np.testing.assert_array_equal(p.part_ptr, 0)
    assert _digest(p) == SINGLE_OWNER_DIGESTS[(family, cap)]


def _check_heavy_plan(p, cons, V, cap, heavy_run, budget=jp.SMEM_LIMIT):
    """Every (vertex, constraint, role) has exactly one slot: owned
    vertices in their tile's run, heavy ones in one partial's run of the
    constraint's home tile; every tile fits int16 and ``budget``."""
    cons = np.asarray(cons, np.int64)
    a = cons.shape[1]
    deg = np.bincount(cons.ravel(), minlength=V)
    np.testing.assert_array_equal(p.heavy, np.flatnonzero(deg > heavy_run))
    own_cnt = np.diff(p.own_ptr)
    assert own_cnt.max() <= cap
    owned = np.concatenate([p.rows[p.row_ptr[t]:p.row_ptr[t] + own_cnt[t]]
                            for t in range(p.num_tiles)])
    np.testing.assert_array_equal(np.sort(owned), np.flatnonzero(
        deg <= heavy_run))
    # heavy run -> (tile, heavy vertex), from the finishing tables: each
    # heavy vertex's partials contiguous and in tile order
    P = len(p.part_dst)
    assert sorted(p.part_dst) == list(range(P))
    ptile = np.searchsorted(p.part_ptr, np.arange(P), side="right") - 1
    owner = np.searchsorted(p.heavy_ptr, p.part_dst, side="right") - 1
    pvert = p.heavy[owner].astype(np.int64)
    for h in range(len(p.heavy)):
        runs = np.flatnonzero(owner == h)
        assert (np.diff(ptile[runs[np.argsort(p.part_dst[runs])]]) > 0).all()
    seen = []
    for t in range(p.num_tiles):
        r0, r1 = p.row_ptr[t], p.row_ptr[t + 1]
        c0, c1 = p.con_ptr[t], p.con_ptr[t + 1]
        q0, q1 = p.part_ptr[t], p.part_ptr[t + 1]
        rows = p.rows[r0:r1]
        assert len(np.unique(rows)) == len(rows)
        loc, dst = p.rec[c0:c1, :a].astype(np.int64), p.rec[c0:c1, a:]
        gid = p.cons[c0:c1]
        assert (np.diff(gid) > 0).all()
        np.testing.assert_array_equal(rows[loc], cons[gid])
        n_own = own_cnt[t]
        ends = np.concatenate([p.slot_end[p.own_ptr[t]:p.own_ptr[t + 1]],
                               p.part_end[q0:q1]]).astype(np.int64)
        nslots = ends[-1] if len(ends) else 0
        assert max(r1 - r0, nslots) <= jp.INT16_MAX
        assert (r1 - r0) * jp.ROW_BYTES + nslots * jp.SLOT_BYTES <= budget
        assert ((loc < n_own) <= (dst >= 0)).all()       # owned -> a slot
        ci, ri = np.nonzero(dst >= 0)
        slot = dst[ci, ri].astype(np.int64)
        np.testing.assert_array_equal(np.sort(slot), np.arange(nslots))
        run = np.searchsorted(ends, slot, side="right")  # the slot's run
        hp = np.clip(q0 + run - n_own, 0, max(len(pvert) - 1, 0))
        who = np.where(run < n_own, rows[np.minimum(run, len(rows) - 1)],
                       pvert[hp] if len(pvert) else -1)
        np.testing.assert_array_equal(rows[loc[ci, ri]], who)
        seen.append(np.stack([who, gid[ci], ri], 1))
    seen = np.concatenate(seen)
    want = np.stack([cons.ravel(), np.repeat(np.arange(len(cons)), a),
                     np.tile(np.arange(a), len(cons))], 1)
    order = lambda s: s[np.lexsort(s.T[::-1])]      # noqa: E731
    np.testing.assert_array_equal(order(seen), order(want))


def fan_ball(subdivisions: int, radius: float = 0.3, center=(0, 0, 0)):
    """tet_ball(subdivisions, radius, center)'s vertices, edges, tets,
    surface and rest values (the icosphere fanned to its centre, tets
    oriented positive) without its colouring, which takes seconds at this
    size and which the Jacobi steps do not read."""
    from softbodysim_torch.core.meshes import icosphere
    from softbodysim_torch.core.topology import (build_edges_and_surface,
                                                 orient_tets_positive)

    verts, faces = icosphere(subdivisions)
    verts = (np.concatenate([verts * radius, np.zeros((1, 3))])
             + np.asarray(center)).astype(np.float32)
    tets = orient_tets_positive(verts, np.concatenate(
        [faces, np.full((len(faces), 1), len(faces) // 2 + 2)], 1))
    edges, surface = build_edges_and_surface(verts, tets)
    edges = edges.astype(np.int64)
    d = verts[edges[:, 1]] - verts[edges[:, 0]]
    p = verts[tets]
    cr = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    e3 = p[:, 3] - p[:, 0]
    return types.SimpleNamespace(
        vertices=verts, edges=edges, tets=tets, surface_tris=surface,
        edge_rest=np.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                          + d[:, 2] * d[:, 2]).astype(np.float32),
        tet_rest_vol=(((cr[:, 0] * e3[:, 0] + cr[:, 1] * e3[:, 1])
                       + cr[:, 2] * e3[:, 2]) / np.float32(6.0)).astype(
                           np.float32),
        num_particles=len(verts), num_edges=len(edges),
        num_tets=len(tets))


@pytest.mark.parametrize("family", ["edges", "tets"])
@pytest.mark.parametrize("subdivisions", [5, 6])
def test_high_valence_balls_fit_the_pass(subdivisions, family):
    """tet_ball(5) and tet_ball(6) (the centre in every tet: 20,480 and
    81,920) plan at the default cap: their centre is heavy, every
    incidence has one slot, every tile fits."""
    ball = fan_ball(subdivisions)
    assert ball.num_tets == 20 * 4 ** subdivisions
    cons = ball.edges if family == "edges" else ball.tets
    budget = jp.pass_budget(1)
    p = jp.tile_plan(ball.num_particles, cons, ball.vertices,
                     smem_budget=budget)
    assert len(p.heavy) == 1
    assert p.smem_bytes <= budget and p.max_slots <= jp.INT16_MAX
    _check_heavy_plan(p, cons, ball.num_particles, jp.TILE_CAP,
                      jp.HEAVY_RUN, budget)


@pytest.mark.parametrize("family", ["edges", "tets"])
@pytest.mark.parametrize("case", ["forced", "ball4", "all_heavy"])
def test_heavy_replay_matches_plain(case, family, monkeypatch):
    """The tiled replay with heavy vertices -- partials per tile, summed
    per heavy vertex in tile order -- against the plain pass: SampleScene's
    body with its centre made heavy by a low threshold, tet_ball(4) at the
    default one, and tet_cube(3) with every vertex heavy (one tile, owning
    none).  Within 1e-5 m (the pass tests' tolerance), counts equal."""
    topo, cap, run = {
        "forced": (MESHES["ball"], 32, 40),
        "ball4": (sbt.meshes.tet_ball(4, 0.3), jp.TILE_CAP, jp.HEAVY_RUN),
        "all_heavy": (sbt.meshes.tet_cube(3, 3, 3), 32, 0)}[case]
    monkeypatch.setattr(jp, "HEAVY_RUN", run)
    cons, rest = _family(topo, family)
    V = topo.num_particles
    p = jp.tile_plan(V, cons, topo.vertices, cap)
    _check_heavy_plan(p, cons, V, cap, run)
    assert len(p.heavy) == (V if case == "all_heavy" else 1)
    xin, _ = _table(topo)
    got, got_cnt = _replay(p, np.asarray(rest, np.float32), None, xin, 0.9,
                           1.4)
    make, plain = ((kj.edge_pass_plan, kj.jacobi_edge_pass_plain)
                   if family == "edges"
                   else (kj.tet_pass_plan, kj.jacobi_tet_pass_plain))
    plan = make(V, cons, rest, device="cpu", vertices=topo.vertices)
    want = torch.full_like(xin, np.nan)
    want_cnt = torch.zeros(V, dtype=torch.int32)
    plain(plan, xin, want, 0.9, 1.4, want_cnt)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got_cnt, want_cnt)
    h = torch.from_numpy(p.heavy.astype(np.int64))
    assert (got[h] - xin[h]).abs().max() > 0.0         # heavy rows moved


def test_a_mesh_that_cannot_fit_raises():
    """A dense graph under the heavy threshold: 300 vertices all joined,
    two tiles of ~45,000 slots each: over int16 and the budget, so the
    plan raises TileFitError (a ValueError), and so does ``pass_tiles``."""
    n = 300
    i, j = np.triu_indices(n, 1)
    edges = np.stack([i, j], 1)
    verts = np.random.default_rng(0).uniform(0.0, 1.0, (n, 3))
    with pytest.raises(jp.TileFitError, match="gather"):
        jp.tile_plan(n, edges, verts)
    dense = types.SimpleNamespace(num_particles=n, edges=edges,
                                  tets=np.zeros((0, 4), np.int64),
                                  vertices=verts)
    with pytest.raises(jp.TileFitError):
        jp.pass_tiles(dense)
