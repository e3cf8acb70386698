"""The dependency schedule of the CUDA sweep kernels on the CPU
(``kernels/sweep_plan.py``: ``build_schedule``, ``stage_plan``).

The kernels run a plan's blocks over Q persistent CTAs ("queues"), each
queue in plan order, a block first waiting for the blocks on its wait list.
The schedule is right when every block runs after the last earlier block
that touches each of its vertices: blocks that share no vertex commute
exactly, so the result is bit for bit plan order's.  Checked here on super-
block and legacy plans of small cubes for Q in {1, 2, 7, 132}: the queues
hold every non-empty block once, in plan order; waits point back and to
other queues; every predecessor is complete before its block starts (it is
earlier on the block's queue, on its wait list, or complete before one of
those -- a wait another wait implies is left out); a run of the queues
cannot deadlock; Q = 1 is plan order with no waits.  Then the staged
tables the kernels read, and the plain sweeps replayed block by block in
random interleavings the schedule allows, which must be ``torch.equal``
to plan order.
"""

import functools

import numpy as np
import pytest
import torch

import softbodysim_torch as sbt
from softbodysim_torch.kernels import sweep as ksw
from softbodysim_torch.kernels import sweep_plan as tsp

QUEUES = (1, 2, 7, 132)
# plan name -> (cube cells per side, superblocks)
PLANS = {"super4": (4, True), "super8": (8, True), "super12": (12, True),
         "legacy4": (4, False), "legacy6": (6, False),
         "legacy8": (8, False)}
SCHEMES = {"split": {"edges": ("split", 1.5), "tets": ("split", 2.2)},
           "scale": {"edges": ("scale", 1.0), "tets": ("scale", 1.0)}}


@functools.lru_cache(maxsize=None)
def _topo(n):
    return sbt.meshes.tet_cube(n, n, n, size=1.0, center=(0.0, 0.8, 0.0))


@functools.lru_cache(maxsize=None)
def _plan(name, family, scheme="scale"):
    n, superblocks = PLANS[name]
    topo = _topo(n)
    if family == "edges":
        cons, rest, lcap = topo.edges, topo.edge_rest, 2
    else:
        cons, rest, lcap = topo.tets, topo.tet_rest_vol, 3
    cons = cons.astype(np.int64)
    plan = (tsp.pack_superblocks(cons, rest, layer_cap=lcap) if superblocks
            else tsp.pack_constraints(cons, rest))
    sch, omega = SCHEMES[scheme][family]
    return tsp.build_gpu_plan(plan, cons, scheme=sch, omega=omega)


def _block_vertices(g):
    """Per block the set of its vertices, from the per-lane table."""
    v = g.verts.reshape(g.num_blocks, -1)
    return [set(row[row >= 0].tolist()) for row in v]


def _last_writers(g):
    """Per block the last earlier block touching each of its vertices."""
    last, out = {}, []
    for b, vs in enumerate(_block_vertices(g)):
        out.append({last[v] for v in vs if v in last})
        for v in vs:
            last[v] = b
    return out


def _waits(sched, i):
    return sched.wait[sched.wptr[i]:sched.wptr[i + 1]].tolist()


def _run_queues(sched, rng=None):
    """Advance the queues as the kernels may: any queue whose next block
    has every wait complete (at random with ``rng``, else the first).
    Returns the blocks in completion order; fails on a deadlock."""
    heads = sched.qptr[:-1].astype(np.int64).copy()
    ends = sched.qptr[1:]
    done, order = set(), []
    while True:
        ready = [q for q in range(sched.queues) if heads[q] < ends[q]
                 and all(w in done for w in _waits(sched, heads[q]))]
        if not ready:
            break
        q = ready[int(rng.integers(len(ready)))] if rng is not None \
            else ready[0]
        b = int(sched.qblk[heads[q]])
        done.add(b)
        order.append(b)
        heads[q] += 1
    assert (heads == ends).all(), "the queues deadlock"
    return order


@pytest.mark.parametrize("queues", QUEUES)
@pytest.mark.parametrize("family", ["edges", "tets"])
@pytest.mark.parametrize("name", list(PLANS))
def test_schedule_keeps_the_plan_order(name, family, queues):
    g = _plan(name, family)
    sched = tsp.build_schedule(g, queues)
    live = [b for b, vs in enumerate(_block_vertices(g)) if vs]
    assert 1 <= sched.queues <= queues
    # every non-empty block once, each queue in plan order
    assert sorted(sched.qblk.tolist()) == live
    qof = {}
    for q in range(sched.queues):
        blocks = sched.qblk[sched.qptr[q]:sched.qptr[q + 1]]
        assert len(blocks) and (np.diff(blocks) > 0).all()
        qof.update(dict.fromkeys(blocks.tolist(), q))
    # waits point back, to other queues
    for i, b in enumerate(sched.qblk.tolist()):
        for w in _waits(sched, i):
            assert w < b and qof[w] != qof[b]
            assert sched.release[w]
    # every predecessor complete before its block starts: earlier on the
    # block's queue, on its wait list, or before one of those
    before = {}
    for b in _run_queues(sched):
        i = int(np.flatnonzero(sched.qblk == b)[0])
        hb = set()
        if i > sched.qptr[qof[b]]:
            prev = int(sched.qblk[i - 1])
            hb |= before[prev] | {prev}
        for w in _waits(sched, i):
            hb |= before[w] | {w}
        before[b] = hb
    for b, preds in enumerate(_last_writers(g)):
        if b in before:
            assert preds <= before[b], (b, preds - before[b])
    if queues == 1:
        assert sched.queues == 1 and sched.qblk.tolist() == live
        assert len(sched.wait) == 0 and not sched.release.any()
        assert sched.length == len(live)
    assert 1 <= sched.levels <= sched.length <= len(live)


@pytest.mark.parametrize("queues", [1, 7, 132])
@pytest.mark.parametrize("family", ["edges", "tets"])
@pytest.mark.parametrize("name", list(PLANS))
def test_staged_tables(name, family, queues):
    """lrow maps every live (lane, role) to its block-local CSR row, and a
    staged record holds its block's header, waits and CSR slices."""
    g = _plan(name, family)
    st = tsp.stage_plan(g, queues)
    lrow = st.lrow.astype(np.int64)
    blk = np.arange(g.num_blocks * g.width) // g.width
    live = g.verts >= 0
    assert (live == (lrow >= 0)).all()
    np.testing.assert_array_equal(
        g.cvert[g.blk_vptr[blk][:, None] + lrow][live], g.verts[live])
    sched = st.schedule
    assert len(st.qinfo) == len(sched.qblk)
    for i, (b, off, n, _) in enumerate(st.qinfo.tolist()):
        assert b == sched.qblk[i] and off % 4 == 0 and n % 4 == 0
        assert n <= st.max_rec
        rec = st.rec[off:off + n]
        u0, u1 = g.blk_vptr[b], g.blk_vptr[b + 1]
        e0, e1 = g.cptr[u0], g.cptr[u1]
        nw = int(rec[3])
        assert rec[:tsp.REC_HEADER].tolist() == [
            b, u1 - u0, e1 - e0, nw, int(sched.release[b]), 0, 0, 0]
        assert u1 - u0 <= st.max_rows
        o = tsp.REC_HEADER
        assert rec[o:o + nw].tolist() == _waits(sched, i)
        o += -(-nw // 4) * 4
        np.testing.assert_array_equal(rec[o:o + u1 - u0], g.cvert[u0:u1])
        o += -(-(u1 - u0) // 4) * 4
        np.testing.assert_array_equal(rec[o:o + u1 - u0 + 1],
                                      g.cptr[u0:u1 + 1] - e0)
        o += -(-(u1 - u0 + 1) // 4) * 4
        np.testing.assert_array_equal(rec[o:o + e1 - e0], g.centry[e0:e1])
        assert o + -(-(e1 - e0) // 4) * 4 == n


def _table(g, n, seed):
    topo = _topo(n)
    V = topo.num_particles
    rng = np.random.default_rng(seed)
    xw = torch.zeros((-(-V // tsp.LANES) * tsp.LANES, 4))
    xw[:V, :3] = torch.from_numpy(
        (topo.vertices + rng.normal(0.0, 0.01, (V, 3))).astype(np.float32))
    xw[:V, 3] = sbt.init_state(topo, device="cpu").inv_mass
    xw[[0, 17], 3] = 0.0
    lam = torch.from_numpy(rng.normal(
        0.0, 1e-8, g.num_blocks * g.width).astype(np.float32))
    return xw, lam


@pytest.mark.parametrize("family", ["edges", "tets"])
@pytest.mark.parametrize("plan, scheme", [("super12", "split"),
                                          ("super12", "scale"),
                                          ("legacy8", "scale")])
def test_plain_replay_in_schedule_order_is_bitwise(plan, scheme, family):
    """Block by block in interleavings the schedule allows (7 queues) the
    plain sweep gives exactly plan order's positions and lambdas."""
    g = _plan(plan, family, scheme)
    dplan = ksw.to_device(g, "cpu")
    xw, lam = _table(g, PLANS[plan][0], seed=3)
    legacy = g.width == tsp.LANES
    wt = None if legacy else ksw.w_fill(dplan, xw)
    sweep = ksw.edge_sweep_plain if family == "edges" else \
        ksw.tet_sweep_plain
    alpha = 1e-2 if family == "edges" else 0.0
    x_ref, l_ref = xw.clone(), lam.clone()
    sweep(dplan, x_ref, l_ref, wt, alpha)
    assert not torch.equal(x_ref, xw)
    sched = tsp.build_schedule(g, 7)
    assert sched.queues > 1 and len(sched.wait) > 0
    rng = np.random.default_rng(0)
    orders = {tuple(_run_queues(sched, rng)) for _ in range(3)}
    assert any(list(o) != sorted(o) for o in orders)
    for order in orders:
        x, lm = xw.clone(), lam.clone()
        sweep(dplan, x, lm, wt, alpha, order=list(order))
        assert torch.equal(x, x_ref) and torch.equal(lm, l_ref)
