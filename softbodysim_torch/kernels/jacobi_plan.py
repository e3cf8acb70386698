"""Host-side (NumPy) tile plans of the Jacobi pass kernels.

A Jacobi pass reads one snapshot, so every constraint can be computed in
any order; what must be fixed is the order in which a vertex's
contributions are summed (no atomics: a pass gives the same bits on every
launch).  ``tile_plan`` cuts the vertices into spatial tiles of at most
``cap`` owned vertices (``spatial_tiles``: median bisection of the rest
positions along the longest extent) and, for each tile, lists

* its referenced rows: the owned vertices (ascending id), then the halo
  its constraints reach (ascending id) -- block-local int16 indices;
* every constraint with at least one owned corner (ascending id), as
  ``arity`` local rows plus, per corner, the tile-local slot its
  contribution goes to (-1 for a corner the tile does not sum);
* per owned vertex the end of its run of slots: the slots of one owned
  vertex are contiguous, ordered by listed constraint then role, and that
  run is the fixed order of its sum.

So every (owned vertex, incident constraint, role) has exactly one slot,
in the tile that owns the vertex.  The CUDA pass (``csrc/jacobi.cu``) runs
one CTA per tile: it stages the referenced rows of the snapshot in shared
memory, computes each listed constraint once, writes the contributions to
their slots (shared memory too), and each owned vertex sums its run and
applies.  A constraint whose corners lie in several tiles is computed once
in each.

Heavy vertices.  A vertex whose run would hold more than ``HEAVY_RUN``
slots (the centre of a fan-tetrahedralised ball is in every tet) is owned
by no tile: one tile's shared memory could not hold its run.  It is a
halo row of every tile that lists one of its constraints, and each
(heavy vertex, constraint, role) gets its slot in exactly one tile, the
constraint's home: the tile of its lowest-id light corner, or, when every
corner is heavy, tile ``constraint id % tiles`` (which then lists it).
After its owned runs a tile holds one run per heavy vertex it sums for
(ascending id); the kernel writes each run's sum and count as one partial
to a device table, heavy-major (a heavy vertex's partials contiguous, in
tile order), and the launch's last CTA sums each heavy vertex's partials
in that order and applies.  So every (vertex, constraint, role) still has
exactly one slot, and every sum a fixed order.

``tile_plan`` checks that every tile fits the kernel: its rows and slots
in int16 and its shared memory within ``smem_budget``; a mesh that does
not fit raises ``TileFitError``.  ``pass_tiles`` cuts both families of a
mesh for the pass step, within the budget its colliders leave.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# owned vertices per tile, at most: the north star's tiles are then cubes
# of 6 x 6 x 6 vertices (their shared memory and CTAs per SM: PERF.md)
TILE_CAP = 256
# a vertex with a longer run of slots is heavy: 8 KB of shared memory, far
# above a normal mesh's valence (the north star's largest run is 24 tets;
# SampleScene's centre is in 320) and 1/28 of a tile's whole budget
HEAVY_RUN = 512
SLOT_BYTES = 16               # one float4: contribution xyz, count flag
ROW_BYTES = 16                # one float4: x, y, z, inverse mass
COLLIDER_BYTES = 48           # one row of the packed collider table
SMEM_LIMIT = 232_448          # the H100's opt-in shared memory per CTA
# partials the finishing CTA stages in shared memory at once, at most
FINISH_CHUNK = 512
INT16_MAX = np.iinfo(np.int16).max


class TileFitError(ValueError):
    """A tile of the plan does not fit the pass kernel."""


class TilePlan(NamedTuple):
    """One constraint family cut into vertex tiles (tile-major tables)."""

    arity: int
    num_tiles: int
    row_ptr: np.ndarray        # (n+1,) int32 -- a tile's referenced rows
    rows: np.ndarray           # (sum R,) int32 global vertex, owned first
    own_ptr: np.ndarray        # (n+1,) int32 -- a tile's owned vertices
    slot_end: np.ndarray       # (sum owned,) int16 end of each owned run
    con_ptr: np.ndarray        # (n+1,) int32 -- a tile's listed constraints
    cons: np.ndarray           # (sum C,) int64 global constraint id
    rec: np.ndarray            # (sum C, 2 * arity) int16 local rows, slots
    part_ptr: np.ndarray       # (n+1,) int32 -- a tile's heavy runs
    part_end: np.ndarray       # (P,) int16 end of each heavy run
    part_dst: np.ndarray       # (P,) int32 its partial (heavy-major)
    heavy: np.ndarray          # (H,) int32 heavy vertices, ascending
    heavy_ptr: np.ndarray      # (H+1,) int32 -- a heavy vertex's partials
    max_rows: int              # largest tile: referenced rows
    max_cons: int              #               listed constraints
    max_slots: int             #               slots
    smem_bytes: int            # the largest tile's shared memory (and
                               # at least the finishing CTA's partials)


def pass_budget(num_colliders: int) -> int:
    """A tile's shared-memory budget in a pass that also stages a collider
    table of ``num_colliders`` rows (at least one: the packed table of an
    empty set is one inactive row)."""
    return SMEM_LIMIT - COLLIDER_BYTES * max(1, int(num_colliders))


def spatial_tiles(vertices: np.ndarray, cap: int) -> np.ndarray:
    """Tile id per vertex: the rest positions split at the median of the
    longest extent until every part holds at most ``cap`` vertices (parts
    of a split differ by at most one vertex; ties go by vertex id).  Tiles
    are numbered depth first, so neighbouring ids are neighbouring
    regions."""
    p = np.asarray(vertices, np.float64).reshape(-1, 3)
    tile = np.zeros(len(p), np.int64)
    stack, n = [np.arange(len(p))], 0
    while stack:
        idx = stack.pop()
        if len(idx) <= cap:
            tile[idx] = n
            n += 1
            continue
        q = p[idx]
        ax = int(np.argmax(q.max(0) - q.min(0)))
        idx = idx[np.argsort(q[:, ax], kind="stable")]
        half = len(idx) // 2
        stack += [idx[half:], idx[:half]]      # the lower half next
    return tile


def _runs(key, order_keys, ngroups):
    """Rank of each entry inside its group (``key``, ascending) when the
    entries are ordered by ``order_keys`` (np.lexsort keys, last primary),
    and the group sizes."""
    order = np.lexsort(order_keys)
    first = np.searchsorted(key[order], np.arange(ngroups))
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order)) - first[key[order]]
    return rank, np.bincount(key, minlength=ngroups)


def tile_plan(num_particles: int, cons, vertices, cap: int = TILE_CAP,
              smem_budget: int = SMEM_LIMIT) -> TilePlan:
    """The tile plan of one family; ``cons`` (C, arity) vertex ids,
    ``vertices`` (V, 3) the rest positions the tiles are cut from.
    Raises ``TileFitError`` when a tile does not fit int16 or
    ``smem_budget`` bytes of shared memory."""
    V = int(num_particles)
    cons = np.asarray(cons, np.int64)
    arity = cons.shape[1] if cons.ndim == 2 else 2
    cons = cons.reshape(-1, arity)
    C = len(cons)
    if cap < 1:
        raise ValueError(f"cap must be positive, got {cap}")
    is_heavy = np.bincount(cons.ravel(), minlength=V) > HEAVY_RUN
    heavy = np.flatnonzero(is_heavy)
    light = np.flatnonzero(~is_heavy)
    tile_of = np.full(V, -1, np.int64)
    tile_of[light] = spatial_tiles(
        np.asarray(vertices).reshape(-1, 3)[light], cap)
    nt = int(tile_of.max()) + 1 if len(light) else int(C > 0)

    # owned vertices, tile-major, ascending id inside a tile
    own_cnt = np.bincount(tile_of[light], minlength=nt)
    own_ptr = np.concatenate([[0], np.cumsum(own_cnt)])
    owned = light[np.lexsort((light, tile_of[light]))]
    own_rank = np.zeros(V, np.int64)
    own_rank[owned] = np.arange(len(owned)) - own_ptr[tile_of[owned]]

    # a constraint's home: the tile of its lowest-id light corner, else
    # (every corner heavy) tile id % tiles
    ctile = tile_of[cons]
    cid = np.arange(C)
    home = ctile[cid, np.where(is_heavy[cons], V, cons).argmin(1)]
    all_heavy = home < 0
    home[all_heavy] = cid[all_heavy] % max(nt, 1)

    # listing: one (tile, constraint) pair per distinct tile of its light
    # corners, and its home
    pt = np.concatenate([ctile.ravel(), home[all_heavy]])
    pc = np.concatenate([np.repeat(cid, arity), cid[all_heavy]])
    keep = pt >= 0
    key = np.unique(pt[keep] * max(C, 1) + pc[keep])
    ltile, lcon = key // max(C, 1), key % max(C, 1)
    con_ptr = np.searchsorted(ltile, np.arange(nt + 1))
    corner = cons[lcon]
    own = tile_of[corner] == ltile[:, None]
    hsum = is_heavy[corner] & (home[lcon] == ltile)[:, None]

    # local rows: owned -> its rank; halo (heavy corners too) -> after the
    # owned rows, in ascending id
    hkey = (ltile[:, None] * V + corner)[~own]
    halo = np.unique(hkey)
    htile, hvert = halo // max(V, 1), halo % max(V, 1)
    hptr = np.searchsorted(htile, np.arange(nt + 1))
    loc = own_rank[corner]
    hpos = np.searchsorted(halo, hkey)
    loc[~own] = own_cnt[htile[hpos]] + hpos - hptr[htile[hpos]]
    row_ptr = own_ptr + hptr
    rows = np.empty(len(owned) + len(halo), np.int64)
    rows[row_ptr[tile_of[owned]] + own_rank[owned]] = owned
    rows[row_ptr[htile] + own_cnt[htile] + np.arange(len(halo))
         - hptr[htile]] = hvert

    # owned slots: per owned vertex a contiguous run, by listed constraint,
    # role
    dst = np.full(corner.shape, -1, np.int64)
    li, ri = np.nonzero(own)
    v = corner[li, ri]
    opos = own_ptr[tile_of[v]] + own_rank[v]          # tile-major owned id
    rank, deg = _runs(opos, (ri, li, opos), len(owned))
    cum = np.concatenate([[0], np.cumsum(deg)])
    base = cum[own_ptr]                               # a tile's first slot
    nown = np.diff(base)                              # owned slots per tile
    owner = np.repeat(np.arange(nt), own_cnt)
    slot_end = cum[1:] - base[owner]
    dst[li, ri] = cum[opos] - base[tile_of[v]] + rank

    # heavy slots: per (tile, heavy vertex) a run after the owned runs, by
    # listed constraint, role; one partial per run
    li, ri = np.nonzero(hsum)
    v, t = corner[li, ri], ltile[li]
    parts, pid = np.unique(t * max(V, 1) + v, return_inverse=True)
    ptile, pvert = parts // max(V, 1), parts % max(V, 1)
    pid = pid.reshape(-1)
    rank, plen = _runs(pid, (ri, li, pid), len(parts))
    pcum = np.concatenate([[0], np.cumsum(plen)])
    part_ptr = np.searchsorted(ptile, np.arange(nt + 1))
    pbase = pcum[part_ptr]                            # a tile's first one
    part_end = nown[ptile] + pcum[1:] - pbase[ptile]
    dst[li, ri] = nown[t] + pcum[pid] - pbase[t] + rank
    hid = np.searchsorted(heavy, pvert)
    part_dst = np.empty(len(parts), np.int64)
    part_dst[np.lexsort((ptile, hid))] = np.arange(len(parts))
    heavy_ptr = np.concatenate([[0], np.cumsum(
        np.bincount(hid, minlength=len(heavy)))])

    nrows = np.diff(row_ptr)
    ncons = np.diff(con_ptr)
    nslots = nown + np.diff(pbase)
    smem = (nrows * ROW_BYTES + nslots * SLOT_BYTES)
    big = np.maximum(nrows, nslots)
    bad = np.flatnonzero((big > INT16_MAX) | (smem > smem_budget))
    if len(bad):
        t = bad[np.argmax(smem[bad])]
        raise TileFitError(
            f"tile {t} of {nt} needs {nrows[t]} rows and {nslots[t]} slots "
            f"({smem[t]} bytes of shared memory): over the pass kernel's "
            f"int16 local indices ({INT16_MAX}) or its budget of "
            f"{smem_budget} bytes (cap {cap}, {len(heavy)} heavy vertices "
            f"of more than {HEAVY_RUN} slots); use jacobi_backend='gather'")
    i32 = np.int32
    return TilePlan(
        arity=arity, num_tiles=nt, row_ptr=row_ptr.astype(i32),
        rows=rows.astype(i32), own_ptr=own_ptr.astype(i32),
        slot_end=slot_end.astype(np.int16),
        con_ptr=con_ptr.astype(i32), cons=lcon,
        rec=np.concatenate([loc, dst], 1).astype(np.int16),
        part_ptr=part_ptr.astype(i32), part_end=part_end.astype(np.int16),
        part_dst=part_dst.astype(i32), heavy=heavy.astype(i32),
        heavy_ptr=heavy_ptr.astype(i32),
        max_rows=int(nrows.max(initial=0)),
        max_cons=int(ncons.max(initial=0)),
        max_slots=int(nslots.max(initial=0)),
        smem_bytes=max(int(smem.max(initial=0)),
                       SLOT_BYTES * min(len(parts), FINISH_CHUNK)))


def pass_tiles(topology, num_colliders: int = 0) -> tuple:
    """The tile plans (edge, tet; None for a family the mesh lacks) of
    ``topology`` for a pass step whose last pass stages ``num_colliders``
    colliders (``pass_budget``).  Raises ``TileFitError`` when a tile
    does not fit."""
    budget = pass_budget(num_colliders)
    return tuple(
        tile_plan(topology.num_particles, cons, topology.vertices,
                  smem_budget=budget) if len(cons) else None
        for cons in (topology.edges, topology.tets))


def describe(plan, listed: int, num_constraints: int) -> str:
    """One line: tiles, the largest tile, its shared memory, the heavy
    vertices and the constraints listed over the family's (``plan``: a
    TilePlan or the device Tiles of one)."""
    return (f"{plan.num_tiles} tiles; largest: {plan.max_rows} rows, "
            f"{plan.max_cons} constraints, {plan.max_slots} slots, "
            f"{plan.smem_bytes} bytes of shared memory; "
            f"{len(plan.heavy)} heavy vertices, {len(plan.part_dst)} "
            f"partials; {listed / max(num_constraints, 1):.3f}x the "
            "constraints listed")
