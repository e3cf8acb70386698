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
  contribution goes to (-1 for a corner the tile does not own);
* per owned vertex the end of its run of slots: the slots of one owned
  vertex are contiguous, ordered by listed constraint then role, and that
  run is the fixed order of its sum.

So every (owned vertex, incident constraint, role) has exactly one slot,
in the tile that owns the vertex.  The CUDA pass (``csrc/jacobi.cu``) runs
one CTA per tile: it stages the referenced rows of the snapshot in shared
memory, computes each listed constraint once, writes the owned corners'
contributions to their slots (shared memory too), and each owned vertex
sums its run and applies.  A constraint whose corners lie in several tiles
is computed once in each.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# owned vertices per tile, at most: the north star's tiles are then cubes
# of 6 x 6 x 6 vertices (their shared memory and CTAs per SM: PERF.md)
TILE_CAP = 256
SLOT_BYTES = 16               # one float4: contribution xyz, count flag
ROW_BYTES = 16                # one float4: x, y, z, inverse mass
INT16_MAX = np.iinfo(np.int16).max


class TilePlan(NamedTuple):
    """One constraint family cut into vertex tiles (tile-major tables)."""

    arity: int
    num_tiles: int
    row_ptr: np.ndarray        # (n+1,) int32 -- a tile's referenced rows
    rows: np.ndarray           # (sum R,) int32 global vertex, owned first
    own_ptr: np.ndarray        # (n+1,) int32 -- a tile's owned vertices
    slot_end: np.ndarray       # (V,) int16 end of each owned vertex's slots
    con_ptr: np.ndarray        # (n+1,) int32 -- a tile's listed constraints
    cons: np.ndarray           # (sum C,) int64 global constraint id
    rec: np.ndarray            # (sum C, 2 * arity) int16 local rows, slots
    max_rows: int              # largest tile: referenced rows
    max_cons: int              #               listed constraints
    max_slots: int             #               slots
    smem_bytes: int            # shared memory of the largest tile


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


def tile_plan(num_particles: int, cons, vertices,
              cap: int = TILE_CAP) -> TilePlan:
    """The tile plan of one family; ``cons`` (C, arity) vertex ids,
    ``vertices`` (V, 3) the rest positions the tiles are cut from."""
    V = int(num_particles)
    cons = np.asarray(cons, np.int64)
    arity = cons.shape[1] if cons.ndim == 2 else 2
    cons = cons.reshape(-1, arity)
    C = len(cons)
    if cap < 1:
        raise ValueError(f"cap must be positive, got {cap}")
    tile_of = spatial_tiles(vertices, cap)
    nt = int(tile_of.max()) + 1 if V else 0

    # owned vertices, tile-major, ascending id inside a tile
    own_cnt = np.bincount(tile_of, minlength=nt)
    own_ptr = np.concatenate([[0], np.cumsum(own_cnt)])
    owned = np.lexsort((np.arange(V), tile_of))
    own_rank = np.empty(V, np.int64)
    own_rank[owned] = np.arange(V) - own_ptr[tile_of[owned]]

    # listing: one (tile, constraint) pair per distinct tile of its corners
    key = np.unique(tile_of[cons].ravel() * max(C, 1)
                    + np.repeat(np.arange(C), arity))
    ltile, lcon = key // max(C, 1), key % max(C, 1)
    con_ptr = np.searchsorted(ltile, np.arange(nt + 1))
    corner = cons[lcon]
    own = tile_of[corner] == ltile[:, None]

    # local rows: owned -> its rank; halo -> after the owned rows, in
    # ascending id
    hkey = (ltile[:, None] * V + corner)[~own]
    halo = np.unique(hkey)
    htile, hvert = halo // max(V, 1), halo % max(V, 1)
    hptr = np.searchsorted(htile, np.arange(nt + 1))
    loc = own_rank[corner]
    hpos = np.searchsorted(halo, hkey)
    loc[~own] = own_cnt[htile[hpos]] + hpos - hptr[htile[hpos]]
    row_ptr = own_ptr + hptr
    rows = np.empty(V + len(halo), np.int64)
    rows[row_ptr[tile_of[owned]] + own_rank[owned]] = owned
    rows[row_ptr[htile] + own_cnt[htile] + np.arange(len(halo))
         - hptr[htile]] = hvert

    # slots: per owned vertex a contiguous run, by listed constraint, role
    li, ri = np.nonzero(own)
    v = corner[li, ri]
    t = ltile[li]
    order = np.lexsort((ri, li, own_rank[v], t))
    deg = np.bincount(own_ptr[tile_of[v]] + own_rank[v], minlength=V)
    ends = np.cumsum(deg)                     # tile-major owned order
    base = np.zeros(nt, np.int64)
    if nt:
        base[1:] = ends[own_ptr[1:-1] - 1]
    slot = np.empty(len(order), np.int64)
    slot[order] = np.arange(len(order)) - base[t[order]]
    dst = np.full(corner.shape, -1, np.int64)
    dst[li, ri] = slot
    owner = np.repeat(np.arange(nt), own_cnt)
    slot_end = ends - base[owner]

    nrows = np.diff(row_ptr)
    ncons = np.diff(con_ptr)
    nslots = (slot_end[own_ptr[1:] - 1] if nt else np.zeros(0, np.int64))
    nslots = np.where(own_cnt > 0, nslots, 0)
    big = max(int(nrows.max(initial=0)), int(nslots.max(initial=0)))
    if big > INT16_MAX:
        raise ValueError(f"a tile of {big} rows or slots exceeds the int16 "
                         f"local indices: use a smaller cap than {cap}")
    smem = (nrows * ROW_BYTES + nslots * SLOT_BYTES)
    return TilePlan(
        arity=arity, num_tiles=nt, row_ptr=row_ptr.astype(np.int32),
        rows=rows.astype(np.int32), own_ptr=own_ptr.astype(np.int32),
        slot_end=slot_end.astype(np.int16),
        con_ptr=con_ptr.astype(np.int32), cons=lcon,
        rec=np.concatenate([loc, dst], 1).astype(np.int16),
        max_rows=int(nrows.max(initial=0)),
        max_cons=int(ncons.max(initial=0)),
        max_slots=int(nslots.max(initial=0)),
        smem_bytes=int(smem.max(initial=0)))


def describe(plan, listed: int, num_constraints: int) -> str:
    """One line: tiles, the largest tile, its shared memory, and the
    constraints listed over the family's (``plan``: a TilePlan or the
    device Tiles of one)."""
    return (f"{plan.num_tiles} tiles; largest: {plan.max_rows} rows, "
            f"{plan.max_cons} constraints, {plan.max_slots} slots, "
            f"{plan.smem_bytes} bytes of shared memory; "
            f"{listed / max(num_constraints, 1):.3f}x the constraints "
            "listed")
