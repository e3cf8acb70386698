"""Host-side (NumPy) packing for the block-synchronous XPBD sweeps.

The host half of ``softbodysim_tpu/kernels/sweep.py``: constraints of one
family are packed either into super-blocks of 1024 constraints
(``pack_superblocks``, native C++ when available; then regrouped by
``regroup_plan``) or into the legacy 128-constraint blocks
(``pack_constraints``, the ``superblocks=False`` path), and vertices are
laid out for locality (``order_vertices`` / ``aligned_order``).  These
produce the same plans as the JAX package, array for array, and so the same
semantics:

* inside a block every constraint reads the pre-block positions and the
  corrections sum (Jacobi);
* blocks run one after another in ``perm`` order -- after regrouping -- so
  updates propagate between blocks (Gauss-Seidel).

``build_gpu_plan`` then turns a plan into what the CUDA kernels read: per
packed lane the constraint's layout vertex ids, rest value and resolved
dlambda scale, the w-fill count table (super-blocks only), and a per-block
vertex CSR that fixes the order in which each vertex's corrections are
summed.  The TPU-only tables (window slots, lane-relative ids, inverse
scatter maps, ragged profiles) are not carried to the device.

``stage_plan`` deals a GpuPlan's blocks to the persistent CTAs of the
CUDA sweeps (``build_schedule``: each CTA walks its blocks in plan order
and first waits for the predecessors it shares a vertex with on other
CTAs, so the result is plan order's, bit for bit) and lays each block's
slice of the plan out for bulk copies into shared memory.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np

LANES = 128
SUBBLOCKS = 8                 # sub-blocks of LANES per super-block
BLOCK = SUBBLOCKS * LANES     # constraints per super-block (1024)
# regroup_plan: at most this many execution groups, and only for plans of
# at least this many blocks (the JAX package's defaults)
MAX_GROUPS = 3
MIN_GROUP_BLOCKS = 4 * SUBBLOCKS
# aligned_order: target vertices per component group
ALIGN_GROUP = 2048


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Packed schedule at 128-constraint block granularity (the JAX
    package's SweepPlan, same arrays): the legacy ``superblocks=False``
    path.

    slots : (NB, 8) int32 -- cols 0..S-1 window ids, col S used count
    rel   : (NB*arity, 128) int32 -- per role, slot*128 + lane in window
    inv   : (NB*S*dmax, 128) int32 -- per (slot, layer): window lane ->
            role*128 + block lane, or -1
    rest, scale : (NB, 128) f32 -- scale = 1 / (largest within-block
            multiplicity of the lane's vertices)
    perm  : (NB*128,) packed lane -> constraint id (-1 pad)
    pos_of: (N,) constraint id -> packed lane
    """

    arity: int
    num_blocks: int
    nslots: int
    dmax: int
    slots: np.ndarray
    rel: np.ndarray
    inv: np.ndarray
    rest: np.ndarray
    perm: np.ndarray
    pos_of: np.ndarray
    scale: np.ndarray

    @property
    def capacity(self) -> int:
        return self.num_blocks * LANES


@dataclasses.dataclass(frozen=True)
class SuperPlan:
    """Packed schedule at super-block granularity (the JAX package's
    SuperPlan, same arrays).

    slots : (NSUP, 128) int32 -- cols 0..S-1 windows, col S used count
    rel   : (NSUP*arity*8, 128) int32 -- per (block, role): slot*128+lane
    inv   : (NSUP*S*dmax*8, 128) int32 -- per (block, slot, layer) inverse
            scatter map (role*128 + source lane, or -1)
    rest, scale : (NSUP*8, 128) f32 in packed order
    perm  : (NSUP*8*128,) packed position -> constraint id (-1 pad)
    pos_of: (N,) constraint id -> packed position
    groups: execution groups from regroup_plan, or None
    """

    arity: int
    num_super: int
    nslots: int
    dmax: int
    slots: np.ndarray
    rel: np.ndarray
    inv: np.ndarray
    rest: np.ndarray
    perm: np.ndarray
    pos_of: np.ndarray
    scale: np.ndarray
    groups: Optional[Tuple[Tuple[int, int, int], ...]] = None

    @property
    def capacity(self) -> int:
        return self.num_super * BLOCK


def _pack_order(win: np.ndarray, mode: int = 1) -> np.ndarray:
    """Greedy-scan order: mode 0 lexicographic by per-role window tuple,
    mode 1 by (min window, max window)."""
    if mode == 0:
        return np.lexsort(tuple(win[:, r]
                                for r in reversed(range(win.shape[1]))))
    return np.lexsort((win.max(axis=1), win.min(axis=1)))


def block_width(plan) -> int:
    """Constraints per synchronous block: 1024 for a SuperPlan, 128 for a
    SweepPlan (the oracle's replay granularity)."""
    return BLOCK if isinstance(plan, SuperPlan) else LANES


def num_blocks(plan) -> int:
    return plan.num_super if isinstance(plan, SuperPlan) else plan.num_blocks


def _trim_plan(plan):
    """Drop trailing all-empty blocks when fewer than SUBBLOCKS are used
    (either plan kind)."""
    is_super = isinstance(plan, SuperPlan)
    nb, width = num_blocks(plan), block_width(plan)
    used_mask = (plan.perm.reshape(nb, width) >= 0).any(axis=1)
    used = max(1, int(np.flatnonzero(used_mask).max()) + 1
               if used_mask.any() else 1)
    if used >= SUBBLOCKS or used == nb:
        return plan
    S, dmax, arity = plan.nslots, plan.dmax, plan.arity
    sub = SUBBLOCKS if is_super else 1
    kw = dict(
        arity=arity, nslots=S, dmax=dmax,
        slots=plan.slots[:used],
        rel=plan.rel[: used * arity * sub],
        inv=plan.inv[: used * S * dmax * sub],
        rest=plan.rest[: used * sub],
        scale=plan.scale[: used * sub],
        perm=plan.perm[: used * width],
        pos_of=plan.pos_of)
    if is_super:
        return SuperPlan(num_super=used, **kw)
    return SweepPlan(num_blocks=used, **kw)


def pack_constraints(cons: np.ndarray, rest: np.ndarray, *,
                     slots_cap: int = 4, layer_cap: int = 3,
                     order_mode: int = 1) -> SweepPlan:
    """Greedy multi-pass packing into 128-lane blocks with bounded window
    slots (the JAX package's Python loop, kept as it is): constraints in
    ``_pack_order`` fill blocks in order; one that would exceed the slot,
    lane or per-vertex layer budget spills to the next pass, and a
    slot-starved block closes after 64 consecutive spills."""
    cons = np.asarray(cons, np.int64)
    n, arity = cons.shape
    win = cons // LANES
    remaining = list(_pack_order(win, order_mode))
    blocks = []     # (slot_list, [constraint ids])

    while remaining:
        spill = []
        cur_slots: list = []
        cur_ids: list = []
        cur_counts: dict = {}
        streak = 0

        def close():
            nonlocal cur_slots, cur_ids, cur_counts, streak
            if cur_ids:
                blocks.append((cur_slots, cur_ids))
            cur_slots, cur_ids, cur_counts = [], [], {}
            streak = 0

        for i in remaining:
            ws = dict.fromkeys(win[i])
            new_slots = [w for w in ws if w not in cur_slots]
            if (len(cur_ids) >= LANES
                    or len(cur_slots) + len(new_slots) > slots_cap):
                if len(cur_ids) >= LANES or streak >= 64:
                    close()
                    new_slots = list(ws)
                else:
                    spill.append(i)
                    streak += 1
                    continue
            if any(cur_counts.get(v, 0) >= layer_cap for v in cons[i]):
                spill.append(i)
                streak += 1
                continue
            cur_slots.extend(new_slots)
            cur_ids.append(i)
            streak = 0
            for v in cons[i]:
                cur_counts[v] = cur_counts.get(v, 0) + 1
        close()
        remaining = spill

    nblk = -(-max(len(blocks), 1) // SUBBLOCKS) * SUBBLOCKS
    s_cap = slots_cap
    dmax = 1
    slots = np.zeros((nblk, 8), np.int32)
    rel = np.zeros((nblk, arity, LANES), np.int32)
    rest_p = np.ones((nblk, LANES), np.float32)
    perm = np.full((nblk * LANES,), -1, np.int64)
    scale = np.ones((nblk, LANES), np.float32)
    inv_entries = np.full((nblk, s_cap, layer_cap, LANES), -1, np.int32)

    for b, (slot_list, ids) in enumerate(blocks):
        slot_list = list(slot_list)
        for t, w in enumerate(slot_list):
            slots[b, t] = w
        for t in range(len(slot_list), s_cap):
            slots[b, t] = slot_list[0] if slot_list else 0
        slots[b, s_cap] = len(slot_list)

        lane_layers: dict = {}
        for j, i in enumerate(ids):
            perm[b * LANES + j] = i
            rest_p[b, j] = rest[i]
            for r in range(arity):
                v = int(cons[i, r])
                t = slot_list.index(v // LANES)
                l_in = v % LANES
                rel[b, r, j] = t * LANES + l_in
                layer = lane_layers.get((t, l_in), 0)
                lane_layers[(t, l_in)] = layer + 1
                dmax = max(dmax, layer + 1)
                inv_entries[b, t, layer, l_in] = r * LANES + j
        # dlambda / m, m the largest within-block multiplicity of the
        # constraint's vertices
        for j, i in enumerate(ids):
            m = 1
            for r in range(arity):
                v = int(cons[i, r])
                m = max(m, lane_layers[(slot_list.index(v // LANES),
                                        v % LANES)])
            scale[b, j] = np.float32(1.0) / np.float32(m)

    inv = np.ascontiguousarray(
        inv_entries[:, :, :dmax, :].reshape(nblk * s_cap * dmax, LANES))
    pos_of = np.full((n,), -1, np.int64)
    valid = perm >= 0
    pos_of[perm[valid]] = np.flatnonzero(valid)
    return _trim_plan(SweepPlan(
        arity=arity, num_blocks=nblk, nslots=s_cap, dmax=dmax,
        slots=slots, rel=rel.reshape(nblk * arity, LANES), inv=inv,
        rest=rest_p, perm=perm, pos_of=pos_of, scale=scale))


def pack_superblocks(cons: np.ndarray, rest: np.ndarray, *,
                     slots_cap: int = 8, layer_cap: int = 2,
                     order_mode: int = 1) -> SuperPlan:
    """Greedy packing of constraints into 1024-lane super-blocks; native
    C++ (``st_pack_super``) when the library is available, this Python
    loop otherwise (bit-identical plans)."""
    cons = np.asarray(cons, np.int64)
    n, arity = cons.shape

    from ..core.native import native_pack_super

    packed = native_pack_super(cons, slots_cap, layer_cap, order_mode)
    if packed is not None:
        nsup, dmax, slots, rel, inv, perm, scale = packed
        rest_p = np.ones((nsup * 8, LANES), np.float32)
        valid = perm >= 0
        rest_p.reshape(-1)[valid] = np.asarray(rest, np.float32)[
            perm[valid]]
        pos_of = np.full((n,), -1, np.int64)
        pos_of[perm[valid]] = np.flatnonzero(valid)
        return _trim_plan(SuperPlan(
            arity=arity, num_super=nsup, nslots=slots_cap, dmax=dmax,
            slots=slots, rel=rel, inv=inv, rest=rest_p, perm=perm,
            pos_of=pos_of, scale=scale))

    win = cons // LANES
    remaining = list(_pack_order(win, order_mode))
    blocks = []   # (slot_list, lanes) where lanes = 8 lists of ids

    while remaining:
        spill = []
        cur_slots: list = []
        lanes = [[] for _ in range(8)]
        counts: dict = {}         # (sublane, vertex) -> multiplicity
        cur_n = 0
        streak = 0

        def close():
            nonlocal cur_slots, lanes, counts, cur_n, streak
            if cur_n:
                blocks.append((cur_slots, lanes))
            cur_slots = []
            lanes = [[] for _ in range(8)]
            counts = {}
            cur_n = 0
            streak = 0

        for i in remaining:
            ws = dict.fromkeys(win[i])
            new_slots = [w for w in ws if w not in cur_slots]
            if (cur_n >= BLOCK
                    or len(cur_slots) + len(new_slots) > slots_cap):
                if cur_n >= BLOCK or streak >= 256:
                    close()
                    new_slots = list(ws)
                else:
                    spill.append(i)
                    streak += 1
                    continue
            # the sublane with a free lane where this constraint's vertices
            # have the lowest multiplicity
            best_g, best_m = -1, layer_cap
            for off in range(8):
                g = (cur_n + off) % 8
                if len(lanes[g]) >= LANES:
                    continue
                m = max(counts.get((g, v), 0) for v in cons[i])
                if m < best_m:
                    best_g, best_m = g, m
                    if m == 0:
                        break
            if best_g < 0:
                spill.append(i)
                streak += 1
                continue
            cur_slots.extend(new_slots)
            lanes[best_g].append(i)
            cur_n += 1
            streak = 0
            for v in cons[i]:
                counts[(best_g, v)] = counts.get((best_g, v), 0) + 1
        close()
        remaining = spill

    nsup = -(-max(len(blocks), 1) // SUBBLOCKS) * SUBBLOCKS
    s_cap = slots_cap
    dmax = 1
    slots = np.zeros((nsup, LANES), np.int32)
    rel = np.zeros((nsup, arity, 8, LANES), np.int32)
    rest_p = np.ones((nsup, 8, LANES), np.float32)
    perm = np.full((nsup * BLOCK,), -1, np.int64)
    scale = np.ones((nsup, 8, LANES), np.float32)
    inv_entries = np.full((nsup, s_cap, layer_cap, 8, LANES), -1, np.int32)

    for b, (slot_list, lanes) in enumerate(blocks):
        slot_list = list(slot_list)
        for t, w in enumerate(slot_list):
            slots[b, t] = w
        for t in range(len(slot_list), s_cap):
            slots[b, t] = slot_list[0] if slot_list else 0
        slots[b, s_cap] = len(slot_list)

        lane_layers: dict = {}
        totals: dict = {}          # cross-sublane multiplicity per vertex
        for g in range(8):
            for j, i in enumerate(lanes[g]):
                perm[(b * 8 + g) * LANES + j] = i
                rest_p[b, g, j] = rest[i]
                for r in range(arity):
                    v = int(cons[i, r])
                    t = slot_list.index(v // LANES)
                    l_in = v % LANES
                    rel[b, r, g, j] = t * LANES + l_in
                    layer = lane_layers.get((g, t, l_in), 0)
                    lane_layers[(g, t, l_in)] = layer + 1
                    dmax = max(dmax, layer + 1)
                    inv_entries[b, t, layer, g, l_in] = r * LANES + j
                    totals[v] = totals.get(v, 0) + 1
        # legacy scale scheme: dlambda / (max summed corrections over the
        # constraint's vertices)
        for g in range(8):
            for j, i in enumerate(lanes[g]):
                m = max(totals[int(cons[i, r])] for r in range(arity))
                scale[b, g, j] = np.float32(1.0) / np.float32(m)

    inv = np.ascontiguousarray(
        inv_entries[:, :, :dmax].reshape(nsup * s_cap * dmax * 8, LANES))
    pos_of = np.full((n,), -1, np.int64)
    valid = perm >= 0
    pos_of[perm[valid]] = np.flatnonzero(valid)
    return _trim_plan(SuperPlan(
        arity=arity, num_super=nsup, nslots=s_cap, dmax=dmax,
        slots=slots, rel=rel.reshape(nsup * arity * 8, LANES), inv=inv,
        rest=rest_p.reshape(nsup * 8, LANES), perm=perm, pos_of=pos_of,
        scale=scale.reshape(nsup * 8, LANES)))


def regroup_plan(plan: SuperPlan) -> SuperPlan:
    """Reorder super-blocks into (<= MAX_GROUPS) execution groups by their
    required (slots, layers), as the JAX package does for its trimmed TPU
    kernels.  The grouping itself is a TPU unrolling device; what the port
    keeps is the resulting block ORDER (``perm``), which is the semantics
    every backend and the oracle replay.  Returns the plan unchanged when
    grouping would not pay."""
    if plan.groups is not None:
        return plan
    nb, S, D, a = plan.num_super, plan.nslots, plan.dmax, plan.arity
    if nb < MIN_GROUP_BLOCKS:
        return plan

    occ = plan.inv.reshape(nb, S, D, 8, LANES) >= 0
    lay = occ.any(axis=(1, 3, 4))                      # (nb, D)
    d_used = np.where(lay.any(axis=1),
                      D - np.argmax(lay[:, ::-1], axis=1), 1).astype(np.int64)
    slt = occ.any(axis=(2, 3, 4))                      # (nb, S)
    s_occ = np.where(slt.any(axis=1),
                     S - np.argmax(slt[:, ::-1], axis=1), 1)
    s_cnt = plan.slots[:, S].astype(np.int64)
    s_used = np.maximum(np.maximum(s_occ, s_cnt), 1)
    d_used = np.maximum(d_used, 1)

    def cost(s, d):                    # the packer's per-block op model
        return 12 * a * s + 15 * s * d + 80

    catch = (int(s_used.max()), int(d_used.max()))
    corners = sorted({(int(s), int(d)) for s, d in zip(s_used, d_used)}
                     | {catch})
    if len(corners) == 1:
        return plan
    cs = np.array([c[0] for c in corners])
    cd = np.array([c[1] for c in corners])
    dom = (cs[None, :] >= s_used[:, None]) & (cd[None, :] >= d_used[:, None])
    cmat = np.where(dom, np.array([cost(s, d) for s, d in corners])[None, :],
                    np.inf)

    ci_catch = corners.index(catch)
    others = [i for i in range(len(corners)) if i != ci_catch]
    best_cost, best_set = cmat[:, ci_catch].sum(), (ci_catch,)
    for r in range(1, MAX_GROUPS):
        for combo in itertools.combinations(others, r):
            sel = (ci_catch,) + combo
            tot = cmat[:, sel].min(axis=1).sum()
            if tot < best_cost - 1e-9:
                best_cost, best_set = tot, sel
    if len(best_set) == 1:
        return plan
    if best_cost > 0.98 * nb * cost(S, D):
        return plan

    sel = list(best_set)
    assign = np.array(sel)[np.argmin(cmat[:, sel], axis=1)]
    gorder = sorted(set(assign.tolist()) | {ci_catch},
                    key=lambda ci: (ci != ci_catch,
                                    -cost(*corners[ci]), corners[ci]))
    members = {ci: list(np.flatnonzero(assign == ci)) for ci in gorder}
    for ci in gorder:
        if ci == ci_catch:
            continue
        r = len(members[ci]) % SUBBLOCKS
        if r:
            members[ci_catch].extend(members[ci][-r:])
            del members[ci][-r:]
    gorder = [ci for ci in gorder if members[ci]]
    if len(gorder) == 1:
        return plan
    members[ci_catch].sort()

    order = np.concatenate([np.asarray(members[ci], np.int64)
                            for ci in gorder])
    groups = tuple((len(members[ci]),) + corners[ci] for ci in gorder)

    from ..core import native as _native

    def pb(arr):                       # permute block-major rows
        blk = np.ascontiguousarray(arr).reshape(nb, -1)
        out = _native.native_permute_blocks(blk, order)
        if out is None:                # numpy fallback, bit-identical
            out = blk[order]
        return np.ascontiguousarray(out.reshape(arr.shape))

    perm = pb(plan.perm).reshape(-1)
    pos_of = np.full_like(plan.pos_of, -1)
    valid = perm >= 0
    pos_of[perm[valid]] = np.flatnonzero(valid)
    return dataclasses.replace(
        plan, slots=pb(plan.slots), rel=pb(plan.rel), inv=pb(plan.inv),
        rest=pb(plan.rest), scale=pb(plan.scale),
        perm=perm, pos_of=pos_of, groups=groups)


def rcm_order(num_vertices: int, edges: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (new slot -> old id) of the edge
    graph."""
    if len(edges) == 0:
        return np.arange(num_vertices, dtype=np.int64)
    e = np.asarray(edges, np.int64)
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m = coo_matrix(
        (np.ones(len(e) * 2, np.float32),
         (np.concatenate([e[:, 0], e[:, 1]]),
          np.concatenate([e[:, 1], e[:, 0]]))),
        shape=(num_vertices, num_vertices)).tocsr()
    return reverse_cuthill_mckee(m).astype(np.int64)


def aligned_order(num_vertices: int, edges: np.ndarray):
    """Group-aligned layout for disconnected meshes: components grouped in
    first-vertex order into ~ALIGN_GROUP-vertex groups, each RCM-ordered
    onto its own 128-aligned span with dead slots (== num_vertices) in the
    gaps.  Returns (perm_layout, old2new), or None for connected meshes."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import (connected_components,
                                      reverse_cuthill_mckee)

    e = np.asarray(edges, np.int64)
    if len(e) == 0:
        return None
    A = coo_matrix(
        (np.ones(len(e) * 2, np.float32),
         (np.concatenate([e[:, 0], e[:, 1]]),
          np.concatenate([e[:, 1], e[:, 0]]))),
        shape=(num_vertices, num_vertices)).tocsr()
    ncomp, labels = connected_components(A, directed=False)
    if ncomp <= 1:
        return None
    comps = [np.flatnonzero(labels == c) for c in range(ncomp)]
    comps.sort(key=lambda v: int(v.min()))

    groups, cur, n = [], [], 0
    for vs in comps:
        cur.append(vs)
        n += len(vs)
        if n >= ALIGN_GROUP:
            groups.append(np.concatenate(cur))
            cur, n = [], 0
    if cur:
        groups.append(np.concatenate(cur))

    slots = []
    for group in groups:
        local = reverse_cuthill_mckee(A[group][:, group]).astype(np.int64)
        slots.append(group[local])
        pad = -len(group) % LANES
        if pad:
            slots.append(np.full(pad, num_vertices, np.int64))
    perm_layout = np.concatenate(slots)
    old2new = np.empty(num_vertices, np.int64)
    live = perm_layout < num_vertices
    old2new[perm_layout[live]] = np.flatnonzero(live)
    return perm_layout, old2new


def order_vertices(vertices: np.ndarray, edges: Optional[np.ndarray],
                   tets: Optional[np.ndarray]) -> np.ndarray:
    """Vertex permutation (new <- old): of the natural, Morton and RCM
    orders, the one with the fewest estimated window visits."""
    v = np.asarray(vertices, np.float64)

    def morton(p):
        lo = p.min(0)
        ext = np.maximum(p.max(0) - lo, 1e-9)
        q = ((p - lo) / ext * 1023.0).astype(np.uint32)

        def spread(x):
            x = x.astype(np.uint64)
            x = (x | (x << 16)) & 0x030000FF
            x = (x | (x << 8)) & 0x0300F00F
            x = (x | (x << 4)) & 0x030C30C3
            x = (x | (x << 2)) & 0x09249249
            return x

        return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)

    mor = np.argsort(morton(v), kind="stable").astype(np.int64)

    def visits(perm):
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        total = 0
        for cons in (edges, tets):
            if cons is None or len(cons) == 0:
                continue
            w = inv[np.asarray(cons, np.int64)] // LANES
            if w.max(initial=0) < (1 << 15) and w.shape[1] <= 4:
                key = np.zeros(len(w), np.uint64)
                for r in range(w.shape[1]):
                    key = (key << np.uint64(15)) | w[:, r].astype(np.uint64)
                so = np.argsort(key, kind="stable")
            else:
                so = np.lexsort(
                    tuple(w[:, r] for r in reversed(range(w.shape[1]))))
            w = w[so]
            nb = -(-len(w) // LANES)
            pad = nb * LANES - len(w)
            if pad:
                w = np.concatenate([w, np.repeat(w[-1:], pad, 0)], 0)
            blk = np.sort(w.reshape(nb, LANES, -1), axis=1)
            total += int((blk[:, 1:] != blk[:, :-1]).sum()) + nb * blk.shape[2]
        return total

    nat = np.arange(len(v), dtype=np.int64)
    cands = [nat, mor]
    if edges is not None and len(edges):
        cands.append(rcm_order(len(v), edges))
    scores = [visits(p) for p in cands]
    return cands[int(np.argmin(scores))]


# --------------------------------------------------------------------------
# The plan the CUDA sweep kernels read
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GpuPlan:
    """One constraint family's sweep schedule in packed order.

    Packed position p = block * width + lane (width 1024 for a SuperPlan,
    128 for a legacy SweepPlan); blocks run in index order.

    verts   : (NB*width, arity) int32 layout vertex ids, -1 on pad lanes
    rest    : (NB*width,) f32 rest length / signed rest volume (pad 1.0)
    scale   : (NB*width,) f32 resolved dlambda factor: omega under 'split',
              the packer's 1/max-multiplicity times omega under 'scale'
    counts  : (NB*width, arity) f32 w-fill factors: within-block vertex
              multiplicities (``block_counts``) under 'split', ones under
              'scale'; None for a legacy plan (its kernels read w from the
              particle table, no w-fill)
    atab    : (NB*width,) f32 per-constraint compliance, or None
    blk_vptr: (NB+1,) int32 -- block b owns CSR rows blk_vptr[b]:[b+1]
    cvert   : (U,) int32 -- CSR row -> layout vertex id (unique per block)
    cptr    : (U+1,) int32 -- CSR row u owns entries cptr[u]:cptr[u+1]
    centry  : (Ent,) int32 -- lane * 4 + role, ascending within a row: the
              fixed order in which a vertex's corrections are summed
    pos_of  : (N,) int64 public constraint id -> packed position
    """

    arity: int
    num_blocks: int
    width: int
    scheme: str
    verts: np.ndarray
    rest: np.ndarray
    scale: np.ndarray
    counts: Optional[np.ndarray]
    atab: Optional[np.ndarray]
    blk_vptr: np.ndarray
    cvert: np.ndarray
    cptr: np.ndarray
    centry: np.ndarray
    pos_of: np.ndarray


def build_gpu_plan(plan, cons_layout: np.ndarray, *,
                   scheme: str, omega: float,
                   compliance: Optional[np.ndarray] = None) -> GpuPlan:
    """GPU schedule of a (regrouped) SuperPlan or a legacy SweepPlan.

    cons_layout: (N, arity) constraint vertices in LAYOUT ids (old2new
    applied).  compliance: optional (N,) per-constraint compliance in
    public order.  A SweepPlan takes only the scale scheme at omega 1 (its
    kernels have no other)."""
    if scheme not in ("scale", "split"):
        raise ValueError(f"unknown block scheme {scheme!r}")
    legacy = isinstance(plan, SweepPlan)
    if legacy and (scheme != "scale" or omega != 1.0):
        raise ValueError("a legacy SweepPlan supports only the scale "
                         "scheme at omega 1")
    a, nb, width = plan.arity, num_blocks(plan), block_width(plan)
    n = nb * width
    perm = plan.perm.reshape(-1)
    live = perm >= 0
    verts = np.full((n, a), -1, np.int32)
    verts[live] = np.asarray(cons_layout, np.int64)[perm[live]]

    # CSR of (block, vertex) -> its (lane, role) entries: sort the live
    # entries by (block, vertex); np.nonzero is row-major and the sort is
    # stable, so entries of one vertex stay in (lane, role) order
    p_idx, r_idx = np.nonzero(verts >= 0)
    v = verts[p_idx, r_idx].astype(np.int64)
    blk = p_idx // width
    nv = int(v.max()) + 1 if v.size else 1
    order = np.argsort(blk * nv + v, kind="stable")
    key_s = (blk * nv + v)[order]
    start = np.ones(len(key_s), bool)
    start[1:] = key_s[1:] != key_s[:-1]
    seg_start = np.flatnonzero(start)
    cseg = np.cumsum(start) - 1
    seg_len = np.diff(np.append(seg_start, len(key_s)))
    cptr = np.append(seg_start, len(key_s))
    blk_vptr = np.searchsorted(blk[order][seg_start], np.arange(nb + 1))

    counts = None if legacy else np.ones((n, a), np.float32)
    if scheme == "split":
        counts[p_idx[order], r_idx[order]] = seg_len[cseg]
        scale = np.full((n,), np.float32(omega), np.float32)
    elif omega != 1.0:
        scale = plan.scale.reshape(-1) * np.float32(omega)
    else:
        scale = plan.scale.reshape(-1).copy()

    atab = None
    if compliance is not None:
        c = np.maximum(np.asarray(compliance, np.float32), np.float32(0.0))
        atab = np.zeros((n,), np.float32)
        atab[live] = c[perm[live]]

    return GpuPlan(
        arity=a, num_blocks=nb, width=width, scheme=scheme, verts=verts,
        rest=np.ascontiguousarray(plan.rest.reshape(-1), np.float32),
        scale=np.ascontiguousarray(scale, np.float32),
        counts=counts, atab=atab,
        blk_vptr=blk_vptr.astype(np.int32),
        cvert=v[order][seg_start].astype(np.int32),
        cptr=cptr.astype(np.int32),
        centry=((p_idx % width) * 4 + r_idx)[order].astype(np.int32),
        pos_of=plan.pos_of.copy())


# --------------------------------------------------------------------------
# The dependency schedule and the staged tables of the CUDA sweep kernels
# --------------------------------------------------------------------------

# The list schedule's cost of handing a dependency from one CTA to another,
# in blocks (a release, a poll and an L2 round trip, against a block's own
# chain of a few such trips).
HANDOFF = 0.5
# ints in the header of a block's staged record: block, rows, entries,
# waits, release, three pad
REC_HEADER = 8


def _pad4(n):
    return -(-n // 4) * 4


def block_preds(plan: GpuPlan) -> Tuple[np.ndarray, np.ndarray]:
    """(pptr, pred): the predecessors of block b are pred[pptr[b]:pptr[b+1]]
    -- for each of its vertices the last earlier block that touches it --
    unique and ascending.  Blocks that share no vertex commute exactly, so
    running b after its predecessors gives it the inputs of plan order."""
    nb = plan.num_blocks
    blk = np.repeat(np.arange(nb, dtype=np.int64), np.diff(plan.blk_vptr))
    v = plan.cvert.astype(np.int64)
    o = np.lexsort((blk, v))          # by vertex, then block
    vs, bs = v[o], blk[o]
    same = vs[1:] == vs[:-1]
    key = np.unique(bs[1:][same] * nb + bs[:-1][same])
    succ, pred = key // nb, key % nb
    return np.searchsorted(succ, np.arange(nb + 1)), pred


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A plan's non-empty blocks on persistent CTAs ("queues"), each
    queue in plan order.

    qptr    : (G+1,) int32 -- queue q runs positions qptr[q]:qptr[q+1]
    qblk    : (n,) int32   -- position -> block id, each non-empty block once
    wptr    : (n+1,) int32 -- position i first waits for the blocks
    wait    : int32           wait[wptr[i]:wptr[i+1]], on other queues
    release : (NB,) bool   -- a block another queue waits for
    levels  : longest chain of dependent blocks
    length  : the list schedule's length in blocks (HANDOFF per hand-off)
    """

    qptr: np.ndarray
    qblk: np.ndarray
    wptr: np.ndarray
    wait: np.ndarray
    release: np.ndarray
    levels: int
    length: float

    @property
    def queues(self) -> int:
        return len(self.qptr) - 1


def build_schedule(plan: GpuPlan, queues: int) -> Schedule:
    """Greedy list schedule of the plan's blocks, taken in plan order, onto
    at most ``queues`` queues (unit time per block): a block starts on the
    queue where it can start first, preferring the queue of its latest
    predecessor (no hand-off), then a queue that is already free (best
    fit), then the queue that frees first.  Its waits are its predecessors
    on other queues that the queue does not already know complete (vector
    clocks over earlier waits), the latest per queue.  queues=1 is plan
    order with no waits."""
    if queues < 1:
        raise ValueError(f"queues must be >= 1, got {queues}")
    nb = plan.num_blocks
    pptr, pred = block_preds(plan)
    live = np.flatnonzero(np.diff(plan.blk_vptr) > 0)
    nq = min(int(queues), max(len(live), 1))
    free = np.zeros(nq)
    end = np.zeros(nb)
    level = np.zeros(nb, np.int64)
    qof = np.full(nb, -1, np.int64)
    lists = [[] for _ in range(nq)]
    for b in live.tolist():
        ps = pred[pptr[b]:pptr[b + 1]]
        best_q, best_s = -1, np.inf
        base = 0.0
        if len(ps):
            pe, pq = end[ps], qof[ps]
            level[b] = level[ps].max() + 1
            base = pe.max() + HANDOFF
            for q in dict.fromkeys(pq[np.argsort(-pe, kind="stable")]
                                   .tolist()):
                on = pq == q
                r = pe[on].max()
                if not on.all():
                    r = max(r, pe[~on].max() + HANDOFF)
                s = max(free[q], r)
                if s < best_s:
                    best_q, best_s = q, s
            f = free.copy()
            f[pq] = np.inf
        else:
            level[b] = 1
            f = free
        ok = f <= base
        if ok.any():
            q, s = int(np.argmax(np.where(ok, f, -1.0))), base
        else:
            q = int(np.argmin(f))
            s = f[q]
        if s < best_s:
            best_q, best_s = q, s
        qof[b] = best_q
        end[b] = free[best_q] = best_s + 1.0
        lists[best_q].append(b)

    lists = [lst for lst in lists if lst]
    g = len(lists)
    gid = np.full(nq, -1, np.int64)
    gid[[qof[lst[0]] for lst in lists]] = np.arange(g)
    qof = np.where(qof >= 0, gid[np.maximum(qof, 0)], -1)
    pos = np.zeros(nb, np.int64)
    for lst in lists:
        pos[lst] = np.arange(len(lst))
    known = np.full((g, g), -1, np.int64)
    vc_done = np.zeros((nb, g), np.int64)
    waits = {}
    release = np.zeros(nb, bool)
    for b in live.tolist():
        q = qof[b]
        vc = known[q].copy()
        ws = []
        for p in pred[pptr[b]:pptr[b + 1]][::-1].tolist():   # latest first
            qp = qof[p]
            if qp != q and pos[p] > vc[qp]:
                ws.append(p)
                np.maximum(vc, vc_done[p], out=vc)
                release[p] = True
        vc[q] = pos[b]
        vc_done[b] = known[q] = vc
        waits[b] = sorted(ws)

    qblk = np.array([b for lst in lists for b in lst], np.int64)
    nw = np.array([len(waits[b]) for b in qblk.tolist()], np.int64)
    wait = [w for b in qblk.tolist() for w in waits[b]]
    return Schedule(
        qptr=np.concatenate([[0], np.cumsum([len(lst) for lst in lists])])
        .astype(np.int32),
        qblk=qblk.astype(np.int32),
        wptr=np.concatenate([[0], np.cumsum(nw)]).astype(np.int32),
        wait=np.asarray(wait, np.int32),
        release=release,
        levels=int(level.max(initial=0)),
        length=float(end.max(initial=0.0)))


def local_rows(plan: GpuPlan) -> np.ndarray:
    """(NB*width, arity) int16 block-local CSR row of every live (lane,
    role), -1 on pad lanes: cvert[blk_vptr[b] + lrow[p, r]] == verts[p, r]
    for p in block b."""
    nb, width = plan.num_blocks, plan.width
    row_blk = np.repeat(np.arange(nb, dtype=np.int64), np.diff(plan.blk_vptr))
    ent_row = np.repeat(np.arange(len(plan.cvert), dtype=np.int64),
                        np.diff(plan.cptr))
    blk = row_blk[ent_row]
    lrow = np.full((nb * width, plan.arity), -1, np.int16)
    lrow[blk * width + (plan.centry >> 2), plan.centry & 3] = (
        ent_row - plan.blk_vptr[blk])
    return lrow


def stage_bounds(plan: GpuPlan) -> Tuple[int, int]:
    """(rows, record ints) of the plan's largest block: what one CTA stages
    in shared memory, whatever the schedule (a record lists at most all of
    its block's predecessors as waits)."""
    pptr, _ = block_preds(plan)
    rows = np.diff(plan.blk_vptr).astype(np.int64)
    ents = np.diff(plan.cptr[plan.blk_vptr]).astype(np.int64)
    rec = (REC_HEADER + _pad4(np.diff(pptr)) + _pad4(rows) + _pad4(rows + 1)
           + _pad4(ents))
    return int(rows.max(initial=0)), int(rec.max(initial=REC_HEADER))


@dataclasses.dataclass(frozen=True)
class StagedPlan:
    """What the CUDA sweep kernels read besides the per-lane tables.

    schedule: the Schedule
    lrow    : (NB*width, arity) int16 -- ``local_rows``
    rec     : (R,) int32 -- per queue position one record, 16-byte aligned
              (a multiple of 4 ints), each part padded to 4 ints: header
              (block, rows U, entries E, waits W, release, 0, 0, 0), the W
              wait block ids, the block's CSR rows (cvert), the rows' entry
              offsets from 0 to E (U+1), the entries (lane*4 + role)
    qinfo   : (n, 4) int32 -- per queue position: block, record offset and
              record length in ints, 0
    max_rows, max_rec: ``stage_bounds``
    """

    schedule: Schedule
    lrow: np.ndarray
    rec: np.ndarray
    qinfo: np.ndarray
    max_rows: int
    max_rec: int


def stage_plan(plan: GpuPlan, queues: int) -> StagedPlan:
    """The schedule on ``queues`` queues and the tables the kernels stage
    one block at a time (contiguous slices, for 1-D bulk copies)."""
    sched = build_schedule(plan, queues)
    parts, qinfo, off = [], [], 0
    vptr, cptr = plan.blk_vptr, plan.cptr
    for i, b in enumerate(sched.qblk.tolist()):
        u0, u1 = int(vptr[b]), int(vptr[b + 1])
        e0, e1 = int(cptr[u0]), int(cptr[u1])
        nu, ne = u1 - u0, e1 - e0
        w = sched.wait[sched.wptr[i]:sched.wptr[i + 1]]
        ow = REC_HEADER
        ov = ow + _pad4(len(w))
        orp = ov + _pad4(nu)
        oe = orp + _pad4(nu + 1)
        rec = np.zeros(oe + _pad4(ne), np.int32)
        rec[:5] = (b, nu, ne, len(w), int(sched.release[b]))
        rec[ow:ow + len(w)] = w
        rec[ov:ov + nu] = plan.cvert[u0:u1]
        rec[orp:orp + nu + 1] = cptr[u0:u1 + 1] - e0
        rec[oe:oe + ne] = plan.centry[e0:e1]
        parts.append(rec)
        qinfo.append((b, off, len(rec), 0))
        off += len(rec)
    max_rows, max_rec = stage_bounds(plan)
    return StagedPlan(
        schedule=sched, lrow=local_rows(plan),
        rec=(np.concatenate(parts) if parts else np.zeros(0, np.int32)),
        qinfo=np.asarray(qinfo, np.int32).reshape(-1, 4),
        max_rows=max_rows, max_rec=max_rec)
