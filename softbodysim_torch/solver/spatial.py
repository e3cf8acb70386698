"""Spatial-hash broad phase for self and inter-body particle collision.

The counterpart of ``softbodysim_tpu/solver/spatial.py`` (plain tensor ops,
on either device; the JAX package runs the stage as XLA ops, with no Pallas
kernel behind it):
  1. hash each particle's cell (floor(p / h)) into a power-of-two table with
     the 3-prime XOR hash;
  2. order the particles by hash (a STABLE sort: the order inside a bucket
     decides which candidates fall into the ``max_per_cell`` window);
  3. for each particle, its 27 neighbour cells' hashes, sorted per row with
     repeats dropped (identical hash => identical window); each gives a
     window of at most ``max_per_cell`` candidates located by
     ``searchsorted`` over the sorted hashes;
  4. sphere-sphere push-out per candidate pair, inverse-mass weighted,
     summed Jacobi-style and applied once.

Hash arithmetic: cells are int32, hashed in int64 and masked to the table's
low bits, which are the bits of the JAX package's wrapping int32 products.

Memory and summation order: the JAX function scans the 27 neighbour
offsets one at a time; here the offsets go in chunks of as many as keep the
(rows, offsets, max_per_cell) candidate tensors under ``CANDIDATE_BUDGET``
entries (all 27 at once up to ~150k rows at a cap of 8).  Each offset's
candidates are summed over the window, then the offsets are added left to
right in sorted-hash order, as the scan adds them; only the reduction
inside a window may differ from XLA's in fp32 rounding.

Copies (``copies`` > 1): the rows are that many equal-sized disjoint copies
of one scene (a batch stepped as one union) and each copy is hashed ALONE,
as the JAX package's vmapped step hashes each scene: the sort key carries
the copy index above the per-copy table bits, so each copy keeps its own
table size, buckets, windows and overflow, and no copy sees another.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_P1, _P2, _P3 = 73856093, 19349663, 83492791

_OFFSETS = np.array(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
     for dz in (-1, 0, 1)],
    np.int64,
)

# candidate entries (rows x offsets x window) materialized at once
CANDIDATE_BUDGET = 1 << 25


def _next_pow2(x: int) -> int:
    return 1 << max(1, int(np.ceil(np.log2(max(2, x)))))


def _cell_hash(cells, table_size: int):
    """Hash of int cells (..., 3) -> int64 in [0, table_size)."""
    c = cells.to(torch.int64)
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return h & (table_size - 1)


@functools.lru_cache(maxsize=None)
def device_scalar(value: float, device: torch.device) -> torch.Tensor:
    """``value`` as a float32 0-dim tensor on ``device``, made once (a
    stage's first run is eager, so a CUDA graph that captures it finds
    its constants made).  Dividing by it divides: dividing by a Python
    float may multiply by its float32 reciprocal on the card."""
    return torch.tensor(float(value), dtype=torch.float32, device=device)


def cells_of(p: torch.Tensor, cell_size: float) -> torch.Tensor:
    """floor(p / cell_size) as int32 (float32 division, as the JAX code)."""
    return torch.floor(p / device_scalar(float(cell_size), p.device)).to(
        torch.int32)


@functools.lru_cache(maxsize=None)
def _offsets(device: torch.device) -> torch.Tensor:
    """The (27, 3) offsets on ``device``, copied there once."""
    return torch.as_tensor(_OFFSETS).to(device)


def neighbour_windows(cells_q, copy_q, sorted_key, table_size: int):
    """For query cells (Nq, 3) of copies ``copy_q`` (Nq,) (or None): the
    27 neighbour hashes sorted per row, their repeats, and each one's
    window [start, end) in ``sorted_key``."""
    nh = _cell_hash(cells_q[:, None, :].to(torch.int64)
                    + _offsets(cells_q.device)[None], table_size)
    nh = torch.sort(nh, dim=1).values
    dup = torch.cat([torch.zeros_like(nh[:, :1], dtype=torch.bool),
                     nh[:, 1:] == nh[:, :-1]], 1)
    key = nh if copy_q is None else nh + copy_q[:, None] * table_size
    key = key.contiguous()
    start = torch.searchsorted(sorted_key, key, side="left")
    end = torch.searchsorted(sorted_key, key, side="right")
    return start, end, dup


def dropped(start, end, dup, max_per_cell: int) -> torch.Tensor:
    """Candidate entries that did not fit the window (int32 scalar)."""
    over = (end - start - max_per_cell).clamp_min(0)
    return torch.where(dup, 0, over).sum().to(torch.int32)


def offset_chunks(rows: int, max_per_cell: int) -> list:
    """[(first, last)) chunks of the 27 offsets under the budget."""
    per = max(1, min(27, CANDIDATE_BUDGET // max(1, rows * max_per_cell)))
    return [(a, min(27, a + per)) for a in range(0, 27, per)]


def _query_rows(n: int, own_offset, own_count, device):
    """The query rows' ids: all rows, or the own slice."""
    if own_offset is None:
        return torch.arange(n, device=device)
    return (torch.as_tensor(own_offset, dtype=torch.int64, device=device)
            + torch.arange(int(own_count), device=device))


def self_collision_deltas(p, inv_mass, radius, cell_size, max_per_cell,
                          return_overflow: bool = False,
                          own_offset=None, own_count: int = None,
                          copies: int = 1):
    """Per-particle separation deltas (Nq, 3) from particle-particle
    overlap; the caller applies them.

    ``return_overflow=True`` also returns the candidate entries that did
    not fit the ``max_per_cell`` window (an int32 device scalar).
    Own-slice mode (``own_offset`` / ``own_count``): the table covers all
    of ``p``, only rows [own_offset, own_offset + own_count) are queried.
    ``copies``: the rows are that many disjoint copies, each hashed alone
    (module docstring)."""
    n = p.shape[0]
    if copies < 1 or n % copies:
        raise ValueError(f"{n} rows are not {copies} equal copies")
    per_copy = n // copies
    table_size = _next_pow2(2 * per_copy)
    dev = p.device

    cells = cells_of(p, cell_size)
    key = _cell_hash(cells, table_size)
    copy_of = None
    if copies > 1:
        copy_of = torch.arange(n, device=dev) // per_copy
        key = key + copy_of * table_size
    order = torch.argsort(key, stable=True)
    sorted_key = key[order].contiguous()

    own = _query_rows(n, own_offset, own_count, dev)
    pq, wq, cq = p[own], inv_mass[own], cells[own]
    start, end, dup = neighbour_windows(
        cq, None if copy_of is None else copy_of[own], sorted_key,
        table_size)

    m = int(max_per_cell)
    slot = torch.arange(m, device=dev)
    min_dist = 2.0 * float(radius)
    min2 = min_dist * min_dist
    deltas = torch.zeros_like(pq)
    for a, b in offset_chunks(len(own), m):
        cand_pos = start[:, a:b, None] + slot                 # (Nq, k, M)
        valid = (cand_pos < end[:, a:b, None]) & ~dup[:, a:b, None]
        cand = order[cand_pos.clamp(0, n - 1)]
        d = pq[:, None, None, :] - p[cand]
        dist2 = (d * d).sum(-1)
        hit = valid & (cand != own[:, None, None]) & (dist2 < min2) \
            & (dist2 > 1e-18)
        dist = torch.sqrt(dist2.clamp_min(1e-18))
        nvec = d / dist[..., None]
        wi = wq[:, None, None]
        wsum = wi + inv_mass[cand]
        share = torch.where(
            wsum > 0.0, wi / torch.where(wsum == 0.0, 1.0, wsum), 0.0)
        overlap = (min_dist - dist) * share
        push = (nvec * torch.where(hit, overlap, 0.0)[..., None]).sum(2)
        for k in range(b - a):                 # the scan's order
            deltas = deltas + push[:, k]
    if not return_overflow:
        return deltas
    return deltas, dropped(start, end, dup, m)


def required_max_per_cell(p, cell_size, num_particles: int = None) -> int:
    """Host-side capacity autosizer: the largest hash-bucket occupancy of
    these positions (hash collisions included), the smallest
    ``max_per_cell`` that drops no candidate."""
    p = np.asarray(p)
    table_size = _next_pow2(2 * (num_particles or len(p)))
    cells = np.floor(p / float(cell_size)).astype(np.int64)
    h = ((cells[:, 0] * _P1) ^ (cells[:, 1] * _P2)
         ^ (cells[:, 2] * _P3)) & (table_size - 1)
    if len(h) == 0:
        return 1
    return int(np.bincount(h).max())


def park_offsets(dead, cell_size, radius, thickness=0.0):
    """(N,) bool dead-row mask -> (N, 3) f32 offset table parking each dead
    row in its own far-away hash cell (> one cell AND > 2*radius AND
    > thickness apart), zeros for live rows."""
    dead = np.asarray(dead, bool)
    n = len(dead)
    spacing = 2.0 * max(cell_size, 2.0 * radius, thickness)
    off = np.zeros((n, 3), np.float32)
    off[:, 0] = np.where(
        dead, np.float32(1e6) * cell_size + np.arange(n) * spacing, 0.0)
    return off


class SelfCollision:
    """``fn(p_world, inv_mass, radius) -> positions`` with the static
    parameters bound (the cell, the cap, the copies).  Rows with w == 0
    are returned unchanged."""

    def __init__(self, cell: float, max_per_cell: int, copies: int = 1):
        self.cell = float(cell)
        self.max_per_cell = int(max_per_cell)
        self.copies = int(copies)

    def deltas(self, pw, inv_mass, radius, return_overflow=False):
        return self_collision_deltas(pw, inv_mass, radius, self.cell,
                                     self.max_per_cell, return_overflow,
                                     copies=self.copies)

    def __call__(self, pw, inv_mass, radius):
        delta = self.deltas(pw, inv_mass, radius)
        return torch.where((inv_mass > 0.0)[:, None], pw + delta, pw)


def make_self_collision_fn(params, rest=None, num_particles=None, *,
                           copies: int = 1) -> SelfCollision:
    """Bind static parameters (``softbodysim_tpu``'s function of the same
    name); returns fn(p_world, inv_mass, radius) with ``fn.max_per_cell``.

    A cap of 0 (``self_collision_max_per_cell=0``) autosizes at build
    time: 2x the largest hash-bucket occupancy of ``rest``, floor 8.
    ``rest`` is in the layout the stage runs on and ``num_particles`` its
    row count when it is not ``len(rest)`` (the sweep layout's padded
    rows).  With ``copies``, each copy is autosized alone on its share of
    the rows, and the cap is the largest."""
    cell = float(params.self_collision_cell)
    cap = int(params.self_collision_max_per_cell)
    if cap <= 0:
        if rest is None:
            raise ValueError(
                "self_collision_max_per_cell=0 (autosize) needs rest "
                "positions at build time; this path does not provide them "
                "-- set an explicit capacity")
        rest = np.asarray(rest)
        per = len(rest) // copies
        rows = None if num_particles is None else num_particles // copies
        need = max(required_max_per_cell(rest[c * per:(c + 1) * per], cell,
                                         rows) for c in range(copies))
        cap = max(8, 2 * need)
    return SelfCollision(cell, cap, copies)
