"""Vertex sharding: one scene's STATE split across the ranks of a mesh
axis, each rank owning a contiguous block of vertex rows.

The counterpart of ``softbodysim_tpu/parallel/sharding.py::
make_vertex_sharded_step`` (:544-958) and ``make_xpbd_vertex_sharded_step``
(:962-1405): the scale-out mode for a scene that does not fit one card.
Rank r owns rows [r vb, (r + 1) vb) of the vertex table padded to vpad =
vb D; pad rows have inverse mass 0 (pinned: they never move) and are
parked far away for the contact stages (``solver/global_stages.py``'s iso
table).  A rank holds its own rows, and per exchange a strip of GHOST rows
(non-owned vertices its constraints read): per-rank memory scales as 1/D
plus the halo.

* Jacobi (``VertexShardedStep``): each rank gathers its own rows'
  constraints (the padded per-vertex rows of the gather backend, the tets
  its rows touch), reading ghosts, and applies on its own rows; the
  gather only reads neighbours, so no delta goes back.  ``halo``:
  "neighbor" (``Axis.exchange``: a strip to each +-1 rank) when every ghost
  lives on the neighbouring blocks (a banded vertex order: grid, RCM),
  else "general" (an all-gather of each rank's exported rows); "auto"
  picks, "off" all-gathers every row each sweep.  The fetched values are
  the same in every mode, so are the trajectories, bit for bit.
  ``comm_bytes_per_sweep`` / ``comm_bytes_full_gather`` are the JAX
  step's.
* XPBD (``XpbdVertexShardedStep``): coloured Gauss-Seidel, each constraint
  owned by the rank of its first vertex.  Per colour: fetch the ghost
  rows, project the rank's share of the colour on its own + ghost rows,
  send each ghost's position delta home (a colour's constraints share no
  vertex across ALL ranks, so each vertex gets at most one contribution):
  the single-device coloured trajectory up to the rounding of the delta
  (``comm_bytes_per_color``).  Lambdas stay in public order at the step's
  boundary.

Ground and colliders (the collide kernel on the card, through
``kernels/collide.py::collide_positions``) act on a rank's own rows; the
contact stages all-gather the rows and evaluate the rank's own slice.

The jacobi step differentiates as built: a replicated input (the public
state, the stiffness) enters a rank's rows through ``Axis.varying``, every
exchange carries its gradient (``parallel/collectives.py``).  The xpbd
step raises when handed a tensor that requires grad (``diff.py``
differentiates the xpbd dialect through the single-device build).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..collide.primitives import Colliders
from ..core.state import SimState, SolverParams, f32, init_state, \
    resolve_device
from ..kernels import collide as kc
from ..kernels.jacobi import apply_delta
from ..solver.accel import chebyshev_loop
from ..solver.global_stages import build_sliced_stages
from ..solver.jacobi import edge_gather_deltas, tet_phase_a, tet_phase_b
from ..solver.select import refuse_grad
from ..solver.xpbd import (_colour_slices, commit, edge_dlambda, predict,
                           project_ground, step_terms, tet_dlambda)
from .collectives import Axis


def _localize(v: np.ndarray, d: int, vb: int, ghosts: np.ndarray):
    """Global vertex ids -> rank d's local rows: own rows first, then its
    ghosts in sorted order."""
    v = np.asarray(v, np.int64)
    own = (v >= d * vb) & (v < (d + 1) * vb)
    gi = np.searchsorted(ghosts, np.where(own, 0, v))
    return np.where(own, v - d * vb, vb + gi)


def _padded(rows, width: int, fill=0) -> np.ndarray:
    rows = np.asarray(rows)
    out = np.full((width,) + rows.shape[1:], fill,
                  np.int64 if rows.dtype.kind in "iu" else rows.dtype)
    out[:len(rows)] = rows
    return out


def _owned(g: np.ndarray, d: int, vb: int) -> np.ndarray:
    return g[(g >= d * vb) & (g < (d + 1) * vb)]


def _neighbour_strips(ghosts, npd: int, vb: int):
    """The +-1 exchange: per rank the own rows rank d + 1 / d - 1 reads
    (send_up / send_dn), padded to one width each."""
    none = np.zeros((0,), np.int64)
    up = [_owned(ghosts[d + 1], d, vb) if d + 1 < npd else none
          for d in range(npd)]
    dn = [_owned(ghosts[d - 1], d, vb) if d >= 1 else none
          for d in range(npd)]
    su = max(1, max(len(u) for u in up))
    sd = max(1, max(len(u) for u in dn))
    return up, dn, su, sd


def _neighbour_fetch(ghosts, up, dn, r: int, vb: int):
    """Rank r's ghost slots -> (from the rank below?, slot in its strip)."""
    g = ghosts[r]
    below = np.minimum(g // vb, len(ghosts) - 1) == r - 1
    slot = np.where(
        below, np.searchsorted(up[r - 1] if r >= 1 else g[:0], g),
        np.searchsorted(dn[r + 1] if r + 1 < len(ghosts) else g[:0], g))
    return below, slot


def _exports(ghosts, npd: int, vb: int):
    """Per rank the own rows any other rank reads, and the padded
    width."""
    out = []
    for d in range(npd):
        need = [_owned(g, d, vb) for dd, g in enumerate(ghosts) if dd != d]
        out.append(np.unique(np.concatenate(need)) if need
                   else np.zeros((0,), np.int64))
    return out, max(1, max(len(x) for x in out))


def _ghost_src(ghosts, exports, hexp: int, r: int, vb: int):
    """Rank r's ghosts -> rows of the gathered (D * hexp) export strips."""
    g = ghosts[r]
    o = np.minimum(g // vb, len(ghosts) - 1)
    src = np.zeros(len(g), np.int64)
    for d in np.unique(o):
        sel = o == d
        src[sel] = d * hexp + np.searchsorted(exports[d], g[sel])
    return src


class _Rows:
    """What both vertex-sharded steps share: the axis, the block of rows,
    public <-> own rows, the contact stages in own-slice form."""

    def __init__(self, topology, params: SolverParams, mesh, axis: str,
                 colliders: Optional[Colliders], device):
        ax = self.axis = Axis(mesh, axis)
        self.topology, self.params = topology, params
        dev = self.device = resolve_device(device)
        self.colliders = None if colliders is None else colliders.to(dev)
        npd = self.npd = ax.size
        nv = self.nv = topology.num_particles
        vb = self.vb = -(-nv // npd)
        self.vpad = vb * npd
        self.lo = ax.index * vb
        self._gravity = torch.tensor(params.gravity, dtype=torch.float32,
                                     device=dev)
        rest = np.zeros((self.vpad, 3), np.float32)
        rest[:nv] = np.asarray(topology.vertices, np.float32)
        dead = np.zeros((self.vpad,), bool)
        dead[nv:] = True
        self._self_fn, self._surf_fn, iso = build_sliced_stages(
            topology, params, rest_rows=rest, dead=dead, device=dev)
        self._iso = torch.as_tensor(iso).to(dev)

    @property
    def has_stage(self) -> bool:
        return self._self_fn is not None or self._surf_fn is not None

    def t(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    def own(self, a: torch.Tensor) -> torch.Tensor:
        """A public per-vertex table (V, ...), the same on every rank ->
        this rank's rows (vb, ...), pad rows 0."""
        a = self.axis.varying(a.to(self.device))
        mine = a[self.lo:min(self.lo + self.vb, self.nv)]
        pad = self.vb - mine.shape[0]
        if pad:
            mine = torch.cat([mine, mine.new_zeros((pad,) + a.shape[1:])])
        return mine

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """Every rank's rows -> the public table (V, ...), the same on
        every rank."""
        return self.axis.all_gather(rows, tiled=True)[:self.nv]

    def w_full(self, w_own: torch.Tensor) -> Optional[torch.Tensor]:
        return self.axis.varying(self.axis.all_gather(w_own, tiled=True))

    def contact(self, x, w_full, free):
        """Self, then surface collision on this rank's rows, each over the
        gathered (parked) table."""
        ax, vb = self.axis, self.vb
        off = ax.index * vb
        radius = max(1e-6, self.params.particle_radius)
        if self._self_fn is not None:
            p = ax.varying(ax.all_gather(x, tiled=True)) + self._iso
            d = self._self_fn(p, w_full, radius, off, vb)
            x = torch.where(free, x + d, x)
        if self._surf_fn is not None:
            p = ax.varying(ax.all_gather(x, tiled=True)) + self._iso
            vd, corners = self._surf_fn(p, w_full, off, vb)
            cd = ax.varying(ax.psum(corners))[off:off + vb]
            x = torch.where(free, x + (vd + cd), x)
        return x

    def packed(self, colliders_rt):
        cols = kc.runtime_colliders(self.colliders, colliders_rt,
                                    self.device)
        return kc.pack_colliders(cols, self.device)


# --------------------------------------------------------------------------
# Jacobi
# --------------------------------------------------------------------------

class VertexShardedStep(_Rows):
    """``step((x, v, w), dt, edge_stiffness=None, volume_stiffness=None,
    sor_omega=None, colliders_rt=None) -> (x, v, w)`` on this rank's own
    rows (each (vb, ...)), the jacobi dialect (module docstring).
    ``build_state(...)`` gives this rank's rows of ``init_state``,
    ``unpad(rows)`` the public table (gathered, on the host); ``vpad``,
    ``halo_mode``, ``comm_bytes_per_sweep`` and ``comm_bytes_full_gather``
    are the JAX step's."""

    backend = "gather"

    def __init__(self, topology, params: SolverParams, mesh,
                 axis: str = "model", colliders: Optional[Colliders] = None,
                 halo: str = "auto", *, device=None):
        from ..core.adjacency import (padded_edge_adjacency,
                                      padded_tet_adjacency)

        if params.dialect != "jacobi":
            raise ValueError("make_vertex_sharded_step implements the jacobi "
                             "dialect (make_xpbd_vertex_sharded_step: xpbd)")
        if halo not in ("auto", "general", "off"):
            raise ValueError(f"halo must be auto|general|off, got {halo!r}")
        super().__init__(topology, params, mesh, axis, colliders, device)
        npd, nv, vb, r = self.npd, self.nv, self.vb, self.axis.index
        self.has_edges = topology.num_edges > 0
        self.has_tets = topology.num_tets > 0
        tets = np.asarray(topology.tets, np.int64).reshape(-1, 4)

        def padv(a, fill=0):
            out = np.full((self.vpad,) + a.shape[1:], fill, a.dtype)
            out[:nv] = a
            return out

        e_other, e_eidx, e_mask = padded_edge_adjacency(nv, topology.edges)
        e_rest = padv(np.asarray(topology.edge_rest, np.float32)[e_eidx]
                      if self.has_edges else np.zeros(e_other.shape,
                                                      np.float32))
        e_other = padv(e_other.astype(np.int64))
        e_mask = padv(e_mask, False)
        t_tidx, t_role, t_mask = (padv(a, f) for a, f in zip(
            padded_tet_adjacency(nv, tets), (0, 0, False)))
        rows = [slice(d * vb, (d + 1) * vb) for d in range(npd)]
        # per rank, the tets its rows touch
        local = [np.unique(t_tidx[s][t_mask[s]]) if self.has_tets
                 else np.zeros((0,), np.int64) for s in rows]

        self.halo_on = halo != "off" and npd > 1
        neighbor = False
        self.comm_bytes_per_sweep = self.vpad * 3 * 4
        self.comm_bytes_full_gather = self.vpad * 3 * 4
        mine = rows[r]
        ltets = tets[local[r]]
        if self.halo_on:
            ghosts = []
            for d, s in enumerate(rows):
                u = np.unique(np.concatenate(
                    [e_other[s][e_mask[s]], tets[local[d]].ravel()]))
                ghosts.append(u[(u < d * vb) | (u >= (d + 1) * vb)])
            h = max(1, max(len(g) for g in ghosts))
            eo = np.where(e_mask[mine],
                          _localize(e_other[mine], r, vb, ghosts[r]), 0)
            ltets = _localize(ltets, r, vb, ghosts[r])
            self._ghost_gid = self.t(_padded(ghosts[r], h))
            neighbor = halo != "general" and all(
                np.isin(np.minimum(g // vb, npd - 1), (d - 1, d + 1)).all()
                for d, g in enumerate(ghosts))
            if neighbor:
                up, dn, su, sd = _neighbour_strips(ghosts, npd, vb)
                below, slot = _neighbour_fetch(ghosts, up, dn, r, vb)
                self._send_up = self.t(_padded(up[r] - r * vb, su))
                self._send_dn = self.t(_padded(dn[r] - r * vb, sd))
                self._below = self.t(_padded(below, h, False), torch.bool)
                self._slot_up = self.t(np.minimum(_padded(slot, h), su - 1))
                self._slot_dn = self.t(np.minimum(_padded(slot, h), sd - 1))
                self.comm_bytes_per_sweep = int((su + sd) * 3 * 4)
            else:
                exports, hexp = _exports(ghosts, npd, vb)
                self._exp = self.t(_padded(exports[r] - r * vb, hexp))
                self._gsrc = self.t(_padded(
                    _ghost_src(ghosts, exports, hexp, r, vb), h))
                self.comm_bytes_per_sweep = int(npd * hexp * 3 * 4)
        else:
            eo = e_other[mine]
        self.neighbor = neighbor
        self.halo_mode = ("neighbor" if neighbor
                          else "general" if self.halo_on else "off")
        # the own rows in the single-device gather step's degree buckets
        # (the same caps, so each row sums its neighbours as that step
        # does); vids: their rows in the table _ext returns
        off = 0 if self.halo_on else self.lo
        self._e_rows = self._buckets(e_mask, mine, nv, [
            (eo, torch.int64), (e_rest[mine], torch.float32),
            (e_mask[mine], torch.bool)], off)
        if self.has_tets:
            # this rank's tets (one degenerate tet when it has none), and
            # its rows' slots into their role-major gradient table
            td = max(1, len(local[r]))
            remap = np.zeros(max(1, topology.num_tets), np.int64)
            remap[local[r]] = np.arange(len(local[r]))
            self._tl = self.t(_padded(ltets, td))
            self._tr = self.t(_padded(np.asarray(topology.tet_rest_vol,
                                                 np.float32)[local[r]], td),
                              torch.float32)
            tidx = remap[t_tidx[mine]]
            self._t_rows = self._buckets(t_mask, mine, nv, [
                (t_role[mine].astype(np.int64) * td + tidx, torch.int64),
                (tidx, torch.int64), (t_mask[mine], torch.bool)], 0)
        self.ground = kc.make_ground(params)
        self.do_collide = params.ground_enabled or (
            colliders is not None and colliders.count > 0)

    def _buckets(self, mask, mine, nv, tables, off):
        """(per degree bucket (row ids + off, each table's rows cut to the
        bucket's cap), the rows' positions in bucket order)."""
        from ..core.adjacency import bucket_vertices, degree_buckets

        caps = degree_buckets(mask[:nv].sum(1))
        buckets, pos = bucket_vertices(mask[mine].sum(1), caps)
        rows = [(self.t(ids + off), *(self.t(a[ids, :cap], dt)
                                      for a, dt in tables))
                for cap, ids in zip(caps, buckets) if len(ids)]
        return rows, self.t(pos)

    def _ext(self, x):
        """This rank's rows and its ghost rows (own first), or every row
        when the halo is off."""
        ax = self.axis
        if not self.halo_on:
            return ax.varying(ax.all_gather(x, tiled=True))
        if self.neighbor:
            up, dn = ax.exchange(x[self._send_up], x[self._send_dn])
            ghost = torch.where(self._below[:, None], up[self._slot_up],
                                dn[self._slot_dn])
        else:
            gath = ax.varying(ax.all_gather(x[self._exp]))
            ghost = gath.reshape(-1, 3)[self._gsrc]
        return torch.cat([x, ghost])

    def build_state(self, pinned=None, inv_mass_mode: str = "density",
                    density: float = 1.0):
        """This rank's rows of ``init_state``: (x, v, w)."""
        st = init_state(self.topology, pinned=pinned,
                        inv_mass_mode=inv_mass_mode, density=density,
                        device=self.device)
        return self.own(st.x), self.own(st.v), self.own(st.inv_mass)

    def unpad(self, rows: torch.Tensor) -> np.ndarray:
        """Every rank's rows -> the public (V, ...) table on the host."""
        return self.gather(rows).detach().cpu().numpy()

    def __call__(self, xvw, dt, edge_stiffness=None, volume_stiffness=None,
                 sor_omega=None, colliders_rt: Optional[Colliders] = None):
        p, ax = self.params, self.axis
        x, v, w = xvw

        def scalar(override, default):
            if isinstance(override, torch.Tensor):
                return ax.varying(override.to(self.device, torch.float32))
            return f32(default if override is None else override)

        k_edge = scalar(edge_stiffness, p.edge_stiffness)
        k_vol = scalar(volume_stiffness, p.volume_stiffness)
        omega = scalar(sor_omega, p.sor_omega)
        packed = self.packed(colliders_rt)
        w_full = self.w_full(w)
        w_ext = (w_full if not self.halo_on
                 else torch.cat([w, w_full[self._ghost_gid]]))
        free = (w != 0.0)[:, None]

        def bucketed(rows, fn):
            parts = [fn(*b) for b in rows[0]]
            return (torch.cat([q[0] for q in parts])[rows[1]],
                    torch.cat([q[1] for q in parts])[rows[1]])

        def iteration(x):
            if self.has_edges:
                ext = self._ext(x)
                x = apply_delta(x, w, *bucketed(
                    self._e_rows, lambda ids, o, r, m: edge_gather_deltas(
                        ext, w_ext, o, r, m, k_edge, vids=ids)), omega)
            if self.has_tets:
                glam, valid = tet_phase_a(self._ext(x), w_ext, self._tl,
                                          self._tr, k_vol)
                x = apply_delta(x, w, *bucketed(
                    self._t_rows, lambda ids, sl, ti, m: tet_phase_b(
                        glam, valid, w, sl, ti, m, vids=ids)), omega)
            if self.do_collide:
                x = kc.collide_positions(x, w, packed, self.ground)
            if self.has_stage:
                x = self.contact(x, w_full, free)
            return x

        ss = max(1, p.substeps)
        sdt = np.float32(dt) / np.float32(ss)
        inv_dt = float(np.float32(1.0) / sdt) if sdt > 0 else 0.0
        sdt = float(sdt)
        pinned = ~free
        for _ in range(ss):
            v = torch.where(pinned, 0.0, v + self._gravity * sdt)
            x_pred = torch.where(pinned, x, x + v * sdt)
            x_pred = chebyshev_loop(iteration, x_pred, p)
            v = torch.where(pinned, 0.0, (x_pred - x) * inv_dt)
            x = torch.where(pinned, x, x_pred)
        return x, v, w


class PublicVertexStep:
    """``VertexShardedStep`` over the public SimState (the JAX dispatch's
    pad / unpad, :1477-1497), with ``Engine``'s carry API: the carry is
    the rank's own rows (x, v, w); the public state, the same on every
    rank, is gathered on access."""

    def __init__(self, inner: VertexShardedStep):
        self.inner = inner
        self.backend = inner.backend
        self.axis = inner.axis

    def pack_state(self, state: SimState):
        own = self.inner.own
        return own(state.x), own(state.v), own(state.inv_mass)

    def run_carry(self, carry, dt, n: int, **overrides):
        for _ in range(int(n)):
            carry = self.inner(carry, dt, **overrides)
        return carry

    def unpack_state(self, carry, state: SimState) -> SimState:
        x, v = self.inner.gather(carry[0]), self.inner.gather(carry[1])
        return SimState(x=x, v=v, x_star=x, inv_mass=state.inv_mass,
                        edge_lambda=state.edge_lambda,
                        tet_lambda=state.tet_lambda)

    def carry_positions(self, carry) -> torch.Tensor:
        return self.inner.gather(carry[0])

    def __call__(self, state: SimState, dt, **overrides) -> SimState:
        return self.step_n(state, dt, 1, **overrides)

    def step_n(self, state: SimState, dt, n: int, **overrides) -> SimState:
        return self.unpack_state(
            self.run_carry(self.pack_state(state), dt, n, **overrides),
            state)


# --------------------------------------------------------------------------
# XPBD
# --------------------------------------------------------------------------

class XpbdCarry(NamedTuple):
    """A rank's run state: its own rows (committed positions, velocities,
    inverse masses), its ghosts' inverse masses, its lambdas (the
    device-chunked colour-major layout) and, with contact stages, every
    row's inverse mass."""

    x: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    w_ghost: torch.Tensor
    lam_e: Optional[torch.Tensor]
    lam_t: Optional[torch.Tensor]
    w_full: Optional[torch.Tensor]


class _XFamily:
    """One family's constraints owned by this rank (by their first vertex),
    per colour in local row ids (own, ghost, then the dummy row) padded to
    the colour's largest share; the public <-> internal lambda maps over
    every rank's shares."""

    def __init__(self, cons, rest, groups, arity, ghosts, r, vb, h, npd,
                 t):
        order, slices = _colour_slices(groups)
        cons_cm = np.asarray(cons, np.int64).reshape(-1, arity)[order]
        rest_cm = np.asarray(rest, np.float32)[order]
        dev_of = np.minimum(cons_cm[:, 0] // vb, npd - 1)
        dummy = vb + h
        perm = [[] for _ in range(npd)]
        self.colours = []
        pos = 0
        for s, e in slices:
            ids = np.arange(s, e)
            chunks = [ids[dev_of[s:e] == d] for d in range(npd)]
            lc = max(1, max(len(c) for c in chunks))
            sel = chunks[r]
            cc = np.full((lc, arity), dummy, np.int64)
            cc[:len(sel)] = _localize(cons_cm[sel], r, vb, ghosts[r])
            rr = np.zeros((lc,), np.float32)
            rr[:len(sel)] = rest_cm[sel]
            for d in range(npd):
                perm[d].extend(order[chunks[d]].tolist()
                               + [-1] * (lc - len(chunks[d])))
            ct = t(cc)
            self.colours.append((pos, pos + lc,
                                 [ct[:, q].contiguous()
                                  for q in range(arity)],
                                 t(rr, torch.float32)))
            pos += lc
        self.local = pos
        flat = np.asarray(perm, np.int64).reshape(-1)
        valid = flat >= 0
        pos_of = np.zeros((len(cons_cm),), np.int64)
        pos_of[flat[valid]] = np.flatnonzero(valid)
        mine = np.asarray(perm[r], np.int64)
        self.perm, self.mask = t(np.maximum(mine, 0)), t(mine >= 0,
                                                          torch.bool)
        self.pos_of = t(pos_of)


class XpbdVertexShardedStep(_Rows):
    """``step(state, dt, colliders_rt=None) -> state`` over the public
    SimState (the same on every rank; lambdas in public order), the xpbd
    dialect with the state split by vertex (module docstring), and
    ``Engine``'s carry API (``pack_state`` / ``run_carry`` /
    ``unpack_state`` / ``carry_positions``): between steps each rank keeps
    its own rows.  ``comm_bytes_per_color`` (per rank) and
    ``full_gather_bytes`` are the JAX step's; ``halo_mode`` 'neighbor' or
    'general'."""

    backend = "gather"

    def __init__(self, topology, params: SolverParams, mesh,
                 axis: str = "model", colliders: Optional[Colliders] = None,
                 *, device=None):
        if params.dialect != "xpbd":
            raise ValueError("make_xpbd_vertex_sharded_step implements the "
                             "xpbd dialect (make_vertex_sharded_step: "
                             "jacobi)")
        super().__init__(topology, params, mesh, axis, colliders, device)
        npd, vb, r = self.npd, self.vb, self.axis.index
        fams = [(name, np.asarray(cons, np.int64).reshape(-1, arity), rest,
                 groups, arity)
                for name, cons, rest, groups, arity in (
                    ("edges", topology.edges, topology.edge_rest,
                     topology.edge_colors, 2),
                    ("tets", topology.tets, topology.tet_rest_vol,
                     topology.tet_colors, 4)) if len(cons)]
        # each rank's ghosts: the non-owned vertices its constraints read
        refs = [[np.zeros((0,), np.int64)] for _ in range(npd)]
        for _, cons, _, _, _ in fams:
            dev_of = np.minimum(cons[:, 0] // vb, npd - 1)
            for d in range(npd):
                u = np.unique(cons[dev_of == d])
                refs[d].append(u[(u < d * vb) | (u >= (d + 1) * vb)])
        ghosts = [np.unique(np.concatenate(g)) for g in refs]
        h = self.h = max(1, max(len(g) for g in ghosts))
        self.fams = {name: _XFamily(cons, rest, groups, arity, ghosts, r,
                                    vb, h, npd, self.t)
                     for name, cons, rest, groups, arity in fams}
        self._ghost_gid = self.t(_padded(ghosts[r], h))

        owner = [np.minimum(g // vb, npd - 1) for g in ghosts]
        self.neighbor = all(np.isin(o, (d - 1, d + 1)).all()
                            for d, o in enumerate(owner))
        self.halo_mode = "neighbor" if self.neighbor else "general"
        self.full_gather_bytes = int(self.vpad * 3 * 4)
        if self.neighbor:
            up, dn, su, sd = _neighbour_strips(ghosts, npd, vb)
            below, slot = _neighbour_fetch(ghosts, up, dn, r, vb)
            self._send_up = self.t(_padded(up[r] - r * vb, su))
            self._send_dn = self.t(_padded(dn[r] - r * vb, sd))
            self._below = self.t(_padded(below, h, False), torch.bool)
            self._slot_up = self.t(np.minimum(_padded(slot, h), su - 1))
            self._slot_dn = self.t(np.minimum(_padded(slot, h), sd - 1))
            # the deltas going home, in the receiver's strip order; pads
            # read the zero row h
            g = ghosts[r]
            self._ret_dn = self.t(_padded(np.searchsorted(
                g, up[r - 1] if r >= 1 else g[:0]), su, h))
            self._ret_up = self.t(_padded(np.searchsorted(
                g, dn[r + 1] if r + 1 < npd else g[:0]), sd, h))
            self.comm_bytes_per_color = int((su + sd) * 2 * 3 * 4)
        else:
            exports, hexp = _exports(ghosts, npd, vb)
            self._exp = self.t(_padded(exports[r] - r * vb, hexp))
            self._gsrc = self.t(_padded(
                _ghost_src(ghosts, exports, hexp, r, vb), h))
            # the ghost deltas addressed to my rows in the gathered
            # (D * h) strips; pads land on the dump row vb
            src, dst = [], []
            for d in range(npd):
                sel = owner[d] == r
                src.append(d * h + np.flatnonzero(sel))
                dst.append(ghosts[d][sel] - r * vb)
            src, dst = np.concatenate(src), np.concatenate(dst)
            every = np.concatenate(owner)
            rmax = max(1, max(int((every == q).sum()) for q in range(npd)))
            self._rsrc = self.t(_padded(src, rmax))
            self._rdst = self.t(_padded(dst, rmax, vb))
            self.comm_bytes_per_color = int((npd * h + npd * hexp) * 3 * 4)

    # ---- the halo exchange ------------------------------------------------

    def _fetch(self, x):
        """Owners export boundary rows; this rank's ghost rows refresh."""
        ax = self.axis
        if self.neighbor:
            up, dn = ax.exchange(x[self._send_up], x[self._send_dn])
            return torch.where(self._below[:, None], up[self._slot_up],
                               dn[self._slot_dn])
        gath = ax.all_gather(x[self._exp])
        return gath.reshape(-1, 3)[self._gsrc]

    def _home(self, x, gdelta):
        """The ghost rows' deltas go home to their owners."""
        ax, zero = self.axis, x.new_zeros((1, 3))
        if self.neighbor:
            gpad = torch.cat([gdelta, zero])
            below, above = ax.exchange(gpad[self._ret_up],
                                       gpad[self._ret_dn])
            return x.index_add(0, self._send_up, above).index_add(
                0, self._send_dn, below)
        recv = ax.all_gather(gdelta).reshape(-1, 3)[self._rsrc]
        return torch.cat([x, zero]).index_add(0, self._rdst,
                                              recv)[:self.vb]

    def _colours(self, x, w_loc, lam, name, alpha):
        f, zero = self.fams[name], x.new_zeros((1, 3))
        vb, h = self.vb, self.h
        for s, e, idx, rest in f.colours:
            ghost = self._fetch(x)
            xl = torch.cat([x, ghost, zero])
            lc = lam[s:e]
            if name == "edges":
                dlam, corr, w0, w1 = edge_dlambda(xl, w_loc, idx[0], idx[1],
                                                  rest, lc, alpha)
                xl = xl.index_add(0, idx[0], corr * w0[:, None]).index_add(
                    0, idx[1], -corr * w1[:, None])
            else:
                dlam, corrs = tet_dlambda(xl, w_loc, idx, rest, lc, alpha)
                for i, c in zip(idx, corrs):
                    xl = xl.index_add(0, i, c)
            lam[s:e] = lc + dlam
            x = self._home(xl[:vb], xl[vb:vb + h] - ghost)
        return x

    # ---- public <-> carry -------------------------------------------------

    def pack_state(self, state: SimState) -> XpbdCarry:
        refuse_grad("the vertex-sharded xpbd step", state)
        w = state.inv_mass.to(self.device)

        def lam(name, pub):
            f = self.fams.get(name)
            if f is None:
                return None
            return torch.where(f.mask, pub.to(self.device)[f.perm], 0.0)

        w_full = None
        if self.has_stage:
            w_full = torch.cat([w, w.new_zeros(self.vpad - self.nv)])
        return XpbdCarry(
            x=self.own(state.x), v=self.own(state.v), w=self.own(w),
            w_ghost=w[self._ghost_gid],
            lam_e=lam("edges", state.edge_lambda),
            lam_t=lam("tets", state.tet_lambda), w_full=w_full)

    def unpack_state(self, carry: XpbdCarry, state: SimState) -> SimState:
        x, v = self.gather(carry.x), self.gather(carry.v)

        def lam(name, own, pub):
            if own is None:
                return pub
            return self.axis.all_gather(own, tiled=True)[
                self.fams[name].pos_of]

        return SimState(x=x, v=v, x_star=x, inv_mass=state.inv_mass,
                        edge_lambda=lam("edges", carry.lam_e,
                                        state.edge_lambda),
                        tet_lambda=lam("tets", carry.lam_t,
                                       state.tet_lambda))

    def carry_positions(self, carry: XpbdCarry) -> torch.Tensor:
        return self.gather(carry.x)

    def run_carry(self, carry: XpbdCarry, dt, n: int,
                  colliders_rt: Optional[Colliders] = None) -> XpbdCarry:
        """n steps on this rank's carry (every rank calls it with the same
        arguments); returns the new carry."""
        p = self.params
        packed = self.packed(colliders_rt)
        do_collide = self.colliders is not None and self.colliders.count
        ss, sdt, inv_dt, alpha, keep = step_terms(p, dt)
        x, v, w = carry.x, carry.v, carry.w
        lam = {"edges": carry.lam_e, "tets": carry.lam_t}
        lam = {k: None if t is None else t.clone() for k, t in lam.items()}
        w_loc = torch.cat([w, carry.w_ghost, w.new_zeros(1)])
        pinned = (w == 0.0)[:, None]
        free = (w > 0.0)[:, None]
        for _ in range(int(n) * ss):
            xs, v = predict(x, v, pinned, self._gravity, sdt)
            for _ in range(p.iterations):
                for name in ("edges", "tets"):
                    if name in self.fams:
                        xs = self._colours(xs, w_loc, lam[name], name,
                                           alpha[name])
                if p.ground_enabled:
                    xs = project_ground(xs, w, p.ground_y)
                if do_collide:
                    xs = kc.collide_positions(xs, w, packed,
                                              kc.XPBD_GROUND)
                if self.has_stage:
                    xs = self.contact(xs, carry.w_full, free)
            x, v = commit(xs, x, pinned, inv_dt, p, keep)
        return carry._replace(x=x, v=v, lam_e=lam["edges"],
                              lam_t=lam["tets"])

    def __call__(self, state: SimState, dt,
                 colliders_rt: Optional[Colliders] = None) -> SimState:
        return self.step_n(state, dt, 1, colliders_rt)

    def step_n(self, state: SimState, dt, n: int,
               colliders_rt: Optional[Colliders] = None) -> SimState:
        refuse_grad("the vertex-sharded xpbd step", state, colliders_rt)
        return self.unpack_state(
            self.run_carry(self.pack_state(state), dt, n, colliders_rt),
            state)
