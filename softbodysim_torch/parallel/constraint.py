"""Constraint parallelism: scenes over the "data" axis of a mesh, each
scene's constraints over its "model" axis.

The counterpart of ``softbodysim_tpu/parallel/sharding.py::
make_mesh_sharded_step`` (:91-223) and ``make_xpbd_sharded_step``
(:226-541).  A rank holds its block of the batch (``sharding.
shard_batch``; b = B / d scenes), the same on every rank of its "model"
group: positions are replicated along "model", and each model rank works
on its share of every scene's constraints.  The b scenes are stepped as
one disjoint union, as ``parallel/batching.py`` steps a batch: every op
and the collide kernel launch once for all of them, and the contact
stages hash each copy alone.

* Jacobi (``MeshShardedJacobiStep``): the constraints are padded to a
  multiple of m with degenerate entries that fail the solver guards (edge
  (0, 0): length^2 < 1e-18; tet (0, 0, 0, 0): wsum < 1e-20), so the pads
  add nothing, and cut into m equal chunks.  Per iteration and family each
  rank sums its chunk's (delta, count), ``Axis.psum`` adds the ranks'
  (one collective of a (bV, 4) table), and every rank applies the same
  update.  Ground, colliders (the collide kernel on the card), the contact
  stages and the Chebyshev blend run replicated on every model rank: the
  same bits, no collective.  The rest is ``solver/jacobi.py::JacobiStep``'s
  'segment' step, whose call-time overrides (stiffness, omega; floats or
  tensors) it keeps, so ``diff.fit`` optimises through it.
* XPBD (``XpbdShardedStep``): coloured Gauss-Seidel with each colour's
  constraints cut into m chunks (padded with degenerate constraints).  Per
  colour each rank computes its chunk's corrections into a (bV, 3) row
  gather, and ``Axis.psum`` adds the ranks' tables: a colour's
  constraints share no vertex, so each row gets one rank's correction and
  zeros, the single-device colour pass's bits.  Each rank keeps its
  chunks' lambdas, colour-major (the device-chunked layout); the public
  state's lambdas stay in public order, packed at the step's start and
  gathered from every model rank at its end.

The gradient (``parallel/collectives.py``): positions, inverse masses and
stiffness enter a rank's own constraint share through ``Axis.varying``,
so a replicated input's gradient is the sum of the model ranks' shares;
the psum passes the cotangent on.  The xpbd step has no gradient of its
own (``diff.py`` differentiates it through the single-device coloured
build).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..collide.primitives import Colliders
from ..core.state import SimState, SolverParams, init_state, resolve_device
from ..core.topology import merge_topologies
from ..kernels import collide as kc
from ..kernels.jacobi import edge_jacobi_deltas, tet_jacobi_deltas
from ..solver.contact import make_contact_stage
from ..solver.jacobi import JacobiStep
from ..solver.select import refuse_grad
from ..solver.xpbd import (_colour_slices, commit, edge_dlambda, predict,
                           project_ground, step_terms, tet_dlambda)
from .batching import _flatten, _unflatten
from .collectives import Axis


def _pad_to_multiple(arr: np.ndarray, m: int, fill=0) -> np.ndarray:
    pad = (-arr.shape[0]) % m
    if pad == 0:
        return arr
    return np.concatenate(
        [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)], 0)


def _copies(cons: np.ndarray, b: int, nv: int) -> np.ndarray:
    """``cons`` (K, arity) repeated for b disjoint copies of nv vertices,
    copy-major."""
    return (cons[None] + (np.arange(b) * nv)[:, None, None]).reshape(
        -1, cons.shape[1])


def _sum_psum(ax: Axis, delta, cnt):
    """The ranks' (delta, count) added in rank order, one collective."""
    s = ax.psum(torch.cat([delta, cnt.to(delta.dtype)[:, None]], 1))
    return s[:, :3], s[:, 3].round().to(torch.int32)


class _ShardJacobi(JacobiStep):
    """``JacobiStep`` ('segment') on the union of b copies whose edge and
    tet tables hold this model rank's chunk of every copy's constraints;
    each family's (delta, count) summed over the model ranks."""

    def __init__(self, union, params, colliders, copies, chunks, ax,
                 device):
        super().__init__(union, params, "segment", colliders, device=device,
                         copies=copies)
        self.ax = ax
        nv = union.num_particles // copies
        edges, erest, tets, trest = chunks

        def i64(a):
            return torch.as_tensor(a).to(self.device)

        self.edges = i64(_copies(edges, copies, nv))
        self.edge_rest = i64(np.tile(erest, copies))
        self.tets = i64(_copies(tets, copies, nv))
        self.tet_rest = i64(np.tile(trest, copies))

    def _edges(self, x, w, k_edge):
        ax = self.ax
        return _sum_psum(ax, *edge_jacobi_deltas(
            ax.varying(x), ax.varying(w), self.edges, self.edge_rest,
            ax.varying(k_edge), self.nv))

    def _tets(self, x, w, k_vol):
        ax = self.ax
        return _sum_psum(ax, *tet_jacobi_deltas(
            ax.varying(x), ax.varying(w), self.tets, self.tet_rest,
            ax.varying(k_vol), self.nv))


class MeshShardedJacobiStep:
    """``step(block, dt, edge_stiffness=None, volume_stiffness=None,
    sor_omega=None, colliders_rt=None) -> block``: the jacobi dialect on
    this rank's block of scenes (leading axis b, replicated along the
    model axis), its constraints split over the model axis (module
    docstring).  The union's step is built for the block size of the
    call (once, where the size stays)."""

    backend = "segment"

    def __init__(self, topology, params: SolverParams, mesh,
                 colliders: Optional[Colliders] = None,
                 data_axis: str = "data", model_axis: str = "model", *,
                 device=None):
        if params.dialect != "jacobi":
            raise ValueError("make_mesh_sharded_step implements the jacobi "
                             "dialect (make_xpbd_sharded_step: xpbd)")
        self.data = Axis(mesh, data_axis)
        ax = self.model = Axis(mesh, model_axis)
        self.topology, self.params = topology, params
        self.device = resolve_device(device)
        self.colliders = colliders
        m, i = ax.size, ax.index

        def chunk(a, fill=0):
            a = _pad_to_multiple(a, m, fill)
            n = a.shape[0] // m
            return a[i * n:(i + 1) * n]

        self._chunks = (
            chunk(np.asarray(topology.edges, np.int64).reshape(-1, 2)),
            chunk(np.asarray(topology.edge_rest, np.float32)),
            chunk(np.asarray(topology.tets, np.int64).reshape(-1, 4)),
            chunk(np.asarray(topology.tet_rest_vol, np.float32)))
        self._b, self._union = None, None

    def _step(self, b: int) -> _ShardJacobi:
        if b != self._b:
            union, _ = merge_topologies([self.topology] * b)
            self._union = _ShardJacobi(union, self.params, self.colliders,
                                       b, self._chunks, self.model,
                                       self.device)
            self._b = b
        return self._union

    def __call__(self, state: SimState, dt, edge_stiffness=None,
                 volume_stiffness=None, sor_omega=None,
                 colliders_rt: Optional[Colliders] = None) -> SimState:
        b = int(state.x.shape[0])
        out = self._step(b)(_flatten(state), dt, edge_stiffness,
                            volume_stiffness, sor_omega, colliders_rt)
        return _unflatten(out, b)


class _Family:
    """One constraint family's device-chunked colour-major layout on this
    model rank: per colour its slice of the rank's lambdas, its (kl,
    arity) chunk and rest values and how many rows are real; and the
    public <-> internal lambda maps over every rank's chunks."""

    def __init__(self, cons, rest, groups, arity: int, m: int, i: int,
                 device):
        order, slices = _colour_slices(groups)
        cons_cm = np.asarray(cons, np.int64).reshape(-1, arity)[order]
        rest_cm = np.asarray(rest, np.float32)[order]
        ids = [[] for _ in range(m)]
        self.colours = []       # (s, e, chunk, rest, n_real) of rank i
        pos = 0
        for s, e in slices:
            kl = -(-(e - s) // m)
            for d in range(m):
                lo = min(e, s + d * kl)
                hi = min(e, lo + kl)
                n = hi - lo
                ids[d].extend(order[lo:hi].tolist() + [-1] * (kl - n))
                if d == i:
                    c = np.zeros((kl, arity), np.int64)
                    r = np.zeros((kl,), np.float32)
                    c[:n], r[:n] = cons_cm[lo:hi], rest_cm[lo:hi]
                    self.colours.append((pos, pos + kl, c, r, n))
            pos += kl
        self.local = pos
        flat = np.asarray(ids, np.int64).reshape(-1)
        valid = flat >= 0
        pos_of = np.zeros((len(cons_cm),), np.int64)
        pos_of[flat[valid]] = np.flatnonzero(valid)
        mine = np.asarray(ids[i], np.int64)
        self.perm, self.perm_mask, self.pos_of = (
            torch.as_tensor(a).to(device)
            for a in (np.maximum(mine, 0), mine >= 0, pos_of))

    def union(self, b: int, nv: int, device):
        """Per colour, the b copies' chunk rows (copy-major), their rest
        values and the (bV,) vertex -> row map of the colour's role-major
        correction table (absent vertices -> its zero row)."""
        out = []
        for s, e, c, r, n in self.colours:
            kl, arity = c.shape
            k = b * kl
            rows = _copies(c, b, nv)
            vslot = np.full((b * nv,), arity * k, np.int64)
            real = (np.arange(b)[:, None] * kl + np.arange(n)).reshape(-1)
            for role in range(arity):
                vslot[rows[real, role]] = role * k + real
            t = [torch.as_tensor(a).to(device)
                 for a in (rows, np.tile(r, b), vslot)]
            out.append((s, e, [t[0][:, q].contiguous()
                               for q in range(arity)], t[1], t[2]))
        return out


class XpbdShardedStep:
    """``step(block, dt, colliders_rt=None) -> block``: the xpbd dialect
    (coloured Gauss-Seidel, the C++ server contract) on this rank's block
    of scenes, each colour's constraints split over the model axis (module
    docstring).  ``build_state(batch)``: this rank's block of a
    ``batch``-scene initial state, lambdas zero (Server.cpp INIT)."""

    backend = "gather"

    def __init__(self, topology, params: SolverParams, mesh,
                 colliders: Optional[Colliders] = None,
                 data_axis: str = "data", model_axis: str = "model", *,
                 device=None):
        if params.dialect != "xpbd":
            raise ValueError("make_xpbd_sharded_step implements the xpbd "
                             "dialect (make_mesh_sharded_step: jacobi)")
        self.data = Axis(mesh, data_axis)
        ax = self.model = Axis(mesh, model_axis)
        self.topology, self.params = topology, params
        dev = self.device = resolve_device(device)
        self.colliders = None if colliders is None else colliders.to(dev)
        self._gravity = torch.tensor(params.gravity, dtype=torch.float32,
                                     device=dev)
        self.fams = {}
        for name, cons, rest, groups, arity in (
                ("edges", topology.edges, topology.edge_rest,
                 topology.edge_colors, 2),
                ("tets", topology.tets, topology.tet_rest_vol,
                 topology.tet_colors, 4)):
            if len(cons):
                self.fams[name] = _Family(cons, rest, groups, arity,
                                          ax.size, ax.index, dev)
        self._b, self._tables, self._contact = None, None, None

    def build_state(self, batch: int) -> SimState:
        from .sharding import _block

        _block(batch, self.data)                 # raises unless it divides
        b = batch // self.data.size
        base = init_state(self.topology, inv_mass_mode="tet",
                          device=self.device)
        return SimState(
            **{f: getattr(base, f).unsqueeze(0).repeat(
                (b,) + (1,) * getattr(base, f).dim())
               for f in ("x", "v", "x_star", "inv_mass")},
            edge_lambda=torch.zeros((b, max(self.topology.num_edges, 1)),
                                    device=self.device),
            tet_lambda=torch.zeros((b, max(self.topology.num_tets, 1)),
                                   device=self.device))

    def _union(self, b: int):
        if b != self._b:
            nv = self.topology.num_particles
            self._tables = {name: f.union(b, nv, self.device)
                            for name, f in self.fams.items()}
            contact = None
            if self.params.self_collision or self.params.surface_collision:
                union, _ = merge_topologies([self.topology] * b)
                contact = make_contact_stage(union, self.params,
                                             device=self.device, copies=b)
            self._contact, self._b = contact, b
        return self._tables

    def _pack(self, name: str, pub: torch.Tensor) -> torch.Tensor:
        f = self.fams[name]
        return torch.where(f.perm_mask, pub[:, f.perm], 0.0).contiguous()

    def _unpack(self, name: str, lam: torch.Tensor) -> torch.Tensor:
        """Every model rank's chunks -> (b, n) public order."""
        g = self.model.all_gather(lam)                    # (m, b, L)
        flat = g.permute(1, 0, 2).reshape(lam.shape[0], -1)
        return flat[:, self.fams[name].pos_of]

    def __call__(self, state: SimState, dt,
                 colliders_rt: Optional[Colliders] = None) -> SimState:
        refuse_grad("the constraint-sharded xpbd step", state, colliders_rt)
        p, dev, ax = self.params, self.device, self.model
        b = int(state.x.shape[0])
        tables = self._union(b)
        cols = kc.runtime_colliders(self.colliders, colliders_rt, dev)
        packed = None if cols is None else kc.pack_colliders(cols, dev)
        ss, sdt, inv_dt, alpha, keep = step_terms(p, dt)
        lam = {name: self._pack(name, getattr(state, pub))
               for name, pub in (("edges", "edge_lambda"),
                                 ("tets", "tet_lambda"))
               if name in self.fams}
        w = state.inv_mass.reshape(-1)
        pinned = (w == 0.0)[:, None]
        x, v = state.x.reshape(-1, 3), state.v.reshape(-1, 3)
        zero = x.new_zeros((1, 3))

        def colours(xs, name):
            a, lm = alpha[name], lam[name]
            for s, e, idx, rest, vslot in tables[name]:
                lc = lm[:, s:e].reshape(-1)
                if name == "edges":
                    dlam, corr, w0, w1 = edge_dlambda(xs, w, idx[0], idx[1],
                                                      rest, lc, a)
                    rows = torch.cat([corr * w0[:, None],
                                      -corr * w1[:, None], zero])
                else:
                    dlam, corrs = tet_dlambda(xs, w, idx, rest, lc, a)
                    rows = torch.cat(corrs + [zero])
                xs = xs + ax.psum(rows[vslot])
                lm[:, s:e] = (lc + dlam).view(b, e - s)
            return xs

        for _ in range(ss):
            xs, v = predict(x, v, pinned, self._gravity, sdt)
            for _ in range(p.iterations):
                for name in ("edges", "tets"):
                    if name in self.fams:
                        xs = colours(xs, name)
                if p.ground_enabled:
                    xs = project_ground(xs, w, p.ground_y)
                if packed is not None:
                    xs = kc.collide_positions(xs, w, packed, kc.XPBD_GROUND)
                if self._contact is not None:
                    xs = self._contact(xs, w)
            x, v = commit(xs, x, pinned, inv_dt, p, keep)

        def shaped(t):
            return t.reshape(b, -1, 3)

        return SimState(
            x=shaped(x), v=shaped(v), x_star=shaped(x),
            inv_mass=state.inv_mass,
            edge_lambda=(self._unpack("edges", lam["edges"])
                         if "edges" in lam else state.edge_lambda),
            tet_lambda=(self._unpack("tets", lam["tets"])
                        if "tets" in lam else state.tet_lambda))
