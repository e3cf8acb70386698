"""XPBD dialect -- the C++ PBDServer contract (Sim.cpp:100-305) -- and its
coloured Gauss-Seidel backends.

Backends (``params.xpbd_backend``, resolved by ``select.resolve_backend``):
  "sweep"   -- the block-synchronous CUDA sweep kernels
               (``solver/xpbd_sweep.py``; 'pallas' is its alias), at
               either block width (``superblocks``);
  "gather"  -- coloured Gauss-Seidel, colour-major: contiguous lambda
               slices and one (V, 3) correction-table row gather per colour
               (each colour's constraints share no vertex, so each vertex
               has at most one row); 'scatter' is its alias.
The coloured backend is the counterpart of
``softbodysim_tpu/solver/xpbd.py:41-510``, whose 'gather' and 'scatter'
backends compute the same coloured sweep with XLA ops (two forms for
XLA's cost on a TPU); here it is plain tensor ops, on either device, and
one form serves both names.  On the card one iteration's
colour passes and ground clamp -- tens of tiny ops per colour -- are
captured once as a CUDA graph (``solver/graphs.py``) and replayed, so the
host launches one graph instead of every op (the JAX package compiles the
same loop into one XLA program).  The graph reads the compliance scalars
(compliance / sdt^2, per family) from a static device tensor, copied in
only when they change, so a compliance or dt override that changes every
step captures nothing new (the JAX step takes them as traced scalars).
Every backend
applies colliders (world space, particle radius 0) after the ground clamp
in each iteration; on a CUDA device that stage is the fused collide
kernel, launched outside the graph, on the CPU its plain version, behind
``kernels/collide.py::collide_positions`` (a ``torch.autograd.Function``
with ``collide_plain``'s gradient).  Then, with ``self_collision`` /
``surface_collision`` on, the contact stages (``solver/contact.py``); on
the card they run inside the iteration's graph, or in a graph of their own
after the collide kernel when the step has colliders.

The differentiable build (``make_xpbd_step(..., differentiable=True)``,
what ``diff.make_rollout`` builds) is the same coloured sweep written for
autograd, the counterpart of the JAX package's differentiable 'scatter'
step: no CUDA graph, the lambdas updated out of place (one tensor per
colour), the compliances, friction and gravity overrides kept as tensors
down to the commit (0-dim, or per constraint for the compliances), the
ground clamp as ``torch.maximum`` (a tie splits the gradient, as
``jnp.maximum``); the collide and contact stages carry their gradients in
either build.  The kernel backend ('sweep') has no such build: it raises
when handed a tensor that requires grad (``select.refuse_grad``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..collide.primitives import Colliders, cross3, dot3
from ..core.state import SimState, SolverParams, f32, resolve_device
from ..kernels import collide as kc
from ..kernels.sweep import EPS_LEN, EPS_WSUM, SIXTH
from .contact import make_contact_stage
from .graphs import GraphCache
from .select import refuse_grad, resolve_backend


def _at_least(t: torch.Tensor, lo: float) -> torch.Tensor:
    """max(t, lo) as ``jnp.maximum``: a tie splits the gradient."""
    return torch.maximum(t, torch.full_like(t, lo))


# ---- the stages of a substep (the coloured step's; perf/profile.py times
# them one by one)


def predict(x, v, pinned, gravity, sdt):
    """Semi-implicit Euler (Sim.cpp:178-185), pinned rows held still:
    (predicted positions, velocities)."""
    v = torch.where(pinned, v, v + gravity * sdt)
    return torch.where(pinned, x, x + v * sdt), v


def project_ground(xs, w, ground_y: float, differentiable: bool = False):
    """The y clamp on free rows (Sim.cpp:187-195); ``differentiable``: as
    ``jnp.maximum`` (a tie splits the gradient)."""
    y, gy = xs[:, 1], f32(ground_y)
    up = _at_least(y, gy) if differentiable else y.clamp_min(gy)
    return torch.stack([xs[:, 0], torch.where(w != 0.0, up, y), xs[:, 2]],
                       1)


def commit(xs, x, pinned, inv_dt, params: SolverParams, keep):
    """Velocity update and ground friction (Sim.cpp:197-222): (positions,
    velocities).  keep: 1 - friction (a float or a 0-dim tensor)."""
    vel = (xs - x) * inv_dt
    if params.ground_enabled:
        on_g = xs[:, 1] <= f32(params.ground_y + 1e-6)
        vx = torch.where(on_g, vel[:, 0] * keep, vel[:, 0])
        vz = torch.where(on_g, vel[:, 2] * keep, vel[:, 2])
        vy = torch.where(on_g & (vel[:, 1] < 0.0), 0.0, vel[:, 1])
        vel = torch.stack([vx, vy, vz], 1)
    return torch.where(pinned, x, xs), torch.where(pinned, 0.0, vel)


def step_terms(params: SolverParams, dt) -> tuple:
    """A step's scalars from the params alone, float32-exact: (substeps,
    sdt, 1 / sdt, {"edges" | "tets": compliance / sdt^2}, 1 - friction);
    the sharded coloured steps' (``parallel/{constraint,vertex}.py``)."""
    ss = max(1, params.substeps)
    sdt = np.float32(dt) / np.float32(ss)
    big = sdt > np.float32(1e-12)
    inv_dt2 = np.float32(1.0) / (sdt * sdt) if big else np.float32(0.0)
    alpha = {name: float(np.maximum(np.float32(c), np.float32(0.0))
                         * inv_dt2)
             for name, c in (("edges", params.edge_compliance),
                             ("tets", params.volume_compliance))}
    keep = float(np.float32(1.0 - min(1.0, max(0.0, params.friction))))
    return (ss, float(sdt), float(np.float32(1.0) / sdt) if big else 0.0,
            alpha, keep)


def edge_dlambda(x, w, i0, i1, rest, lam, alpha):
    """One colour's distance projection (Sim.cpp:100-130): (dlambda, the
    role-0 correction n*dlambda, w0, w1); invalid constraints get 0."""
    w0, w1 = w[i0], w[i1]
    wsum = w0 + w1
    d = x[i0] - x[i1]
    length = torch.sqrt(dot3(d, d))
    valid = (wsum != 0.0) & (length >= EPS_LEN)
    denom = wsum + alpha
    dlam = torch.where(
        valid, (-(length - rest) - alpha * lam)
        / torch.where(denom == 0.0, 1.0, denom), 0.0)
    n = d * (1.0 / torch.where(length < EPS_LEN, 1.0, length))[:, None]
    return dlam, n * dlam[:, None], w0, w1


def tet_dlambda(x, w, idx, rest, lam, alpha):
    """One colour's volume projection (Sim.cpp:132-173): (dlambda, the four
    corner corrections g_r * (w_r * dlambda))."""
    ws = [w[i] for i in idx]
    pa, pb, pc, pd = (x[i] for i in idx)
    g = (cross3(pd - pb, pc - pb) * SIXTH, cross3(pc - pa, pd - pa) * SIXTH,
         cross3(pd - pa, pb - pa) * SIXTH, cross3(pb - pa, pc - pa) * SIXTH)
    wsum = (((ws[0] * dot3(g[0], g[0]) + ws[1] * dot3(g[1], g[1]))
             + ws[2] * dot3(g[2], g[2])) + ws[3] * dot3(g[3], g[3]))
    valid = ((((ws[0] + ws[1]) + ws[2]) + ws[3]) != 0.0) & (wsum >= EPS_WSUM)
    vol = dot3(cross3(pb - pa, pc - pa), pd - pa) / 6.0
    denom = wsum + alpha
    dlam = torch.where(
        valid, (-(vol - rest) - alpha * lam)
        / torch.where(denom == 0.0, 1.0, denom), 0.0)
    return dlam, [gr * (wr * dlam)[:, None] for gr, wr in zip(g, ws)]


def edge_pass_diff(x, w, flat, rest, lam, alpha, signs):
    """One colour's distance projection written for autograd, the JAX
    package's 'scatter' form: (x', dlambda).  flat: the colour's (K, 2)
    vertex ids row-major, flattened; signs: (1, -1).  The corrections are
    scattered with ``index_add`` (each vertex at most once per colour:
    x + correction exactly), whose backward is a gather; positions are
    gathered with ``index_select``, whose backward scatters without
    sorting.  The arithmetic is ``edge_dlambda``'s but for the length's
    sum of squares, a reduction."""
    k = rest.shape[0]
    p0, p1 = x.index_select(0, flat).view(k, 2, 3).unbind(1)
    w01 = w.index_select(0, flat).view(k, 2)
    wsum = w01.sum(1)
    d = p0 - p1
    length = torch.sqrt((d * d).sum(-1))
    valid = (wsum != 0.0) & (length >= EPS_LEN)
    denom = wsum + alpha
    dlam = torch.where(
        valid, (-(length - rest) - alpha * lam)
        / torch.where(denom == 0.0, 1.0, denom), 0.0)
    n = d * (1.0 / torch.where(length < EPS_LEN, 1.0, length))[:, None]
    corr = (n * dlam[:, None])[:, None, :] * (w01 * signs)[:, :, None]
    return x.index_add(0, flat, corr.reshape(-1, 3)), dlam


def tet_pass_diff(x, w, flat, rest, lam, alpha, sel):
    """One colour's volume projection written for autograd, as
    ``edge_pass_diff``: (x', dlambda).  flat: the colour's (K, 4) vertex
    ids row-major, flattened; sel: the corner indices (origin, left,
    right) of the four role gradients, g_r = (left_r - origin_r) x
    (right_r - origin_r) / 6, computed in one cross product."""
    k = rest.shape[0]
    p = x.index_select(0, flat).view(k, 4, 3)
    wr = w.index_select(0, flat).view(k, 4)
    o = p.index_select(1, sel[0])
    left, right = p.index_select(1, sel[1]) - o, p.index_select(1, sel[2]) - o
    c = torch.linalg.cross(left, right, dim=-1)
    g = c * SIXTH
    wsum = (wr * (g * g).sum(-1)).sum(1)
    valid = (wr.sum(1) != 0.0) & (wsum >= EPS_WSUM)
    vol = (c[:, 3] * right[:, 1]).sum(-1) / 6.0       # (b-a) x (c-a) . (d-a)
    denom = wsum + alpha
    dlam = torch.where(
        valid, (-(vol - rest) - alpha * lam)
        / torch.where(denom == 0.0, 1.0, denom), 0.0)
    corr = g * (wr * dlam[:, None])[:, :, None]
    return x.index_add(0, flat, corr.reshape(-1, 3)), dlam


# tet_pass_diff's corners: g_a = (d-b) x (c-b), g_b = (c-a) x (d-a),
# g_c = (d-a) x (b-a), g_d = (b-a) x (c-a)
_TET_SEL = ((1, 0, 0, 0), (3, 2, 3, 1), (2, 3, 1, 2))


def _colour_slices(groups):
    """Colour-major layout: (order, [(start, end) per colour])."""
    sizes = groups.mask.sum(axis=1).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    return groups.order, [(int(starts[i]), int(starts[i + 1]))
                          for i in range(len(sizes))]


def _vertex_slot_map(num_vertices, rows, arity):
    """Vertex -> row of one colour's role-major correction table (role r of
    constraint j at r*K + j); vertices absent from the colour point at the
    zero row arity*K.  Valid because a colour's constraints share no
    vertex."""
    k = len(rows)
    vslot = np.full((num_vertices,), arity * k, np.int64)
    for r in range(arity):
        vslot[rows[:, r]] = r * k + np.arange(k)
    return vslot


class ColouredStep:
    """``step(state, dt, ...) -> state`` on the coloured Gauss-Seidel
    backend, lambdas in public order at the step boundary.

    copies: the topology is that many equal disjoint copies of one scene
    (a batch stepped as one union); each copy is hashed alone by the
    contact stages.  differentiable: the build for autograd (module
    docstring)."""

    backend = "gather"

    def __init__(self, topology, params: SolverParams,
                 colliders: Optional[Colliders] = None, *, device=None,
                 copies: int = 1, differentiable: bool = False):
        dev = self.device = resolve_device(device)
        self.params = params
        self.differentiable = bool(differentiable)
        self.has_edges = topology.num_edges > 0
        self.has_tets = topology.num_tets > 0
        self._counts = (topology.num_edges, topology.num_tets)
        self.colliders = None if colliders is None else colliders.to(dev)
        self._gravity = torch.tensor(params.gravity, dtype=torch.float32,
                                     device=dev)
        V = topology.num_particles
        self.contact = make_contact_stage(topology, params, device=dev,
                                          copies=copies)
        # on the card: one iteration, and the contact stages' own graph
        # after the collide kernel when there are colliders
        self._graphs = GraphCache(dev, kept=2)

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(dev)

        def f32t(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

        self._fam = {}
        for fam, cons, rest, groups, arity in (
                ("edges", topology.edges, topology.edge_rest,
                 topology.edge_colors, 2),
                ("tets", topology.tets, topology.tet_rest_vol,
                 topology.tet_colors, 4)):
            if len(cons) == 0:
                continue
            order, slices = _colour_slices(groups)
            cm = np.asarray(cons, np.int64)[order]
            self._fam[fam] = dict(
                idx=[i64(cm[:, r]) for r in range(arity)],
                rest=f32t(np.asarray(rest)[order]), slices=slices,
                vslots=[i64(_vertex_slot_map(V, cm[s:e], arity))
                        for s, e in slices],
                perm=i64(order), inv=i64(np.argsort(order)))
            if differentiable:       # each colour's ids, row-major
                self._fam[fam]["flat"] = [i64(cm[s:e].reshape(-1))
                                          for s, e in slices]
        self._signs = torch.tensor([1.0, -1.0], device=dev)
        self._tet_sel = tuple(i64(s) for s in _TET_SEL)
        # on the card, the graph's static inputs: positions, inverse
        # masses, lambdas, the colour-major alpha tables (edges, tets)
        self._buf = None if dev.type != "cuda" or differentiable else dict(
            x=torch.zeros((V, 3), device=dev),
            w=torch.zeros((V,), device=dev),
            lam={fam: torch.zeros((n,), device=dev) for fam, n in (
                ("edges", topology.num_edges), ("tets", topology.num_tets))
                if fam in self._fam},
            alpha=[torch.zeros((n,), device=dev) for n in (
                topology.num_edges, topology.num_tets)])
        # the scalar each alpha table was filled with (None: a table)
        self._alpha_now = [None, None]

    # ---- colour passes ----------------------------------------------------

    # lam: this step's own colour-major tensor, updated in place, or in
    # the differentiable build a list of one tensor per colour, each
    # replaced; x: new tensors per colour; alpha: a colour-major (n,) table

    def _edges(self, x, w, lam, alpha):
        f = self._fam["edges"]
        if self.differentiable:
            for c, ((s, e), flat) in enumerate(zip(f["slices"], f["flat"])):
                x, dlam = edge_pass_diff(x, w, flat, f["rest"][s:e], lam[c],
                                         alpha[s:e], self._signs)
                lam[c] = lam[c] + dlam
            return x
        i0a, i1a = f["idx"]
        zero = x.new_zeros((1, 3))
        for (s, e), vslot in zip(f["slices"], f["vslots"]):
            dlam, corr, w0, w1 = edge_dlambda(
                x, w, i0a[s:e], i1a[s:e], f["rest"][s:e], lam[s:e],
                alpha[s:e])
            rows = torch.cat([corr * w0[:, None], -corr * w1[:, None], zero])
            x = x + rows[vslot]
            lam[s:e] = lam[s:e] + dlam
        return x

    def _tets(self, x, w, lam, alpha):
        f = self._fam["tets"]
        if self.differentiable:
            for c, ((s, e), flat) in enumerate(zip(f["slices"], f["flat"])):
                x, dlam = tet_pass_diff(x, w, flat, f["rest"][s:e], lam[c],
                                        alpha[s:e], self._tet_sel)
                lam[c] = lam[c] + dlam
            return x
        zero = x.new_zeros((1, 3))
        for (s, e), vslot in zip(f["slices"], f["vslots"]):
            dlam, corrs = tet_dlambda(
                x, w, [i[s:e] for i in f["idx"]], f["rest"][s:e], lam[s:e],
                alpha[s:e])
            x = x + torch.cat(corrs + [zero])[vslot]
            lam[s:e] = lam[s:e] + dlam
        return x

    def _solve(self, xs, w, lam, e_alpha, t_alpha):
        """One iteration but its collider stage: the colour passes, then the
        ground clamp (Sim.cpp:187-195).  e_alpha / t_alpha: colour-major
        float32 tables on xs's device, or what broadcasts to one (a
        float32-exact float, a 0-dim tensor: the same bits in every row)."""
        e_alpha, t_alpha = (
            torch.as_tensor(a, dtype=torch.float32, device=xs.device).expand(n)
            for a, n in ((e_alpha, self._counts[0]),
                         (t_alpha, self._counts[1])))
        if self.has_edges:
            xs = self._edges(xs, w, lam["edges"], e_alpha)
        if self.has_tets:
            xs = self._tets(xs, w, lam["tets"], t_alpha)
        if self.params.ground_enabled:
            xs = project_ground(xs, w, self.params.ground_y,
                                self.differentiable)
        return xs

    # ---- stepping ---------------------------------------------------------

    def __call__(self, state: SimState, dt, edge_compliance=None,
                 volume_compliance=None, friction=None, gravity_override=None,
                 colliders_rt: Optional[Colliders] = None) -> SimState:
        """One step.  Overrides of the SolverParams fields for this step:
        the compliances (each a scalar, or a per-constraint tensor in
        public order on the step's device, as a batch of scenes with a
        compliance each passes it), ``friction``, ``gravity_override`` and
        the collider poses ``colliders_rt`` (same count as the make-time
        set).  A tensor override (0-dim, or per constraint for the
        compliances, or (3,) for the gravity) stays a tensor through the
        step, so the differentiable build carries its gradient."""
        p, dev = self.params, self.device
        if not self.differentiable:
            refuse_grad("the coloured step's non-differentiable build",
                        state, edge_compliance, volume_compliance, friction,
                        gravity_override, colliders_rt)
        cols = kc.runtime_colliders(self.colliders, colliders_rt, dev)
        packed = None if cols is None else kc.pack_colliders(cols, dev)
        ec, vc = (c.to(dev, torch.float32) if isinstance(c, torch.Tensor)
                  else np.float32(d if c is None else c)
                  for c, d in ((edge_compliance, p.edge_compliance),
                               (volume_compliance, p.volume_compliance)))
        # 1 - friction: a tensor override stays one (a traced scalar in the
        # JAX step), a float override in f32, else from the Python float
        if isinstance(friction, torch.Tensor):
            fr = friction.to(dev, torch.float32)
            keep = 1.0 - torch.minimum(_at_least(fr, 0.0),
                                       torch.ones_like(fr))
        else:
            keep = float(
                np.float32(1.0) - np.clip(np.float32(friction), 0.0, 1.0)
                if friction is not None
                else np.float32(1.0 - min(1.0, max(0.0, p.friction))))
        if isinstance(gravity_override, torch.Tensor):
            grav = gravity_override.to(dev, torch.float32)
        else:
            grav = (self._gravity if gravity_override is None
                    else torch.tensor(np.asarray(gravity_override,
                                                 np.float32), device=dev))
        ss = max(1, p.substeps)
        sdt = np.float32(dt) / np.float32(ss)
        big = sdt > np.float32(1e-12)
        inv_dt2 = np.float32(1.0) / (sdt * sdt) if big else np.float32(0.0)
        inv_dt = float(np.float32(1.0) / sdt) if big else 0.0
        def alpha(c, fam):   # a float, a 0-dim tensor or a colour-major table
            if not isinstance(c, torch.Tensor):
                return float(np.maximum(c, np.float32(0.0)) * inv_dt2)
            a = _at_least(c, 0.0) * float(inv_dt2)
            if a.dim() == 0 or fam not in self._fam:
                return a
            return a[self._fam[fam]["perm"]]

        e_alpha, t_alpha = alpha(ec, "edges"), alpha(vc, "tets")
        sdt = float(sdt)

        w = state.inv_mass
        pinned = (w == 0.0)[:, None]
        # the colour-major lambdas this step updates in place; on the card
        # the graphs' static buffers
        graphed = self._buf is not None
        lam = self._buf["lam"] if graphed else {}
        for fam, pub in (("edges", state.edge_lambda),
                         ("tets", state.tet_lambda)):
            if fam in self._fam:
                pub = pub[self._fam[fam]["perm"]]
                if graphed:
                    lam[fam].copy_(pub)
                elif self.differentiable:
                    lam[fam] = [pub[s:e] for s, e in self._fam[fam]["slices"]]
                else:
                    lam[fam] = pub
        if graphed:
            b = self._buf
            b["w"].copy_(w)
            # the graph reads the alpha tables: a scalar fills its table
            # when it changes, a table is copied in every step
            for i, a in enumerate((e_alpha, t_alpha)):
                if isinstance(a, torch.Tensor):
                    b["alpha"][i].copy_(a)
                    self._alpha_now[i] = None
                elif a != self._alpha_now[i]:
                    b["alpha"][i].fill_(a)
                    self._alpha_now[i] = a

            def solve():
                xs = self._solve(b["x"], b["w"], b["lam"], *b["alpha"])
                if self.contact is not None and packed is None:
                    xs = self.contact(xs, b["w"])
                return xs

            def contact():
                return self.contact(b["x"], b["w"])

        x, v = state.x, state.v
        for _ in range(ss):
            xs, v = predict(x, v, pinned, grav, sdt)
            for _ in range(p.iterations):
                if graphed:
                    b["x"].copy_(xs)
                    xs = self._graphs.run("iteration", solve)
                else:
                    xs = self._solve(xs, w, lam, e_alpha, t_alpha)
                if packed is not None:
                    xs = kc.collide_positions(xs, w, packed, kc.XPBD_GROUND)
                    if graphed and self.contact is not None:
                        b["x"].copy_(xs)
                        xs = self._graphs.run("contact", contact)
                if not graphed and self.contact is not None:
                    xs = self.contact(xs, w)
            x, v = commit(xs, x, pinned, inv_dt, p, keep)

        lam = {fam: (torch.cat(l) if isinstance(l, list) else l)[
            self._fam[fam]["inv"]] for fam, l in lam.items()}
        return SimState(x=x, v=v, x_star=x, inv_mass=w,
                        edge_lambda=lam.get("edges", state.edge_lambda),
                        tet_lambda=lam.get("tets", state.tet_lambda))

    def step_n(self, state: SimState, dt, n: int, **overrides) -> SimState:
        for _ in range(int(n)):
            state = self(state, dt, **overrides)
        return state


def make_xpbd_step(topology, params, colliders=None, *, device=None,
                   superblocks: bool = True, edge_c=None, tet_c=None,
                   copies: int = 1, host=None,
                   differentiable: bool = False):
    """Build ``step(state, dt) -> state`` for the resolved backend.

    superblocks: the sweep backend's block width (1024-wide super-blocks,
    or the legacy 128-wide blocks when False).  edge_c / tet_c: optional
    per-constraint compliance (public order), sweep backend only.
    copies: the topology is that many disjoint copies, each hashed alone
    by the contact stages (coloured backend only).  host: the sweep
    backend's host make, built beforehand (``xpbd_sweep.sweep_host``).
    differentiable: the coloured step's build for autograd ('auto' picks
    the coloured backend; 'sweep' raises)."""
    if differentiable and params.xpbd_backend not in ("auto", "gather",
                                                      "scatter"):
        raise ValueError(
            f"differentiable=True: the xpbd backend {params.xpbd_backend!r} "
            "runs kernels without a gradient; use 'gather', 'scatter' or "
            "'auto' (diff.differentiable_params picks one)")
    backend = ("gather" if differentiable
               else resolve_backend(topology, params, device=device))
    if backend == "sweep" and copies != 1:
        raise ValueError("copies > 1 (a batch as one union) requires the "
                         "coloured backend")
    if backend == "sweep":
        from .xpbd_sweep import SweepStep

        return SweepStep(topology, params, colliders, device=device,
                         superblocks=superblocks, edge_c=edge_c, tet_c=tet_c,
                         host=host)
    if backend != "gather":
        raise ValueError(f"unknown xpbd_backend {backend!r}")
    if host is not None:
        raise ValueError("host= (a sweep_host make) requires the sweep "
                         "backend")
    if edge_c is not None or tet_c is not None:
        raise ValueError(
            "per-constraint compliance (edge_c / tet_c) requires "
            "xpbd_backend='sweep' (the coloured backend uses scalar "
            "compliance)")
    if not superblocks:
        raise ValueError("superblocks=False selects the legacy sweep "
                         "kernels: it requires xpbd_backend='sweep'")
    return ColouredStep(topology, params, colliders, device=device,
                        copies=copies, differentiable=differentiable)
