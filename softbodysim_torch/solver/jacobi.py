"""Jacobi + SOR solver -- the Unity in-engine physics contract (PyTorch).

The counterpart of ``softbodysim_tpu/solver/jacobi.py``: per substep
predict (pinned velocities zeroed), then ``params.iterations`` x {edge
gather + apply, tet gather + apply, ground plane and colliders}, then the
velocity update.  Each constraint reads the iteration's snapshot; each
particle's delta is the sum of its constraints' contributions, applied as
x += (omega / count) * delta (SoftBodySolver.cs:349-527).

Backends (``params.jacobi_backend``, resolved by ``select.resolve_backend``):
  "segment" -- per-constraint math, scattered into (delta, count) (the
               deltas summed in int64 fixed point, ``core/fixed.py``:
               the same bits on every run, on either device);
  "gather"  -- per-vertex reduction over degree-bucketed padded rows (the
               reference's K_EdgeGather / K_VolumeGather walk);
  "pass"    -- the CUDA pass kernels on a (V, 4) table
               (``solver/jacobi_pass.py``); 'pallas' is its alias.
The segment and gather backends are plain tensor code on either device;
their collide stage goes through the fused collide wrapper
(``kernels/collide.py``), which launches the kernel on a CUDA device and
runs its plain version on the CPU, with a body transform too (the stage
runs in world space), then, with ``self_collision`` / ``surface_collision``
on, the contact stages (``solver/contact.py``), in world space too: under
a body transform the positions go to world space, through the ground,
the colliders and the contact stages, and back (the JAX package's
``solve_collisions``).  ``use_pallas='off'`` is refused on a CUDA device.
The per-constraint math lives beside the pass kernels' plain versions
(``kernels/jacobi.py``).  Tensors are new per operation (no in-place
updates), as in the JAX package: the collide stage goes through
``kernels/collide.py::collide_positions``, a ``torch.autograd.Function``
whose forward is the kernel on the card, and the stiffness and omega
overrides may be tensors, so the segment and gather steps are
differentiable as built (``diff.make_rollout`` runs 'segment').  The
'pass' backend raises when handed a tensor that requires grad
(``select.refuse_grad``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..collide.primitives import Colliders, dot3
from ..core.state import SimState, SolverParams, f32, resolve_device
from ..kernels import collide as kc
from ..kernels.jacobi import (EPS_LEN2, EPS_SQRT, apply_delta,
                              edge_jacobi_deltas, tet_jacobi_deltas,
                              tet_lambda)
from .accel import chebyshev_loop
from .contact import make_contact_stage


def edge_gather_deltas(x_pred, inv_mass, other, rest_p, mask, stiffness,
                       vids=None):
    """Padded-gather form of edge_jacobi_deltas (K_EdgeGather,
    SoftBodyCompute.compute:243-274): each row reduces over its padded
    neighbours.  vids: the rows' vertex ids when they cover one degree
    bucket."""
    xi = x_pred if vids is None else x_pred[vids]
    wi = (inv_mass if vids is None else inv_mass[vids])[:, None]
    xj = x_pred[other]                                      # (N, D, 3)
    w = wi + inv_mass[other]
    d = xi[:, None, :] - xj
    len2 = dot3(d, d)
    valid = mask & (w != 0.0) & (len2 >= EPS_LEN2)
    ln = torch.sqrt(len2.clamp_min(EPS_SQRT))
    n = d / ln[..., None]
    lam = torch.where(
        valid, -stiffness * ((ln - rest_p) / torch.where(w == 0.0, 1.0, w)),
        0.0)
    delta = (n * (lam * wi)[..., None]).sum(1)
    return delta, valid.sum(1, dtype=torch.int32)


def tet_phase_a(x_pred, inv_mass, tets, tet_rest_vol, stiffness):
    """Per-tet gradients times lambda, role-major: (glam (4T, 3) with
    glam[r*T + t] = g_r(t) * lambda(t), valid (T,))."""
    corners = [tets[:, r] for r in range(4)]
    gs, lam, valid = tet_lambda([x_pred[c] for c in corners],
                                [inv_mass[c] for c in corners],
                                tet_rest_vol, stiffness)
    return torch.cat([g * lam[:, None] for g in gs]), valid


def tet_phase_b(glam, valid, inv_mass, slot, tidx, mask, vids=None):
    """Per-particle padded row gather of the phase-A table; vids: the rows'
    vertex ids when they cover one degree bucket."""
    wi = inv_mass if vids is None else inv_mass[vids]
    m = torch.where(mask, 1.0, 0.0)[..., None]
    delta = (glam[slot] * m).sum(1) * wi[:, None]
    cnt = (valid[tidx] & mask & (wi[:, None] != 0.0)).sum(
        1, dtype=torch.int32)
    return delta, cnt


def _as_table(a, device):
    return None if a is None else torch.as_tensor(
        np.asarray(a, np.float32)).to(device)


class JacobiStep:
    """``step(state, dt, ...) -> state`` on the segment or gather backend.

    local_to_world / world_to_local: optional (4, 4) matrices of a body
    simulated in local space (SoftBodySolver.cs:224-226): collisions run in
    world space and gravity turns into the local frame.  edge_k / tet_k:
    optional per-constraint stiffness (public order); the step-time
    stiffness scalars then multiply them (default 1.0).  copies: the
    topology is that many equal disjoint copies (a batch as one union),
    each hashed alone by the contact stages."""

    def __init__(self, topology, params: SolverParams, backend: str,
                 colliders: Optional[Colliders] = None, *, device=None,
                 local_to_world=None, world_to_local=None, edge_k=None,
                 tet_k=None, copies: int = 1):
        if backend not in ("segment", "gather"):
            raise ValueError(f"unknown jacobi_backend {backend!r} "
                             "(segment|gather|pass)")
        self.backend = backend
        self.params = params
        dev = self.device = resolve_device(device)
        if params.use_pallas not in ("auto", "on", "off"):
            raise ValueError(f"unknown use_pallas {params.use_pallas!r} "
                             "(auto|on|off)")
        if params.use_pallas == "off" and dev.type == "cuda":
            raise ValueError(
                "use_pallas='off' on a CUDA device: the collide stage runs "
                "the fused collide kernel there (its plain version runs "
                "only on the CPU)")
        nv = self.nv = topology.num_particles
        self.has_edges = topology.num_edges > 0
        self.has_tets = topology.num_tets > 0

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(dev)

        self.edges = i64(topology.edges).reshape(-1, 2)
        self.edge_rest = _as_table(topology.edge_rest, dev)
        self.tets = i64(topology.tets).reshape(-1, 4)
        self.tet_rest = _as_table(topology.tet_rest_vol, dev)
        self.edge_k = _as_table(edge_k, dev)
        self.tet_k = _as_table(tet_k, dev)

        if backend == "gather":
            from ..core.adjacency import (bucketize_padded,
                                          padded_edge_adjacency,
                                          padded_tet_adjacency)

            # degree-bucketed padded rows: each bucket pads to its own cap
            if self.has_edges:
                e_other, e_eidx, e_mask = padded_edge_adjacency(
                    nv, topology.edges)
                ebuckets, e_pos = bucketize_padded(
                    [e_other, e_eidx], e_mask, e_mask.sum(1))
                ek = None if edge_k is None else np.asarray(edge_k,
                                                            np.float32)
                self.e_buckets = [
                    (i64(vids), i64(arrs[0]),
                     _as_table(topology.edge_rest[arrs[1]], dev),
                     torch.as_tensor(m).to(dev),
                     None if ek is None else _as_table(ek[arrs[1]], dev),
                     i64(arrs[1]))
                    for vids, arrs, m in ebuckets]
                self.e_pos = i64(e_pos)
            if self.has_tets:
                t_tidx, t_role, t_mask = padded_tet_adjacency(nv,
                                                              topology.tets)
                t_slot = t_role.astype(np.int64) * topology.num_tets + t_tidx
                tbuckets, t_pos = bucketize_padded(
                    [t_slot, t_tidx], t_mask, t_mask.sum(1))
                self.t_buckets = [
                    (i64(vids), i64(arrs[0]), i64(arrs[1]),
                     torch.as_tensor(m).to(dev))
                    for vids, arrs, m in tbuckets]
                self.t_pos = i64(t_pos)

        self.gravity = torch.tensor(params.gravity, dtype=torch.float32,
                                    device=dev)
        self.ground = kc.make_ground(params)
        self.l2w = _as_table(local_to_world, dev)
        self.w2l = _as_table(world_to_local, dev)
        self.colliders = None if colliders is None else colliders.to(dev)
        self.do_collide = params.ground_enabled or (
            colliders is not None and colliders.count > 0)
        self.contact = make_contact_stage(topology, params, device=dev,
                                          copies=copies)

    # ---- stages -----------------------------------------------------------

    def _edges(self, x, w, k_edge):
        """k_edge: a float, a 0-dim tensor or an (E,) tensor (public
        order)."""
        if self.backend == "gather":
            table = isinstance(k_edge, torch.Tensor) and k_edge.dim() > 0

            def k_of(kb, eb):
                k = k_edge[eb] if table else k_edge
                return k if kb is None else kb * k

            parts = [edge_gather_deltas(x, w, ob, rb, mb, k_of(kb, eb),
                                        vids=vb)
                     for vb, ob, rb, mb, kb, eb in self.e_buckets]
            delta = torch.cat([p[0] for p in parts])[self.e_pos]
            cnt = torch.cat([p[1] for p in parts])[self.e_pos]
        else:
            ek = k_edge if self.edge_k is None else self.edge_k * k_edge
            delta, cnt = edge_jacobi_deltas(x, w, self.edges, self.edge_rest,
                                            ek, self.nv)
        return delta, cnt

    def _tets(self, x, w, k_vol):
        tk = k_vol if self.tet_k is None else self.tet_k * k_vol
        if self.backend == "gather":
            glam, valid = tet_phase_a(x, w, self.tets, self.tet_rest, tk)
            parts = [tet_phase_b(glam, valid, w, sb, tb, mb, vids=vb)
                     for vb, sb, tb, mb in self.t_buckets]
            delta = torch.cat([p[0] for p in parts])[self.t_pos]
            cnt = torch.cat([p[1] for p in parts])[self.t_pos]
        else:
            delta, cnt = tet_jacobi_deltas(x, w, self.tets, self.tet_rest,
                                           tk, self.nv)
        return delta, cnt

    def _collide(self, x, w, packed, l2w, w2l):
        """The ground and the colliders in world space through the fused
        collide wrapper, then the contact stages; each moves free rows
        only."""
        pw = x if l2w is None else x @ l2w[:3, :3].T + l2w[:3, 3]
        if self.do_collide:
            pw = kc.collide_positions(pw, w, packed, self.ground)
        if self.contact is not None:
            pw = self.contact(pw, w)
        if w2l is None:
            return pw
        pl = pw @ w2l[:3, :3].T + w2l[:3, 3]
        return torch.where((w != 0.0)[:, None], pl, x)

    # ---- stepping ---------------------------------------------------------

    def __call__(self, state: SimState, dt, edge_stiffness=None,
                 volume_stiffness=None, sor_omega=None,
                 colliders_rt: Optional[Colliders] = None,
                 local_to_world_rt=None, world_to_local_rt=None) -> SimState:
        """One step.  Overrides: the stiffness (each a scalar, or a
        per-constraint tensor in public order on the step's device, as a
        batch of scenes with a stiffness each passes it) and omega (a
        float or a 0-dim tensor); collider poses for this step (same count
        as the make-time set); the body transforms for this step (only
        with make-time transforms)."""
        p = self.params

        def stiffness(override, table, default):
            if isinstance(override, torch.Tensor):
                return override.to(self.device, torch.float32)
            return f32((1.0 if table is not None else default)
                       if override is None else override)

        k_edge = stiffness(edge_stiffness, self.edge_k, p.edge_stiffness)
        k_vol = stiffness(volume_stiffness, self.tet_k, p.volume_stiffness)
        omega = (sor_omega.to(self.device, torch.float32)
                 if isinstance(sor_omega, torch.Tensor)
                 else f32(p.sor_omega if sor_omega is None else sor_omega))
        l2w = self.l2w if local_to_world_rt is None else _as_table(
            local_to_world_rt, self.device)
        w2l = self.w2l if world_to_local_rt is None else _as_table(
            world_to_local_rt, self.device)
        if (l2w is None) != (self.l2w is None):
            raise ValueError("runtime transforms require make-time "
                             "transforms")
        cols = kc.runtime_colliders(self.colliders, colliders_rt,
                                    self.device)
        packed = kc.pack_colliders(cols, self.device)
        grav = self.gravity if w2l is None else w2l[:3, :3] @ self.gravity

        ss = max(1, p.substeps)
        sdt = np.float32(dt) / np.float32(ss)
        inv_dt = float(np.float32(1.0) / sdt) if sdt > 0 else 0.0
        sdt = float(sdt)
        w = state.inv_mass
        pinned = (w == 0.0)[:, None]

        def iteration(x):
            if self.has_edges:
                x = apply_delta(x, w, *self._edges(x, w, k_edge), omega)
            if self.has_tets:
                x = apply_delta(x, w, *self._tets(x, w, k_vol), omega)
            if self.do_collide or self.contact is not None:
                x = self._collide(x, w, packed, l2w, w2l)
            return x

        x, v = state.x, state.v
        for _ in range(ss):
            # PreSolve (SoftBodySolver.cs:349-362)
            v = torch.where(pinned, 0.0, v + grav * sdt)
            x_pred = torch.where(pinned, x, x + v * sdt)
            x_pred = chebyshev_loop(iteration, x_pred, p)
            # PostSolve (SoftBodySolver.cs:364-377)
            v = torch.where(pinned, 0.0, (x_pred - x) * inv_dt)
            x = torch.where(pinned, x, x_pred)
        return SimState(x=x, v=v, x_star=x, inv_mass=w,
                        edge_lambda=state.edge_lambda,
                        tet_lambda=state.tet_lambda)

    def step_n(self, state: SimState, dt, n: int, **overrides) -> SimState:
        for _ in range(int(n)):
            state = self(state, dt, **overrides)
        return state


def make_jacobi_step(topology, params: SolverParams,
                     colliders: Optional[Colliders] = None,
                     local_to_world=None, world_to_local=None,
                     edge_k=None, tet_k=None, *, device=None,
                     copies: int = 1):
    """Build ``step(state, dt) -> state`` for the resolved jacobi backend
    on ``device`` (default: the card).  copies: the topology is that many
    disjoint copies, each hashed alone by the contact stages ('segment' /
    'gather' only)."""
    from .select import resolve_with_tiles

    backend, tiles = resolve_with_tiles(
        topology, params, device=device, local_to_world=local_to_world,
        num_colliders=0 if colliders is None else colliders.count)
    if backend == "pass":
        if local_to_world is not None or world_to_local is not None:
            raise ValueError(
                "jacobi_backend='pass' does not support local-space "
                "transforms -- use 'gather' (or 'auto', which picks it)")
        if copies != 1:
            raise ValueError("copies > 1 (a batch as one union) requires "
                             "jacobi_backend 'gather' or 'segment'")
        from .jacobi_pass import JacobiPassStep

        return JacobiPassStep(topology, params, colliders, device=device,
                              edge_k=edge_k, tet_k=tet_k, tiles=tiles)
    return JacobiStep(topology, params, backend, colliders, device=device,
                      local_to_world=local_to_world,
                      world_to_local=world_to_local, edge_k=edge_k,
                      tet_k=tet_k, copies=copies)
