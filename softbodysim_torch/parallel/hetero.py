"""Heterogeneous batched scenes: different meshes, one step.

The reference's multi-mesh scenes step bodies one dispatch at a time
(SoftBodyManager.cs:217-233).  Here bodies of different topologies batch
into one Jacobi step: per-scene padded adjacency arrays (the gather
formulation takes topology as plain arrays), padding rows masked out and
padded particles pinned (w = 0) at the origin, as
``softbodysim_tpu/parallel/hetero.py`` builds them.  Where the JAX package
vmaps one scene's step over those arrays, the port offsets each scene's
indices into one flat table of B * Vmax rows, so each op of the step runs
once for all scenes; the collide stage is the collide wrapper on that
table (one kernel launch on the card).  Like the JAX package's hetero
step, this step has no contact stage: ``self_collision`` and
``surface_collision`` are not read.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..collide.primitives import Colliders
from ..core.adjacency import padded_edge_adjacency, padded_tet_adjacency
from ..core.state import (SimState, SolverParams, f32, init_state,
                          resolve_device)
from ..core.topology import Topology
from ..kernels import collide as kc
from ..kernels.jacobi import apply_delta
from ..solver.jacobi import edge_gather_deltas, tet_phase_a, tet_phase_b


def _pad2(a, shape, fill=0):
    out = np.full(shape, fill, a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


class HeteroBatch:
    """Padded per-scene topology arrays (NumPy) and the initial state of a
    list of bodies."""

    def __init__(self, topologies: Sequence[Topology], params: SolverParams,
                 pinned: Optional[List] = None, density: float = 1.0, *,
                 device=None):
        self.topologies = list(topologies)
        self.device = dev = resolve_device(device)
        b = len(self.topologies)
        v_max = max(t.num_particles for t in self.topologies)
        t_max = max(max(t.num_tets for t in self.topologies), 1)

        e_adj, t_adj = [], []
        for topo in self.topologies:
            other, eidx, mask = padded_edge_adjacency(topo.num_particles,
                                                      topo.edges)
            e_adj.append((other, topo.edge_rest[eidx], mask))
            tidx, role, tmask = padded_tet_adjacency(topo.num_particles,
                                                     topo.tets)
            t_adj.append((role.astype(np.int64) * t_max + tidx, tidx, tmask))
        de = max(a[0].shape[1] for a in e_adj)
        dt = max(a[0].shape[1] for a in t_adj)

        def stack(adj, k, width, dtype=None, fill=0):
            out = np.stack([_pad2(a[k], (v_max, width), fill) for a in adj])
            return out if dtype is None else out.astype(dtype)

        self.e_other = stack(e_adj, 0, de, np.int32)
        self.e_rest = stack(e_adj, 1, de, np.float32)
        self.e_mask = stack(e_adj, 2, de, fill=False)
        self.t_slot = stack(t_adj, 0, dt, np.int32)
        self.t_tidx = stack(t_adj, 1, dt, np.int32)
        self.t_mask = stack(t_adj, 2, dt, fill=False)
        # per-scene tets and rest volumes padded to t_max (all-zero tets
        # fail the wsum guard: no-ops)
        self.tets = np.stack([_pad2(t.tets.astype(np.int32), (t_max, 4))
                              for t in self.topologies])
        self.tet_rest = np.stack([
            _pad2(t.tet_rest_vol.astype(np.float32), (t_max,))
            for t in self.topologies])

        # state: padded particles are pinned dummies at the origin
        xs, ws = [], []
        inv_mode = "tet" if params.dialect == "xpbd" else "density"
        for i, topo in enumerate(self.topologies):
            st = init_state(topo, pinned=None if pinned is None
                            else pinned[i], inv_mass_mode=inv_mode,
                            density=density, device="cpu")
            xs.append(_pad2(st.x.numpy(), (v_max, 3)))
            ws.append(_pad2(st.inv_mass.numpy(), (v_max,)))
        x0 = torch.from_numpy(np.stack(xs)).to(dev)
        self.v_max, self.t_max, self.batch = v_max, t_max, b
        self.state = SimState(
            x=x0, v=torch.zeros((b, v_max, 3), device=dev),
            x_star=x0.clone(), inv_mass=torch.from_numpy(np.stack(ws)).to(dev),
            edge_lambda=torch.zeros((b, 1), device=dev),
            tet_lambda=torch.zeros((b, 1), device=dev))

    def slices(self):
        return [slice(0, t.num_particles) for t in self.topologies]


def make_hetero_step(batch: HeteroBatch, params: SolverParams,
                     colliders: Optional[Colliders] = None, *, device=None):
    """One jacobi step over all scenes of a HeteroBatch: step(state, dt)
    on (B, Vmax, ...) states."""
    if params.dialect != "jacobi":
        raise ValueError("hetero batching currently supports the jacobi "
                         "dialect (the reference's multi-mesh scenes are "
                         "GPU==jacobi scenes)")
    dev = resolve_device(batch.device if device is None else device)
    nb, vmax, tmax = batch.batch, batch.v_max, batch.t_max

    def flat(a, dtype, row_offset=None):
        """(B, R, ...) -> (B*R, ...); ``row_offset`` per scene added."""
        a = torch.from_numpy(np.asarray(a)).to(dtype)
        if row_offset is not None:
            shape = (nb,) + (1,) * (a.dim() - 1)
            a = a + (torch.arange(nb, dtype=dtype) * row_offset).reshape(
                shape)
        return a.reshape((-1,) + tuple(a.shape[2:])).to(dev)

    i64 = torch.int64
    eo = flat(batch.e_other, i64, vmax)
    er = flat(batch.e_rest, torch.float32)
    em = flat(batch.e_mask, torch.bool)
    # the tet table role-major over all B*tmax tets: scene b's tet t,
    # role r at r*(B*tmax) + b*tmax + t
    tt = flat(batch.t_tidx, i64, tmax)
    ts = flat(np.asarray(batch.t_slot) // tmax, i64) * (nb * tmax) + tt
    tm = flat(batch.t_mask, torch.bool)
    tets = flat(batch.tets, i64, vmax)
    tet_rest = flat(batch.tet_rest, torch.float32)

    gravity = torch.tensor(params.gravity, dtype=torch.float32, device=dev)
    ground = kc.make_ground(params)
    cols = None if colliders is None else colliders.to(dev)
    packed = kc.pack_colliders(cols, dev)
    do_collide = params.ground_enabled or (cols is not None
                                           and cols.count > 0)
    k_edge, k_vol = f32(params.edge_stiffness), f32(params.volume_stiffness)
    omega = f32(params.sor_omega)
    ss = max(1, params.substeps)

    def iteration(x, w):
        d, c = edge_gather_deltas(x, w, eo, er, em, k_edge)
        x = apply_delta(x, w, d, c, omega)
        glam, valid = tet_phase_a(x, w, tets, tet_rest, k_vol)
        d, c = tet_phase_b(glam, valid, w, ts, tt, tm)
        x = apply_delta(x, w, d, c, omega)
        if do_collide:
            x = kc.collide_positions(x, w, packed, ground)
        return x

    def step(state: SimState, dt) -> SimState:
        sdt = np.float32(dt) / np.float32(ss)
        inv_dt = float(np.float32(1.0) / sdt) if sdt > 0 else 0.0
        sdt = float(sdt)
        x = state.x.reshape(-1, 3)
        v = state.v.reshape(-1, 3)
        w = state.inv_mass.reshape(-1)
        pinned = (w == 0.0)[:, None]
        for _ in range(ss):
            v = torch.where(pinned, 0.0, v + gravity * sdt)
            x_pred = torch.where(pinned, x, x + v * sdt)
            for _ in range(params.iterations):
                x_pred = iteration(x_pred, w)
            v = torch.where(pinned, 0.0, (x_pred - x) * inv_dt)
            x = torch.where(pinned, x, x_pred)
        x = x.reshape(nb, vmax, 3)
        return SimState(x=x, v=v.reshape(nb, vmax, 3), x_star=x,
                        inv_mass=state.inv_mass,
                        edge_lambda=state.edge_lambda,
                        tet_lambda=state.tet_lambda)

    return step


class HeteroEngine:
    """Engine wrapper: a whole multi-mesh scene as one step."""

    def __init__(self, topologies: Sequence[Topology], params: SolverParams,
                 colliders: Optional[Colliders] = None, pinned=None,
                 density: float = 1.0, *, device=None):
        self.batch = HeteroBatch(topologies, params, pinned=pinned,
                                 density=density, device=device)
        self.device = self.batch.device
        self.state = self.batch.state
        self._step = make_hetero_step(self.batch, params,
                                      colliders=colliders)

    def step(self, dt: float = 1.0 / 60.0) -> "HeteroEngine":
        self.state = self._step(self.state, dt)
        return self

    def positions(self) -> List[np.ndarray]:
        xs = self.state.x.cpu().numpy()
        return [xs[i, s] for i, s in enumerate(self.batch.slices())]

    def block(self) -> "HeteroEngine":
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self
