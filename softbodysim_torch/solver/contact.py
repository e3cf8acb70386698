"""The contact stages of one solver iteration -- spatial-hash self
collision (``solver/spatial.py``), then vertex-triangle surface collision
(``solver/surface_collide.py``) -- bound once for a step's row layout.

Every backend runs them in each iteration after the ground and the
colliders, the JAX package's stage order (edge -> tet -> ground /
colliders -> self -> surface), and writes back only rows with w != 0:
  - public vertex order (the coloured 'gather' step, jacobi 'gather' /
    'segment' and 'pass'): the cap autosizes off ``topology.vertices`` and
    the table sizes follow the vertex count, as in the JAX package's
    ``solver/xpbd.py`` and XLA ``solver/jacobi.py`` (the port's pass path
    has no dead rows, so it follows the XLA step, not ``jacobi_pallas``);
  - the sweep kernels' row layout (``perm``, ``old2new``): dead rows
    (perm == V) are parked in far hash cells by a static offset table, the
    cap autosizes off the parked rest rows with the padded row count, and
    the triangle corners are remapped to rows, as in
    ``softbodysim_tpu/solver/xpbd_pallas.py:527-573``.
The contact radius is max(1e-6, particle_radius) in both dialects.  The
stages are static-shape tensor ops with no host synchronisation, so the
steps that replay CUDA graphs capture them.  They are out of place, so
autograd follows them w.r.t. the positions (the hashes are integers and
carry none; under autograd the surface stage's integer corner sum takes
the float scatter's gradient, ``solver/surface_collide.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .spatial import make_self_collision_fn, park_offsets
from .surface_collide import make_surface_collision_fn, suggested_cell_size


class ContactStage:
    """``stage(p, w) -> p'`` on rows of the step's layout: the self stage,
    then the surface stage; rows with w == 0 come back unchanged.

    ``caps``: the stages' static sizes (self cap, surface cell and cap);
    ``rows(x, w)``: public positions as the stage's input rows;
    ``overflow(x, w)``: the candidates each stage drops at these public
    positions, in its own layout and table."""

    def __init__(self, topology, params, *, device, perm=None, old2new=None,
                 copies: int = 1):
        self.radius = max(1e-6, params.particle_radius)
        thickness = float(params.surface_thickness)
        surface = bool(params.surface_collision
                       and len(topology.surface_tris))
        rest, rows = np.asarray(topology.vertices, np.float32), None
        tris = np.asarray(topology.surface_tris, np.int64).reshape(-1, 3)
        self._perm = self.iso = None
        if perm is not None:
            perm = np.asarray(perm, np.int64)
            dead = perm == topology.num_particles
            cell = (float(params.self_collision_cell)
                    if params.self_collision
                    else max(thickness, 2.0 * self.radius))
            iso = park_offsets(dead, cell, self.radius, thickness)
            rest = iso.copy()
            rest[~dead] = np.asarray(topology.vertices,
                                     np.float32)[perm[~dead]]
            rows = len(perm)
            tris = np.asarray(old2new, np.int64)[tris]
            self._perm = torch.as_tensor(perm).to(device)
            self.iso = torch.as_tensor(iso).to(device)
        self.self_fn = (make_self_collision_fn(params, rest, rows,
                                               copies=copies)
                        if params.self_collision else None)
        self.surf_fn = None
        if surface:
            if params.surface_collision_cell <= 0.0:
                params = params.replace(
                    surface_collision_cell=suggested_cell_size(
                        topology.vertices, topology.surface_tris,
                        thickness))
            self.surf_fn = make_surface_collision_fn(
                params, tris, copies=copies, device=device)

    @property
    def caps(self) -> dict:
        out = {}
        if self.self_fn is not None:
            out.update(self_cell=self.self_fn.cell,
                       self_max_per_cell=self.self_fn.max_per_cell)
        if self.surf_fn is not None:
            out.update(surface_cell=self.surf_fn.cell,
                       surface_max_per_cell=self.surf_fn.max_per_cell)
        return out

    def __call__(self, p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        q = p if self.iso is None else p + self.iso
        if self.self_fn is not None:
            q = self.self_fn(q, w, self.radius)
        if self.surf_fn is not None:
            q = self.surf_fn(q, w)
        if self.iso is None:
            return q
        return torch.where((w != 0.0)[:, None], q, p)

    def rows(self, x: torch.Tensor, w: torch.Tensor) -> tuple:
        """Public positions (V, 3) and inverse masses (V,) as the stage's
        input rows (the sweep layout: permuted, dead rows zero)."""
        if self._perm is None:
            return x, w
        return (torch.cat([x, x.new_zeros((1, 3))])[self._perm],
                torch.cat([w, w.new_zeros((1,))])[self._perm])

    def overflow(self, x: torch.Tensor, w: torch.Tensor) -> dict:
        """{stage: dropped candidates} at public positions x (V, 3) and
        inverse masses w (V,), evaluated in the stage's layout."""
        x, w = self.rows(x, w)
        if self.iso is not None:
            x = x + self.iso
        out = {}
        if self.self_fn is not None:
            out["self"] = int(self.self_fn.deltas(x, w, self.radius,
                                                  True)[1])
        if self.surf_fn is not None:
            out["surface"] = int(self.surf_fn.deltas(x, w, True)[1])
        return out


def make_contact_stage(topology, params, *, device, perm=None, old2new=None,
                       copies: int = 1) -> Optional[ContactStage]:
    """The step's contact stage, or None when neither stage runs (both
    flags off, or only surface collision on a mesh without surface
    triangles): then a step runs no contact op at all."""
    if not (params.self_collision or (params.surface_collision
                                      and len(topology.surface_tris))):
        return None
    return ContactStage(topology, params, device=device, perm=perm,
                        old2new=old2new, copies=copies)
