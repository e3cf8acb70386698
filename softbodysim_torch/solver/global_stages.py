"""The contact stages (self / surface) in the kernel-sharded steps'
own-slice form.

The counterpart of ``softbodysim_tpu/solver/global_stages.py``.  The
spatial-hash stages are global: a particle's contact candidates can live
on any rank, so a sharded step cannot run them on its own rows alone.
Each iteration a rank

  1. all-gathers the full position table (the parks added),
  2. evaluates ONLY its own contiguous row slice against the global hash
     table (the ``own_offset`` / ``own_count`` mode of
     ``solver/spatial.py::self_collision_deltas`` and
     ``solver/surface_collide.py::surface_collision_deltas``),
  3. applies on its own rows.  Surface-contact corner reactions land on any
     row, so they are summed over the ranks (``Axis.psum``) and each rank
     adds its own slice.

The union of the own-slice hit sets over the ranks is the single-device
hit set (each contact is evaluated by exactly one owner), so the sharded
stages match the single-device stages up to fp32 summation order.

Dead rows (tail padding, layout alignment gaps) sit at the origin in the
stage layout and would shove nearby live particles, so a static offset
table parks each dead row in its own far-away hash cell
(``spatial.park_offsets``); callers add it before hashing.
"""

from __future__ import annotations

import numpy as np
import torch

from .spatial import (make_self_collision_fn, park_offsets,
                      self_collision_deltas)
from .surface_collide import surface_collision_deltas, suggested_cell_size


def build_sliced_stages(topology, params, *, rest_rows, dead,
                        tris_rows=None, device=None):
    """Own-slice stage closures for one sharded step.

    rest_rows : (vpad, 3) rest positions in the STAGE layout (parks not
                yet added; dead rows may hold anything).
    dead      : (vpad,) bool -- rows that are padding / layout gaps.
    tris_rows : (T, 3) surface-triangle corner ids in the stage layout
                (None => the original ``topology.surface_tris``).

    Returns ``(self_fn, surf_fn, iso)``:

    - ``self_fn(p_parked, w_full, radius, off, count) -> (count, 3)``
      own-slice separation deltas (None if self collision is off),
    - ``surf_fn(p_parked, w_full, off, count) -> (vertex_deltas,
      corner_reactions)`` with corner_reactions (vpad, 3) to be summed
      over the ranks by the caller (None if surface collision is off or
      the mesh has no surface),
    - ``iso`` (vpad, 3) f32 park-offset table to add to gathered positions
      before either stage (zeros when both stages are off).

    Capacity and cell autosizing follow the single-device builders: the
    self-collision cap sizes off the PARKED rest rows in this layout, the
    surface cell off the original rest mesh (a layout-independent
    scalar)."""
    vpad = len(rest_rows)
    radius = max(1e-6, params.particle_radius)
    want_self = bool(params.self_collision)
    want_surf = bool(params.surface_collision
                     and len(topology.surface_tris))
    if not (want_self or want_surf):
        return None, None, np.zeros((vpad, 3), np.float32)

    cell = (float(params.self_collision_cell) if want_self
            else max(float(params.surface_thickness), 2.0 * radius))
    iso = park_offsets(dead, cell, radius, float(params.surface_thickness))

    self_fn = None
    if want_self:
        parked_rest = np.asarray(rest_rows, np.float32) + iso
        cap = make_self_collision_fn(params, parked_rest,
                                     num_particles=vpad).max_per_cell
        sc_cell = float(params.self_collision_cell)

        def self_fn(p_parked, w_full, radius_, off, count):
            return self_collision_deltas(
                p_parked, w_full, radius_, sc_cell, cap,
                own_offset=off, own_count=count)

    surf_fn = None
    if want_surf:
        sparams = params
        if params.surface_collision_cell <= 0.0:
            sparams = params.replace(surface_collision_cell=(
                suggested_cell_size(topology.vertices,
                                    topology.surface_tris,
                                    params.surface_thickness)))
        tris = torch.as_tensor(np.asarray(
            topology.surface_tris if tris_rows is None else tris_rows,
            np.int64).reshape(-1, 3)).to(device)
        s_cell = float(sparams.surface_collision_cell)
        s_cap = int(sparams.surface_collision_max_per_cell)
        s_h = float(sparams.surface_thickness)

        def surf_fn(p_parked, w_full, off, count):
            return surface_collision_deltas(
                p_parked, w_full, tris, s_h, s_cell, s_cap,
                own_offset=off, own_count=count)

    return self_fn, surf_fn, iso
