"""Area-weighted vertex normals -- the K_UpdateNormals equivalent.

Reference (Assets/Shaders/SoftBodyCompute.compute:459-491): per vertex, sum
the *unnormalized* cross products of its incident surface triangles (area
weighting falls out of the cross product), normalize with rsqrt, fall back to
(0,1,0) when the accumulated normal is degenerate (n^2 < 1e-20).

Here: one cross product per triangle, then ``index_add_`` into the three
corners -- no CSR adjacency needed.  On a CUDA device ``index_add_`` sums
in no fixed order, so the card's normals match the CPU's to a tolerance,
not bit for bit.
"""

from __future__ import annotations

import torch

from ..core.state import resolve_device


def vertex_normals(positions: torch.Tensor, surface_tris: torch.Tensor,
                   num_vertices=None) -> torch.Tensor:
    """positions (V, 3) f32; surface_tris (S, 3) int -> (V, 3) unit
    normals, on the positions' device."""
    nv = num_vertices if num_vertices is not None else positions.shape[0]
    if surface_tris.shape[0] == 0:
        up = torch.zeros((nv, 3), dtype=positions.dtype,
                         device=positions.device)
        up[:, 1] = 1.0
        return up

    tris = surface_tris.long()
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    pa, pb, pc = positions[a], positions[b], positions[c]
    face_n = torch.linalg.cross(pb - pa, pc - pa)  # area-weighted

    # one sum per corner role, then added, as the JAX function does
    zeros = torch.zeros((nv, 3), dtype=positions.dtype,
                        device=positions.device)
    summed = zeros.index_add(0, a, face_n)
    summed += zeros.index_add(0, b, face_n)
    summed += zeros.index_add(0, c, face_n)

    n2 = (summed * summed).sum(-1, keepdim=True)
    unit = summed * torch.rsqrt(n2.clamp_min(1e-30))
    fallback = torch.tensor([0.0, 1.0, 0.0], dtype=positions.dtype,
                            device=positions.device).expand_as(unit)
    return torch.where(n2 < 1e-20, fallback, unit)


def make_normals_fn(topology, device=None):
    """Bind a topology; returns positions -> normals (the surface table
    lives on ``device``, default the card)."""
    tris = torch.as_tensor(topology.surface_tris, dtype=torch.int64).to(
        resolve_device(device))
    nv = topology.num_particles

    def fn(positions):
        return vertex_normals(positions, tris, nv)

    return fn
