"""UV transfer from a source render mesh to sim-mesh vertices.

Reference semantics (SoftBodySolver.ApplySourceMeshAttributes,
SoftBodySolver.cs:1021-1072): when the tetrahedralized vertex set differs
from the render mesh's, UVs carry over by quantized-position matching
(positions rounded at 1e-5 resolution; first writer wins on collisions).
Unmatched vertices get (0, 0), as in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_QUANT = 100000.0  # same 1e-5 resolution as QuantKey (SoftBodySolver.cs:1059)


def _keys(positions: np.ndarray) -> np.ndarray:
    q = np.round(np.asarray(positions, np.float64) * _QUANT).astype(np.int64)
    return q


def transfer_uvs(src_positions: np.ndarray, src_uvs: np.ndarray,
                 dst_positions: np.ndarray) -> np.ndarray:
    """Map (S,2) UVs at (S,3) source positions onto (V,3) dst positions.

    Exact-count fast path (same vertex set, same order) copies directly,
    like the reference's src.vertexCount == n branch."""
    src_positions = np.asarray(src_positions, np.float32).reshape(-1, 3)
    src_uvs = np.asarray(src_uvs, np.float32).reshape(-1, 2)
    dst_positions = np.asarray(dst_positions, np.float32).reshape(-1, 3)

    if (len(src_positions) == len(dst_positions)
            and np.array_equal(src_positions, dst_positions)):
        return src_uvs.copy()

    table = {}
    for key, uv in zip(map(tuple, _keys(src_positions)), src_uvs):
        table.setdefault(key, uv)   # first writer wins (reference behavior)

    out = np.zeros((len(dst_positions), 2), np.float32)
    matched = 0
    for i, key in enumerate(map(tuple, _keys(dst_positions))):
        uv = table.get(key)
        if uv is not None:
            out[i] = uv
            matched += 1
    if matched < 0.5 * len(dst_positions):
        # Voxel-tetrahedralized meshes share no vertices with the source
        # surface, so exact-position matching yields zeros.  Warn loudly; callers wanting textured output should use
        # transfer_uvs_nearest / render.embedding (skinned render surface).
        import warnings
        warnings.warn(
            f"transfer_uvs: only {matched}/{len(dst_positions)} vertices "
            "matched by position; falling back to nearest-vertex UVs. For a "
            "faithful textured surface use render.embedding (skinned render "
            "mesh) instead.", RuntimeWarning, stacklevel=2)
        return transfer_uvs_nearest(src_positions, src_uvs, dst_positions)
    return out


def transfer_uvs_nearest(src_positions: np.ndarray, src_uvs: np.ndarray,
                         dst_positions: np.ndarray,
                         chunk: int = 4096) -> np.ndarray:
    """Nearest-source-vertex UV transfer (the fallback when positions don't
    quantize-match, e.g. voxel-tetrahedralized sim meshes)."""
    src_positions = np.asarray(src_positions, np.float32).reshape(-1, 3)
    src_uvs = np.asarray(src_uvs, np.float32).reshape(-1, 2)
    dst_positions = np.asarray(dst_positions, np.float32).reshape(-1, 3)
    out = np.zeros((len(dst_positions), 2), np.float32)
    for s in range(0, len(dst_positions), chunk):
        d = dst_positions[s:s + chunk]
        d2 = ((d[:, None, :] - src_positions[None]) ** 2).sum(-1)
        out[s:s + chunk] = src_uvs[d2.argmin(axis=1)]
    return out


def write_obj_with_uvs(path: str, positions: np.ndarray,
                       triangles: np.ndarray, uvs: np.ndarray,
                       normals: Optional[np.ndarray] = None):
    """OBJ with per-vertex vt (and optional vn) records."""
    positions = np.asarray(positions).reshape(-1, 3)
    uvs = np.asarray(uvs).reshape(-1, 2)
    with open(path, "w", encoding="utf-8") as f:
        for p in positions:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for t in uvs:
            f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        if normals is not None:
            for n in np.asarray(normals).reshape(-1, 3):
                f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        for tri in np.asarray(triangles).reshape(-1, 3):
            a, b, c = (int(x) + 1 for x in tri)
            if normals is not None:
                f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
            else:
                f.write(f"f {a}/{a} {b}/{b} {c}/{c}\n")
