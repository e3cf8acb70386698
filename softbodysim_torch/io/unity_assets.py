"""Loader for Unity-serialized SoftBodyTetMeshAsset files.

The reference ships pre-tetrahedralized assets under
Assets/SoftBody/Generated/ (SoftBodyTetMeshAsset: vertices + tetIds +
edgeIds + surfaceTriIds, SoftBodyTetMeshAsset.cs:10-13).  Unity writes the
Vector3 list as YAML ``{x:, y:, z:}`` dicts and the int arrays as
little-endian u32 hex blobs; this parser needs no Unity and no YAML
library (the parser of ``softbodysim_tpu/io/unity_assets.py``)::

    topo = load_tet_asset("Bunny-LowPoly_Tet 1.asset")
    eng = Engine(topo, SolverParams())
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from ..core.topology import Topology, build_topology

_VEC_RE = re.compile(
    r"\{x:\s*([-\d.eE+]+),\s*y:\s*([-\d.eE+]+),\s*z:\s*([-\d.eE+]+)\}")
_BLOB_RE = re.compile(r"(tetIds|edgeIds|surfaceTriIds):\s*([0-9a-fA-F]*)")


def parse_tet_asset(path: str) -> Dict[str, np.ndarray]:
    """Raw arrays from a .asset file: vertices (V, 3) f32, tetIds (4T,),
    edgeIds (2E,), surfaceTriIds (3S,) i32."""
    verts = []
    blobs: Dict[str, str] = {}
    in_vertices = False
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            stripped = line.strip()
            if stripped.startswith("vertices:"):
                in_vertices = True
                continue
            m = _BLOB_RE.match(stripped)
            if m:
                in_vertices = False
                blobs[m.group(1)] = m.group(2)
                continue
            if in_vertices:
                vm = _VEC_RE.search(stripped)
                if stripped.startswith("-") and vm:
                    verts.append([float(g) for g in vm.groups()])
                elif not stripped.startswith("-"):
                    in_vertices = False

    out = {"vertices": np.asarray(verts, np.float32)}
    for key in ("tetIds", "edgeIds", "surfaceTriIds"):
        hexstr = blobs.get(key, "")
        out[key] = (np.frombuffer(bytes.fromhex(hexstr), "<u4")
                    .astype(np.int32) if hexstr
                    else np.zeros((0,), np.int32))
    return out


def load_tet_asset(path: str, orient: bool = False) -> Topology:
    """Asset -> Topology.  The stored edges and surface stay authoritative
    (as the in-engine solver uses them, SoftBodySolver.cs:983-997);
    orient=False keeps the stored tet winding (assets are positively
    oriented already, SoftBodyTetMeshAsset.cs:47-49)."""
    raw = parse_tet_asset(path)
    if raw["vertices"].size == 0 or raw["tetIds"].size == 0:
        raise ValueError(f"{path}: not a valid SoftBodyTetMeshAsset")
    return build_topology(
        raw["vertices"], raw["tetIds"].reshape(-1, 4),
        edges=raw["edgeIds"].reshape(-1, 2),
        surface_tris=raw["surfaceTriIds"].reshape(-1, 3), orient=orient)
