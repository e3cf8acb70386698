"""Topology persistence: tetrahedralize once, load at run time.

The counterpart of ``softbodysim_tpu/io/topology_store.py``, in the same
file format (``format`` 1 and the SoA arrays; colourings and rest
quantities are rebuilt on load), so a file written by either package
loads in the other.
"""

from __future__ import annotations

import numpy as np

from ..core.topology import Topology, build_topology

FORMAT = 1


def save_topology(path: str, topo: Topology):
    np.savez_compressed(
        path,
        format=np.int32(FORMAT),
        vertices=topo.vertices,
        tets=topo.tets,
        edges=topo.edges,
        surface_tris=topo.surface_tris,
    )


def load_topology(path: str) -> Topology:
    with np.load(path) as z:
        if int(z.get("format", 1)) > FORMAT:
            raise ValueError("topology file newer than supported")
        return build_topology(
            z["vertices"], z["tets"].astype(np.int64),
            edges=z["edges"].astype(np.int64),
            surface_tris=z["surface_tris"].astype(np.int64),
            orient=False,   # stored tets are already oriented
        )
