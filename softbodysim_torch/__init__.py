"""softbodysim_torch -- the PyTorch / CUDA port of softbodysim_tpu.

The XPBD dialect on one large scene, on hand-written CUDA sweep kernels for
an NVIDIA Hopper GPU (kernels/csrc/sweep.cu), with the same host plans,
block order and API as the JAX package::

    import softbodysim_torch as sbt

    topo = sbt.meshes.tet_cube(47, 47, 47, size=1.0, center=(0, 2, 0))
    eng = sbt.Engine(topo, sbt.SolverParams(substeps=8, iterations=1),
                     device="cuda")
    eng.run(32)
    pos = eng.positions()

On a CPU device the kernels' plain PyTorch versions run instead (tests).
"""

from .core.state import SimState, SolverParams, init_state
from .core.topology import Topology, build_topology
from .core import meshes
from .solver import make_step
from .api.engine import Engine

__version__ = "0.1.0"

__all__ = [
    "SimState", "SolverParams", "init_state", "Topology", "build_topology",
    "meshes", "make_step", "Engine",
]
