"""softbodysim_torch -- the PyTorch / CUDA port of softbodysim_tpu.

Two solver dialects on one scene, on hand-written CUDA kernels for an
NVIDIA Hopper GPU (kernels/csrc/*.cu), with the API of the JAX package:
the XPBD dialect on the block-synchronous sweep kernels (the JAX package's
host plans and block order, super-blocks or the legacy 128-wide blocks) or,
for small scenes, coloured Gauss-Seidel, and the Jacobi dialect (the
in-engine contract) on the Jacobi pass kernels; colliders on both, through
the fused collide kernel::

    import softbodysim_torch as sbt

    topo = sbt.meshes.tet_cube(47, 47, 47, size=1.0, center=(0, 2, 0))
    eng = sbt.Engine(topo, sbt.SolverParams(substeps=8, iterations=1),
                     device="cuda")
    eng.run(32)
    pos = eng.positions()

    jac = sbt.Engine(topo, sbt.SolverParams(dialect="jacobi"),
                     colliders=sbt.Colliders.build(
                         [sbt.Colliders.box((0, 0.1, 0), (1.5, 0.1, 1.5))]))

Contact on every step backend: ``SolverParams(self_collision=True,
surface_collision=True)`` (spatial-hash particle contact, vertex-triangle
surface contact; ``solver/contact.py``).  IO (``io``: checkpoints with
exact resume, OBJ / rollout export, topology files) and the voxel
tetrahedralizer (``core/tetrahedralize.py``) read and write the JAX
package's formats.

Multi-body scenes: ``World`` (one Engine per body), ``Scene`` and its
presets (``api/scenes.py``: per-body, grouped, merged into one mesh, or
partitioned into the fewest merged programs), ``DynamicMergedWorld``
(bodies added and removed mid-run), and ``parallel`` (batched copies of
one body, grouped families, heterogeneous padded batches).

Differentiable simulation (``diff``): ``diff.make_rollout``,
``make_trajectory_loss`` and ``fit`` on ``torch.autograd`` through the
plain steps' differentiable build, the collide kernel behind a
``torch.autograd.Function``::

    from softbodysim_torch import diff

    res = diff.fit(topo, sbt.SolverParams(ground_enabled=False), target,
                   dt=1 / 60, fit_params=("edge_compliance",),
                   state0=state0, device="cuda")

One scene across the ranks of a ``torch.distributed`` process group: the
kernel-sharded steps behind ``Engine(topo, params, mesh=make_mesh())``
(``parallel/sharding.py``; the sweep kernels per rank for xpbd, the Jacobi
passes' accumulate mode for jacobi).

The entry hooks (``entry.py``: ``entry()``, the flagship step, and
``dryrun_multichip(n)``, every multi-device mode on n ranks; ``python -m
softbodysim_torch.entry``) and the examples (``python -m
softbodysim_torch.examples.<name>``) drive it end to end.

Entry points run on the card (``cuda:0``) unless given ``device="cpu"``,
where the kernels' plain PyTorch versions run instead (the tests).
"""

from .collide.primitives import Colliders
from .core.state import SimState, SolverParams, init_state
from .core.topology import Topology, build_topology
from .core import meshes
from .solver import make_step
from .api.dynamic import DynamicMergedWorld
from .api.engine import Engine
from .api.scenes import PartitionedSceneEngine, Scene
from .api.world import World, Body
from .parallel.sharding import make_mesh
from . import diff

__version__ = "0.1.0"

__all__ = [
    "Colliders", "SimState", "SolverParams", "init_state", "Topology",
    "build_topology", "meshes", "make_step", "Engine", "World", "Body",
    "DynamicMergedWorld", "Scene", "PartitionedSceneEngine", "make_mesh",
    "diff",
]
