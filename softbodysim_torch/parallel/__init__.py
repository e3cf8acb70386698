"""Many scenes per step: batched copies of one body, grouped mesh
families and heterogeneous padded batches; one scene across the ranks of
a ``torch.distributed`` process group (``sharding``: ``make_mesh``,
``make_sharded_step``, behind ``Engine(mesh=...)``; the vertex-sharded and
data-parallel modes are not ported yet: ROADMAP.md queue 1,
'Multi-device')."""

from .batching import (BatchedEngine, init_batch_state, make_batched_step,
                       sample_stiffness)
from .collectives import Axis
from .groups import Group, GroupedSceneEngine
from .hetero import HeteroBatch, HeteroEngine, make_hetero_step
from .sharding import make_mesh, make_sharded_step, spawn

__all__ = [
    "BatchedEngine", "init_batch_state", "make_batched_step",
    "sample_stiffness", "Group", "GroupedSceneEngine", "HeteroBatch",
    "HeteroEngine", "make_hetero_step", "Axis", "make_mesh",
    "make_sharded_step", "spawn",
]
