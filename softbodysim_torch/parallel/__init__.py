"""Many scenes per step: batched copies of one body, grouped mesh
families and heterogeneous padded batches; and the ranks of a
``torch.distributed`` process group (``sharding``): ``make_mesh``, scenes
over a "data" axis (``shard_batch``, ``make_data_parallel_step``), their
constraints over a "model" axis (``make_mesh_sharded_step``,
``make_xpbd_sharded_step``), one scene's state split by vertex
(``make_vertex_sharded_step``, ``make_xpbd_vertex_sharded_step``), and
``make_sharded_step`` behind ``Engine(mesh=...)``."""

from .batching import (BatchedEngine, init_batch_state, make_batched_step,
                       sample_stiffness)
from .collectives import Axis
from .groups import Group, GroupedSceneEngine
from .hetero import HeteroBatch, HeteroEngine, make_hetero_step
from .sharding import (gather_batch, make_data_parallel_step, make_mesh,
                       make_mesh_sharded_step, make_sharded_step,
                       make_vertex_sharded_step, make_xpbd_sharded_step,
                       make_xpbd_vertex_sharded_step, shard_batch, spawn)

__all__ = [
    "BatchedEngine", "init_batch_state", "make_batched_step",
    "sample_stiffness", "Group", "GroupedSceneEngine", "HeteroBatch",
    "HeteroEngine", "make_hetero_step", "Axis", "make_mesh",
    "make_sharded_step", "spawn", "shard_batch", "gather_batch",
    "make_data_parallel_step", "make_mesh_sharded_step",
    "make_xpbd_sharded_step", "make_vertex_sharded_step",
    "make_xpbd_vertex_sharded_step",
]
