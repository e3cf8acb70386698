"""Many scenes per step: batched copies of one body, grouped mesh
families and heterogeneous padded batches (the multi-device modes are not
ported yet: ROADMAP.md queue 1, 'Multi-device')."""

from .batching import (BatchedEngine, init_batch_state, make_batched_step,
                       sample_stiffness)
from .groups import Group, GroupedSceneEngine
from .hetero import HeteroBatch, HeteroEngine, make_hetero_step

__all__ = [
    "BatchedEngine", "init_batch_state", "make_batched_step",
    "sample_stiffness", "Group", "GroupedSceneEngine", "HeteroBatch",
    "HeteroEngine", "make_hetero_step",
]
