"""State, topology and position exchange."""

from .checkpoint import load_state, params_from_metadata, save_state
from .export import ObjSequenceWriter, load_rollout, save_rollout, write_obj
from .topology_store import load_topology, save_topology

__all__ = [
    "save_state", "load_state", "params_from_metadata",
    "write_obj", "ObjSequenceWriter", "save_rollout", "load_rollout",
    "save_topology", "load_topology",
]
