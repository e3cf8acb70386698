"""Parameter files and memory accounting."""

from .config import params_from_json, params_to_json
from .trees import tree_bytes, tree_summary

__all__ = ["params_to_json", "params_from_json", "tree_bytes",
           "tree_summary"]
