"""Memory accounting over nested state: tensors and arrays inside
NamedTuple carries, dataclasses (SimState), dicts, lists and tuples.

The counterpart of ``softbodysim_tpu/utils/trees.py``; its paths read as
JAX's key paths do (``.field``, ``[i]``, ``['key']``), a dataclass's fields
named like a NamedTuple's.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def leaves(tree, path=""):
    """(path, leaf) pairs in field / key / index order; None is empty."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from leaves(getattr(tree, name), f"{path}.{name}")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _nbytes(leaf) -> int:
    if hasattr(leaf, "element_size"):                   # a torch tensor
        return int(leaf.numel() * leaf.element_size())
    return int(np.prod(leaf.shape) * leaf.dtype.itemsize)


def tree_bytes(tree) -> int:
    return sum(_nbytes(leaf) for _, leaf in leaves(tree)
               if hasattr(leaf, "shape"))


def tree_summary(tree) -> str:
    lines = []
    for name, leaf in leaves(tree):
        if hasattr(leaf, "shape"):
            dtype = str(leaf.dtype).replace("torch.", "")
            lines.append(f"{name}: {dtype} {tuple(leaf.shape)}")
        else:
            lines.append(f"{name}: {leaf!r}")
    lines.append(f"total: {tree_bytes(tree) / 1e6:.2f} MB")
    return "\n".join(lines)
