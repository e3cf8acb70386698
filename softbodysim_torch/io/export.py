"""Position export: OBJ frames and NPZ rollouts.

The counterpart of ``softbodysim_tpu/io/export.py``, writing the same
text and the same arrays; positions may be tensors on any device.
  - write_obj / ObjSequenceWriter: surface-mesh frames for any DCC viewer;
  - save_rollout / load_rollout: a (steps, V, 3) trajectory for datagen.
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def write_obj(path: str, positions, triangles=None, normals=None):
    positions = _host(positions).reshape(-1, 3)
    with open(path, "w", encoding="utf-8") as f:
        for p in positions:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        if normals is not None:
            for n in _host(normals).reshape(-1, 3):
                f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        if triangles is not None:
            for t in _host(triangles).reshape(-1, 3):
                a, b, c = int(t[0]) + 1, int(t[1]) + 1, int(t[2]) + 1
                if normals is not None:
                    f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
                else:
                    f.write(f"f {a} {b} {c}\n")


class ObjSequenceWriter:
    """Writes frame_0000.obj, frame_0001.obj, ... under a directory."""

    def __init__(self, directory: str, triangles=None,
                 prefix: str = "frame"):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.triangles = triangles
        self.prefix = prefix
        self.frame = 0

    def append(self, positions, normals=None) -> str:
        path = os.path.join(
            self.directory, f"{self.prefix}_{self.frame:04d}.obj")
        write_obj(path, positions, self.triangles, normals)
        self.frame += 1
        return path


def save_rollout(path: str, frames: Iterable, **extra):
    """Stack frames into (steps, V, 3) and save with any extra arrays."""
    traj = np.stack([_host(f) for f in frames], axis=0)
    np.savez_compressed(path, positions=traj,
                        **{k: _host(v) for k, v in extra.items()})


def load_rollout(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
