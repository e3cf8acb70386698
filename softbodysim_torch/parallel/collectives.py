"""The collectives of the kernel-sharded steps, on ``torch.distributed``.

The JAX package's sharded steps run inside ``shard_map`` and call
``jax.lax.all_gather`` (untiled and ``tiled=True``), ``jax.lax.psum`` and
``jax.lax.axis_index`` over one mesh axis.  These are the same three over
the process group of a 1-D ``DeviceMesh`` whose dimension is "model"
(``parallel/sharding.py::make_mesh``): every rank calls each of them in
the same order with tensors of the same shape, as the steps do.

Transports.  NCCL takes CUDA tensors and gloo takes CPU tensors, each
directly.  gloo with CUDA tensors (several ranks sharing one card, where
NCCL refuses two ranks on one device) stages each tensor through a pinned
host buffer: a synchronous copy to the host, the collective there, a copy
back.  ``Axis.transport`` names the one a call takes, and
``Axis.host_seconds`` sums the host clock spent inside collectives.

``psum`` is an all-gather and a sum in rank order, so every rank gets the
same bits on every run, whatever order the backend would reduce in.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


class Axis:
    """The process group of a 1-D mesh's dimension "model"
    (``make_mesh``): ``size`` ranks, this process the ``index``-th
    (``axis_index``)."""

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names or ())
        if names != ("model",):
            raise ValueError("the kernel-sharded steps take a 1-D mesh whose "
                             "dimension is named 'model' (parallel."
                             f"make_mesh); this mesh's dimensions: {names}")
        self.group = mesh.get_group("model")
        self.size = mesh.size(0)
        self.index = mesh.get_local_rank("model")
        self.backend = str(dist.get_backend(self.group))
        self.host_seconds = 0.0
        self._pinned = {}

    def transport(self, t: torch.Tensor) -> str:
        if self.backend == "gloo" and t.is_cuda:
            return "gloo, staged through pinned host memory"
        return self.backend

    def _host(self, t: torch.Tensor, slot) -> torch.Tensor:
        """A pinned host copy of ``t`` in a buffer kept per slot."""
        key = (slot, t.shape, t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(t.shape, dtype=t.dtype,
                                                  pin_memory=True)
        buf.copy_(t)
        return buf

    def all_gather(self, x: torch.Tensor, tiled: bool = False,
                   dim: int = 0) -> torch.Tensor:
        """Every rank's ``x``, rank-major: stacked on a new leading axis
        (``jax.lax.all_gather``), or with ``tiled`` concatenated along
        ``dim`` (``tiled=True``)."""
        t0 = time.perf_counter()
        x = x.contiguous()
        staged = self.backend == "gloo" and x.is_cuda
        src = self._host(x, "in") if staged else x
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        res = torch.cat(out, dim) if tiled else torch.stack(out)
        if staged:
            res = res.to(x.device)
        self.host_seconds += time.perf_counter() - t0
        return res

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``, added in rank order
        (``jax.lax.psum``)."""
        parts = self.all_gather(x)
        out = parts[0]
        for r in range(1, self.size):
            out = out + parts[r]
        return out

    def axis_index(self) -> int:
        """This rank's index along the axis (``jax.lax.axis_index``)."""
        return self.index
