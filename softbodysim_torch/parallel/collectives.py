"""The collectives of the sharded steps, on ``torch.distributed``.

The JAX package's sharded steps run inside ``shard_map`` and call
``jax.lax.all_gather`` (untiled and ``tiled=True``), ``jax.lax.psum``,
``jax.lax.ppermute`` and ``jax.lax.axis_index`` over one named axis of a
mesh.  ``Axis(mesh, name)`` is that axis here: the process group of the
named dimension of a 1-D or 2-D ``DeviceMesh``
(``parallel/sharding.py::make_mesh``), on which every rank calls each
collective in the same order with tensors of the same shape, as the steps
do.

Transports.  NCCL takes CUDA tensors and gloo takes CPU tensors, each
directly.  gloo with CUDA tensors (several ranks sharing one card, where
NCCL refuses two ranks on one device) stages each tensor through a pinned
host buffer: a synchronous copy to the host, the collective there, a copy
back.  ``Axis.transport`` names the one a call takes, ``Axis.host_seconds``
sums the host clock spent inside collectives and ``Axis.calls`` counts
them.  An axis of one rank calls no collective.

``psum`` is an all-gather and a sum in rank order, so every rank gets the
same bits on every run, whatever order the backend would reduce in.
``exchange`` (a halo's two ``jax.lax.ppermute`` shifts, to the +-1
neighbours) is one batch of paired ``isend`` / ``irecv``: blocking sends
in a ring would deadlock on gloo.

Gradients.  ``psum``, ``all_gather`` and ``exchange`` carry one through
``torch.autograd``; the plain ``torch.distributed`` calls do not.  A value
is either *replicated* (the same on every rank of the axis: what ``psum``
and ``all_gather`` return, the public state, the material overrides) or
*varying* (each rank's own: its rows, its constraint share).  The
downstream of a replicated value computes the same loss on every rank, so
its cotangent is replicated too: the backward of ``psum`` passes the
cotangent on unchanged, that of ``all_gather`` takes the rank's own chunk
of it (another sum would scale the gradient by the axis size).  Where a
replicated value enters a rank's own computation the step marks it with
``varying`` (the identity; its backward sums the ranks' cotangents with
``psum``): the gradient of a replicated input is the sum of every rank's
share.  ``exchange``'s backward sends the cotangents back.  Each backward sum
is in rank order, so every rank gets the same gradient bits.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


class Axis:
    """The process group of dimension ``name`` of ``mesh`` (``make_mesh``):
    ``size`` ranks, this process the ``index``-th (``axis_index``)."""

    def __init__(self, mesh, name: str = "model"):
        names = tuple(mesh.mesh_dim_names or ())
        if name not in names:
            raise ValueError(f"the mesh has no dimension {name!r} (parallel."
                             f"make_mesh); its dimensions: {names}")
        self.name = name
        self.group = mesh.get_group(name)
        self.size = mesh.size(names.index(name))
        self.index = mesh.get_local_rank(name)
        self.backend = str(dist.get_backend(self.group))
        self._peers = dist.get_process_group_ranks(self.group)
        self.host_seconds = 0.0
        self.calls = 0
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

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    # ---- the collectives, without a gradient -----------------------------

    def _all_gather(self, x: torch.Tensor, tiled: bool,
                    dim: int) -> torch.Tensor:
        if self.size == 1:
            return x.clone() if tiled else x.unsqueeze(0).clone()
        t0 = time.perf_counter()
        x = x.contiguous()
        staged = self._staged(x)
        src = self._host(x, "in") if staged else x
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        res = torch.cat(out, dim) if tiled else torch.stack(out)
        if staged:
            res = res.to(x.device)
        self.calls += 1
        self.host_seconds += time.perf_counter() - t0
        return res

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x.clone()
        parts = self._all_gather(x, False, 0)
        out = parts[0]
        for r in range(1, self.size):
            out = out + parts[r]
        return out

    def _p2p(self, sends, recv_like) -> list:
        """One batch of paired ``isend`` / ``irecv``: ``sends`` [(tensor,
        axis index)], ``recv_like`` [(tensor of the received shape, axis
        index)]; returns the received tensors, in order."""
        t0 = time.perf_counter()
        ops, outs, back = [], [], []
        for t, peer in sends:
            t = t.contiguous()
            src = self._host(t, ("send", peer)) if self._staged(t) else t
            ops.append(dist.P2POp(dist.isend, src, self._peers[peer],
                                  group=self.group))
        for t, peer in recv_like:
            staged = self._staged(t)
            out = torch.empty(t.shape, dtype=t.dtype,
                              device="cpu" if staged else t.device,
                              pin_memory=staged)
            ops.append(dist.P2POp(dist.irecv, out, self._peers[peer],
                                  group=self.group))
            outs.append(out)
            back.append(t.device)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.calls += 1
        self.host_seconds += time.perf_counter() - t0
        return [o.to(d) for o, d in zip(outs, back)]

    def _exchange(self, up: torch.Tensor, dn: torch.Tensor) -> tuple:
        """``up`` to the next rank, ``dn`` to the previous one, in one
        batch: (the previous rank's ``up``, the next rank's ``dn``), zeros
        where there is no such rank."""
        i, n = self.index, self.size
        sends = ([(up, i + 1)] if i + 1 < n else []) + (
            [(dn, i - 1)] if i >= 1 else [])
        recvs = ([(up, i - 1)] if i >= 1 else []) + (
            [(dn, i + 1)] if i + 1 < n else [])
        got = iter(self._p2p(sends, recvs) if sends or recvs else [])
        below = next(got) if i >= 1 else torch.zeros_like(up)
        above = next(got) if i + 1 < n else torch.zeros_like(dn)
        return below, above

    # ---- the public forms, with a gradient -------------------------------

    def all_gather(self, x: torch.Tensor, tiled: bool = False,
                   dim: int = 0) -> torch.Tensor:
        """Every rank's ``x``, rank-major: stacked on a new leading axis
        (``jax.lax.all_gather``), or with ``tiled`` concatenated along
        ``dim`` (``tiled=True``); replicated."""
        if x.requires_grad and torch.is_grad_enabled():
            return _AllGather.apply(self, x, tiled, dim)
        return self._all_gather(x, tiled, dim)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``, added in rank order
        (``jax.lax.psum``); replicated."""
        if x.requires_grad and torch.is_grad_enabled():
            return _PSum.apply(self, x)
        return self._psum(x)

    def exchange(self, up: torch.Tensor, dn: torch.Tensor) -> tuple:
        """The two ``jax.lax.ppermute`` shifts of a halo in one batch:
        ``up`` goes to the next rank, ``dn`` to the previous one; returns
        (the previous rank's ``up``, the next rank's ``dn``), zeros where
        there is no such rank."""
        if (up.requires_grad or dn.requires_grad) and torch.is_grad_enabled():
            return _Exchange.apply(self, up, dn)
        return self._exchange(up, dn)

    def varying(self, x):
        """``x``, a replicated value, entering this rank's own computation:
        the identity, whose backward sums the ranks' cotangents (module
        docstring).  Floats and tensors without a gradient pass through."""
        if isinstance(x, torch.Tensor) and x.requires_grad \
                and torch.is_grad_enabled() and self.size > 1:
            return _Varying.apply(self, x)
        return x

    def axis_index(self) -> int:
        """This rank's index along the axis (``jax.lax.axis_index``)."""
        return self.index


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x, tiled, dim):
        ctx.axis, ctx.tiled, ctx.dim, ctx.n = axis, tiled, dim, x.shape[dim]
        return axis._all_gather(x, tiled, dim)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.axis
        own = (g.narrow(ctx.dim, ax.index * ctx.n, ctx.n) if ctx.tiled
               else g[ax.index])
        return None, own.contiguous(), None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        return axis._psum(x)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, up, dn):
        ctx.axis = axis
        return axis._exchange(up, dn)

    @staticmethod
    def backward(ctx, g_below, g_above):
        # the previous rank's up came from below: its cotangent goes back
        # down, the next rank's dn back up
        to_dn, to_up = ctx.axis._exchange(g_above, g_below)
        return None, to_up, to_dn


class _Varying(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.axis._psum(g)
