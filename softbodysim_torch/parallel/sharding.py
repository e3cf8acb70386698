"""Many ranks of a ``torch.distributed`` process group: a mesh, the data,
constraint and vertex sharding of the JAX package, and the kernel-sharded
steps.

The counterpart of ``softbodysim_tpu/parallel/sharding.py``:

* ``make_mesh`` (:39) -- a 1-D ``DeviceMesh`` named "model" (the default),
  or any 1-D or 2-D shape with named dimensions, e.g. ``shape=(d, m),
  axis_names=("data", "model")`` (the JAX package's ``jax.sharding.Mesh``);
* ``shard_batch`` (:51) / ``gather_batch`` -- a batched state's scenes
  split over "data" into each rank's contiguous block, and back;
* ``make_data_parallel_step`` (:1408) -- each rank steps its own block of
  scenes with ``parallel/batching.py::make_batched_step``: no collective;
* ``make_mesh_sharded_step`` (:91) / ``make_xpbd_sharded_step`` (:226) --
  scenes over "data", each scene's constraints over "model"
  (``parallel/constraint.py``);
* ``make_vertex_sharded_step`` (:544) / ``make_xpbd_vertex_sharded_step``
  (:962) -- one scene's state split by vertex over "model"
  (``parallel/vertex.py``);
* ``make_sharded_step`` (:1429) -- the ``Engine(mesh=...)`` entry point:
  the kernel-sharded steps (``solver/xpbd_sweep_sharded.py``,
  ``solver/jacobi_pass_sharded.py``) when the dialect's backend is forced
  to its kernels or 'auto' finds a big scene on a CUDA device, the
  vertex-sharded steps otherwise;
* ``spawn`` -- start ``world`` processes joined by one process group (the
  tests' gloo groups on the CPU, several ranks sharing one card), their
  rendezvous a file store in a temporary directory.

Every rank builds the same step from the same arguments and calls it the
same way; a step over the public state gives each rank the same public
state back.  A process group is set up by the caller, with
``torch.distributed.init_process_group(backend, init_method=...,
world_size=..., rank=...)`` (a ``file://`` store in a temporary directory
for the processes of one host, or ``tcp://<host>:<port>``): NCCL for one
rank per card, gloo on the CPU or for several ranks on one card (NCCL
refuses two ranks on one device; ``parallel/collectives.py`` stages
gloo's CUDA tensors through pinned host buffers).
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..core.state import SimState, resolve_device
from ..solver.select import SWEEP_MIN_CONSTRAINTS
from .batching import _FIELDS
from .collectives import Axis


def make_mesh(group=None, device_type: str = None, *, shape=None,
              axis_names=("model",)):
    """A ``DeviceMesh`` over the ranks of ``group`` (default: the default
    process group), its dimensions named ``axis_names``: by default 1-D,
    "model", every rank on it; ``shape`` (a tuple whose product is the
    group's size, one entry per name) lays the ranks out row-major, e.g.
    ``shape=(d, m), axis_names=("data", "model")``.  Every rank must call
    it with the same arguments: it creates each dimension's sub-groups,
    all of them on every rank, in one order.  ``device_type`` 'cuda' or
    'cpu' (default: 'cuda' on an NCCL group, else 'cpu'; pass 'cuda' for
    a gloo group whose ranks step on a card)."""
    import numpy as np
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    group = dist.group.WORLD if group is None else group
    if device_type is None:
        device_type = ("cuda" if str(dist.get_backend(group)) == "nccl"
                       else "cpu")
    names = tuple(axis_names)
    ranks = dist.get_process_group_ranks(group)
    shape = (len(ranks),) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"shape {shape} and axis_names {names} must have "
                         "one distinct name per dimension")
    if int(np.prod(shape)) != len(ranks):
        raise ValueError(f"shape {shape} does not hold the group's "
                         f"{len(ranks)} ranks")
    if len(shape) == 1:
        return DeviceMesh.from_group(group, device_type,
                                     mesh_dim_names=names)
    if len(shape) != 2:
        raise ValueError("make_mesh builds 1-D and 2-D meshes")
    grid = np.asarray(ranks).reshape(shape)
    me = dist.get_rank()
    mine = []
    # dimension 0's groups are the columns, dimension 1's the rows; every
    # rank creates every group, in this order
    for lines in (grid.T, grid):
        own = None
        for line in lines:
            g = dist.new_group([int(r) for r in line],
                               backend=str(dist.get_backend(group)))
            if me in line:
                own = g
        mine.append(own)
    return DeviceMesh.from_group(mine, device_type,
                                 mesh=torch.as_tensor(grid),
                                 mesh_dim_names=names)


def _block(n: int, ax: Axis) -> slice:
    if n % ax.size:
        raise ValueError(f"a batch of {n} scenes does not split into "
                         f"{ax.size} equal blocks over '{ax.name}'")
    b = n // ax.size
    return slice(ax.index * b, (ax.index + 1) * b)


def shard_batch(state: SimState, mesh, axis: str = "data") -> SimState:
    """This rank's contiguous block of a batched state's scenes (every
    field's leading axis cut into ``mesh``'s ``axis`` size equal blocks;
    ValueError if it does not divide).  The whole batch is the same on
    every rank; the block carries its gradient back to it (the sum over
    the ranks, ``Axis.varying``)."""
    ax = Axis(mesh, axis)
    sl = _block(int(state.x.shape[0]), ax)
    return SimState(**{f: ax.varying(getattr(state, f))[sl]
                       for f in _FIELDS})


def gather_batch(state: SimState, mesh, axis: str = "data") -> SimState:
    """Every rank's block back into the whole batch, the same on every
    rank (``shard_batch``'s inverse: an all-gather over ``axis``)."""
    ax = Axis(mesh, axis)
    return SimState(**{f: ax.all_gather(getattr(state, f), tiled=True)
                       for f in _FIELDS})


def make_data_parallel_step(topology, params, mesh, colliders=None,
                            axis: str = "data", *, device=None):
    """Scene-batch data parallelism (the JAX package's :1408-1426):
    ``step(block, dt, *stiffness) -> block`` steps this rank's block of
    scenes (``shard_batch``) with ``parallel/batching.py::
    make_batched_step``.  Scenes never talk to each other, so the step
    calls no collective."""
    from .batching import make_batched_step

    Axis(mesh, axis)                      # the mesh must have the axis
    return make_batched_step(topology, params, colliders=colliders,
                             device=device)


def make_mesh_sharded_step(topology, params, mesh, colliders=None,
                           data_axis: str = "data",
                           model_axis: str = "model", *, device=None):
    """The jacobi dialect over a (data, model) mesh: ``parallel/
    constraint.py::MeshShardedJacobiStep``."""
    from .constraint import MeshShardedJacobiStep

    return MeshShardedJacobiStep(topology, params, mesh, colliders,
                                 data_axis, model_axis, device=device)


def make_xpbd_sharded_step(topology, params, mesh, colliders=None,
                           data_axis: str = "data",
                           model_axis: str = "model", *, device=None):
    """The xpbd dialect over a (data, model) mesh: ``parallel/
    constraint.py::XpbdShardedStep``."""
    from .constraint import XpbdShardedStep

    return XpbdShardedStep(topology, params, mesh, colliders, data_axis,
                           model_axis, device=device)


def make_vertex_sharded_step(topology, params, mesh, axis: str = "model",
                             colliders=None, halo: str = "auto", *,
                             device=None):
    """The jacobi dialect with one scene's state split by vertex:
    ``parallel/vertex.py::VertexShardedStep``."""
    from .vertex import VertexShardedStep

    return VertexShardedStep(topology, params, mesh, axis, colliders, halo,
                             device=device)


def make_xpbd_vertex_sharded_step(topology, params, mesh,
                                  axis: str = "model", colliders=None, *,
                                  device=None):
    """The xpbd dialect with one scene's state split by vertex:
    ``parallel/vertex.py::XpbdVertexShardedStep``."""
    from .vertex import XpbdVertexShardedStep

    return XpbdVertexShardedStep(topology, params, mesh, axis, colliders,
                                 device=device)


def make_sharded_step(topology, params, mesh, colliders=None, *,
                      axis: str = "model", device=None):
    """``step(state, dt) -> state`` for one scene over ``mesh``'s ``axis``
    (the JAX package's dispatch, :1429-1500), with the carry API of
    ``Engine``: the kernel-sharded steps when the dialect's backend is
    forced to its kernels ('sweep' / 'pass', or their alias 'pallas'), or
    when 'auto' finds at least 100k constraints on a CUDA device; the
    vertex-sharded steps otherwise."""
    big = (topology.num_edges + topology.num_tets) >= SWEEP_MIN_CONSTRAINTS
    on_card = resolve_device(device).type == "cuda"
    if params.dialect == "xpbd":
        backend = {"pallas": "sweep"}.get(params.xpbd_backend,
                                          params.xpbd_backend)
        if backend == "auto":
            backend = "sweep" if big and on_card else "gather"
        if backend == "sweep":
            from ..solver.xpbd_sweep_sharded import (
                make_xpbd_sweep_sharded_step)

            return make_xpbd_sweep_sharded_step(topology, params, mesh,
                                                colliders=colliders,
                                                device=device)
        return make_xpbd_vertex_sharded_step(topology, params, mesh, axis,
                                             colliders, device=device)
    if params.dialect == "jacobi":
        backend = {"pallas": "pass"}.get(params.jacobi_backend,
                                         params.jacobi_backend)
        if backend == "auto":
            backend = "pass" if big and on_card else "gather"
        if backend == "pass":
            from ..solver.jacobi_pass_sharded import (
                make_jacobi_pass_sharded_step)

            return make_jacobi_pass_sharded_step(topology, params, mesh,
                                                 colliders=colliders,
                                                 device=device)
        from .vertex import PublicVertexStep

        return PublicVertexStep(make_vertex_sharded_step(
            topology, params, mesh, axis, colliders, device=device))
    raise ValueError(f"unknown dialect {params.dialect!r}")


def _rank_main(rank, world, backend, store, timeout_s, fn, args, results):
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, *args, backend: str = "gloo",
          timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (the
    'spawn' start method), joined by one process group of ``backend`` on
    this host; returns each rank's return value, in rank order.  ``fn``
    must be importable by name from a module that the new processes can
    import.  Raises, with the rank's traceback, if a rank fails; a rank
    that does not answer within ``timeout_s`` seconds is killed (a
    collective left waiting times out after as long)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world, backend, os.path.join(tmp, "store"), timeout_s, fn,
            args, results)) for r in range(world)]
        for p in procs:
            p.start()
        return _collect(procs, results, world, timeout_s)


def _collect(procs, results, world: int, timeout_s: float) -> list:
    """Each rank's answer, in rank order; kills the ranks if one fails or
    does not answer in time."""
    out, failed = {}, None
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world and failed is None:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive()]
                if dead:        # gone without an answer (a second look:
                    try:        # its answer may be in flight)
                        rank, ok, val = results.get(timeout=5.0)
                    except queue_mod.Empty:
                        failed = (f"rank {dead[0]} of {world} exited with "
                                  f"code {procs[dead[0]].exitcode} without "
                                  "an answer")
                        break
                elif time.monotonic() > deadline:
                    failed = (f"no answer from ranks "
                              f"{sorted(set(range(world)) - set(out))} in "
                              f"{timeout_s:.0f} s")
                    break
                else:
                    continue
            if ok:
                out[rank] = val
            else:
                failed = f"rank {rank} of {world} failed:\n{val}"
    finally:
        for p in procs:
            if failed is not None and p.is_alive():
                p.kill()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failed is not None:
        raise RuntimeError(failed)
    return [out[r] for r in range(world)]
