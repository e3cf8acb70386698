"""One scene across the ranks of a ``torch.distributed`` process group.

The counterpart of ``softbodysim_tpu/parallel/sharding.py``, begun with
the kernel-sharded steps:

* ``make_mesh`` (:39) -- a 1-D ``DeviceMesh`` with the dimension name
  ``"model"`` over the caller's process group (the JAX package's
  ``jax.sharding.Mesh`` axis);
* ``make_sharded_step`` (:1429) -- the ``Engine(mesh=...)`` entry point: the
  sweep kernels split across ranks for xpbd
  (``solver/xpbd_sweep_sharded.py``), the Jacobi passes' accumulate mode
  for jacobi (``solver/jacobi_pass_sharded.py``);
* ``spawn`` -- start ``world`` processes joined by one process group (the
  tests' gloo groups on the CPU, several ranks sharing one card), their
  rendezvous a file store in a temporary directory.

Every rank builds the same step from the same arguments and calls it with
the same public state; each gets the same public state back.  A process
group is set up by the caller, with ``torch.distributed.
init_process_group(backend, init_method=..., world_size=..., rank=...)``
(a ``file://`` store in a temporary directory for the processes of one
host, or ``tcp://<host>:<port>``): NCCL for one rank per card, gloo on
the CPU or for several ranks on one card (NCCL refuses two ranks on one device;
``parallel/collectives.py`` stages gloo's CUDA tensors through pinned host
buffers).

Not ported yet (ROADMAP.md queue 1, 'Multi-device'): the vertex-sharded
steps (``make_vertex_sharded_step``, ``make_xpbd_vertex_sharded_step``),
scene-batch data parallelism and the constraint-parallel modes.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch.distributed as dist

from ..core.state import resolve_device
from ..solver.select import SWEEP_MIN_CONSTRAINTS

_NOT_PORTED = ("the vertex-sharded {} step is not ported yet (ROADMAP.md "
               "queue 1, 'Multi-device'): force the kernel backend "
               "({}_backend='{}') or use a scene of at least {:,} "
               "constraints on a CUDA device")


def make_mesh(group=None, device_type: str = None):
    """A 1-D ``DeviceMesh`` whose dimension is named "model", over
    ``group`` (default: the default process group); ``device_type``
    'cuda' or 'cpu' (default: 'cuda' on an NCCL group, else 'cpu'; pass
    'cuda' for a gloo group whose ranks step on a card)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    group = dist.group.WORLD if group is None else group
    if device_type is None:
        device_type = ("cuda" if str(dist.get_backend(group)) == "nccl"
                       else "cpu")
    return DeviceMesh.from_group(group, device_type,
                                 mesh_dim_names=("model",))


def make_sharded_step(topology, params, mesh, colliders=None, *,
                      device=None):
    """``step(state, dt) -> state`` for one scene over ``mesh``
    (``make_mesh``; the JAX package's dispatch, :1429-1500): the
    kernel-sharded steps when the dialect's backend is forced to its
    kernels ('sweep' / 'pass', or their alias 'pallas'), or when 'auto'
    finds at least 100k constraints on a CUDA device; the vertex-sharded
    modes otherwise, which are not ported yet and raise
    NotImplementedError."""
    big = (topology.num_edges + topology.num_tets) >= SWEEP_MIN_CONSTRAINTS
    on_card = resolve_device(device).type == "cuda"
    if params.dialect == "xpbd":
        backend = {"pallas": "sweep"}.get(params.xpbd_backend,
                                          params.xpbd_backend)
        if backend == "auto":
            backend = "sweep" if big and on_card else "gather"
        if backend != "sweep":
            raise NotImplementedError(_NOT_PORTED.format(
                "xpbd", "xpbd", "sweep", SWEEP_MIN_CONSTRAINTS))
        from ..solver.xpbd_sweep_sharded import make_xpbd_sweep_sharded_step

        return make_xpbd_sweep_sharded_step(topology, params, mesh,
                                            colliders=colliders,
                                            device=device)
    if params.dialect == "jacobi":
        backend = {"pallas": "pass"}.get(params.jacobi_backend,
                                         params.jacobi_backend)
        if backend == "auto":
            backend = "pass" if big and on_card else "gather"
        if backend != "pass":
            raise NotImplementedError(_NOT_PORTED.format(
                "jacobi", "jacobi", "pass", SWEEP_MIN_CONSTRAINTS))
        from ..solver.jacobi_pass_sharded import (
            make_jacobi_pass_sharded_step)

        return make_jacobi_pass_sharded_step(topology, params, mesh,
                                             colliders=colliders,
                                             device=device)
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
