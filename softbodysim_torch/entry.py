"""Entry hooks: a one-device step check and a multi-rank dry run.

The port's counterpart of the JAX package's ``__graft_entry__.py``:

* ``entry(device=None) -> (fn, args)`` -- the flagship step: the XPBD
  (server-contract) step on tet_cube(6) with ground contact, 2 substeps x
  6 iterations, which resolves to the coloured 'gather' backend below the
  kernel threshold (on the card, one CUDA graph per iteration);
  ``fn(*args)`` returns the next ``SimState``.
* ``dryrun_multichip(n_devices, device=None, backend=None)`` -- the six
  multi-device modes of the JAX hook, one step each, on ``n_devices``
  ranks of one ``torch.distributed`` group (``parallel.spawn``): scene
  batches over "data" with constraints over "model" (jacobi and xpbd), the
  vertex-sharded steps (jacobi with self collision and a sphere, xpbd with
  surface collision), and the kernel-sharded sweeps and Jacobi passes.
  Each mode's positions must be finite.  Returns rank 0's final positions
  per mode, every rank's, and every rank's kernel launches per mode.

``python -m softbodysim_torch.entry`` steps ``entry()`` once and dry-runs
every card of the host (NCCL, one rank per card).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

DT = np.float32(1.0 / 60.0)

# the modes of dryrun_multichip, in the order they run
MODES = ("jacobi_mesh", "xpbd_mesh", "jacobi_vertex", "xpbd_vertex",
         "xpbd_sweep_sharded", "jacobi_pass_sharded")


def entry(device=None):
    """``(fn, (state, dt))``: ``fn(state, dt)`` is one flagship step on
    ``device`` (default: the card) and returns the next ``SimState``."""
    from .core import meshes
    from .core.state import SolverParams, init_state, resolve_device
    from .solver import make_xpbd_step

    dev = resolve_device(device)
    topo = meshes.tet_cube(6, 6, 6, size=0.8, center=(0.0, 1.0, 0.0))
    params = SolverParams(dialect="xpbd", substeps=2, iterations=6)
    step = make_xpbd_step(topo, params, device=dev)
    return step, (init_state(topo, device=dev), DT)


def _rank_device(rank: int, device: str, backend: str) -> torch.device:
    """NCCL: one card per rank, from ``device``'s index on; gloo: every
    rank on ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if backend == "nccl":
            dev = torch.device("cuda", (dev.index or 0) + rank)
        torch.cuda.set_device(dev)
    return dev


def _dryrun_rank(rank: int, world: int, device: str, backend: str) -> dict:
    """One rank of ``dryrun_multichip``: {"x": {mode: positions}, "launches":
    {mode: {kernel: n}}}, every mode one step from its initial state."""
    from .collide.primitives import Colliders
    from .core import meshes
    from .core.state import SolverParams, init_state
    from .kernels import launch_counts
    from .parallel import (gather_batch, init_batch_state, make_mesh,
                           make_mesh_sharded_step, make_vertex_sharded_step,
                           make_xpbd_sharded_step,
                           make_xpbd_vertex_sharded_step, shard_batch)
    from .solver import (make_jacobi_pass_sharded_step,
                         make_xpbd_sweep_sharded_step)

    dev = _rank_device(rank, device, backend)
    model = 2 if world % 2 == 0 and world > 1 else 1
    # both meshes before any mode: every rank creates the sub-groups in
    # one order
    mesh = make_mesh(shape=(world // model, model),
                     axis_names=("data", "model"), device_type=dev.type)
    vmesh = make_mesh(device_type=dev.type)
    batch = max(2, 2 * (world // model))
    topo = meshes.tet_cube(2, 2, 2, center=(0.0, 0.5, 0.0))
    params = SolverParams(dialect="jacobi", substeps=1, iterations=2)
    xparams = SolverParams(dialect="xpbd", substeps=1, iterations=2)
    cols = Colliders.build([Colliders.sphere((0.0, 0.1, 0.0), 0.15)],
                           device=dev)
    ptopo = meshes.tet_cube(7, 7, 7, size=0.7, center=(0.0, 0.8, 0.0))

    def jacobi_mesh():
        # scene batch over 'data', constraint shards summed over 'model'
        step = make_mesh_sharded_step(topo, params, mesh, device=dev)
        st = shard_batch(init_batch_state(topo, batch,
                                          inv_mass_mode="density",
                                          device=dev), mesh, axis="data")
        return gather_batch(step(st, DT), mesh).x.cpu().numpy()

    def xpbd_mesh():
        # each colour's constraints split over 'model', one sum per colour
        step = make_xpbd_sharded_step(topo, xparams, mesh, device=dev)
        return gather_batch(step(step.build_state(batch=batch), DT),
                            mesh).x.cpu().numpy()

    def jacobi_vertex():
        # one scene split by vertex, self collision and a sphere
        step = make_vertex_sharded_step(
            topo, params.replace(self_collision=True,
                                 self_collision_cell=0.2,
                                 self_collision_max_per_cell=16),
            vmesh, colliders=cols, device=dev)
        return step.unpad(step(step.build_state(), DT)[0])

    def xpbd_vertex():
        # coloured Gauss-Seidel with a halo per colour, surface collision
        step = make_xpbd_vertex_sharded_step(
            topo, xparams.replace(surface_collision=True,
                                  surface_thickness=0.02,
                                  surface_collision_max_per_cell=8),
            vmesh, axis="model", device=dev)
        return step(init_state(topo, inv_mass_mode="tet", device=dev),
                    DT).x.cpu().numpy()

    def xpbd_sweep_sharded():
        # the sweep kernels on each rank's windows, ghost windows exchanged
        step = make_xpbd_sweep_sharded_step(ptopo, xparams, vmesh,
                                            colliders=cols, device=dev)
        return step(init_state(ptopo, device=dev), DT).x.cpu().numpy()

    def jacobi_pass_sharded():
        # the passes' accumulate mode, (delta, count) halos summed at home
        step = make_jacobi_pass_sharded_step(ptopo, params, vmesh,
                                             device=dev)
        return step(init_state(ptopo, inv_mass_mode="density", device=dev),
                    DT).x.cpu().numpy()

    runs = (jacobi_mesh, xpbd_mesh, jacobi_vertex, xpbd_vertex,
            xpbd_sweep_sharded, jacobi_pass_sharded)
    out = {"x": {}, "launches": {}}
    for name, run in zip(MODES, runs):
        before = launch_counts()
        x = run()
        after = launch_counts()
        if not np.isfinite(x).all():
            raise AssertionError(f"dryrun_multichip: mode {name} on rank "
                                 f"{rank} of {world} is not finite")
        out["x"][name] = x
        out["launches"][name] = {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]}
    return out


def dryrun_multichip(n_devices: int, device=None, backend=None, *,
                     timeout_s: float = 300.0) -> dict:
    """Run the six multi-device modes (``MODES``) one step each on
    ``n_devices`` spawned ranks: a (data, model) mesh of (n // m, m), m = 2
    when n is even and above 1, else 1, and a 1-D "model" mesh over every
    rank; a batch of max(2, 2 * (n // m)) scenes.

    ``device`` defaults to the card (it raises without one); ``backend``
    to NCCL on the card (one card per rank: it raises when the host has
    fewer) and gloo on the CPU; ``backend="gloo"`` with a CUDA device puts
    every rank on that card.  A rank that fails, or does not answer within
    ``timeout_s`` seconds, makes the call raise with its traceback.

    Returns {"positions": {mode: rank 0's final positions (numpy)},
    "ranks": [{mode: positions} per rank], "launches": [{mode: {kernel:
    launches}} per rank]}."""
    from .core.state import resolve_device
    from .parallel import spawn

    n = int(n_devices)
    if n < 1:
        raise ValueError(f"dryrun_multichip needs at least one rank, got "
                         f"{n_devices}")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend steps on CUDA devices; pass "
                             "backend='gloo' for the CPU")
        have = torch.cuda.device_count() - (dev.index or 0)
        if have < n:
            raise RuntimeError(
                f"dryrun_multichip({n}) on NCCL needs {n} cards, one per "
                f"rank, and this host has {have} from {dev}; "
                "backend='gloo' puts several ranks on one card")
    res = spawn(_dryrun_rank, n, str(dev), backend, backend=backend,
                timeout_s=timeout_s)
    return {"positions": res[0]["x"], "ranks": [r["x"] for r in res],
            "launches": [r["launches"] for r in res]}


def main() -> int:
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry OK:", tuple(out.x.shape), flush=True)
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip OK", flush=True)
    return 0


if __name__ == "__main__":
    # the spawned ranks import the rank function from the package's module
    from softbodysim_torch.entry import main as _main

    sys.exit(_main())
