"""Stage-split profiling, traces and the device-time helpers of the port.

The counterpart of ``softbodysim_tpu/perf/profile.py``, with its names and
keys:

  profile_xpbd_stages    -- the XPBD dialect's stages (Sim.cpp's taxonomy:
                            predict / solve_edges / solve_tets / ground /
                            commit), each timed alone: the coloured step's
                            stage functions (``solver/xpbd.py``);
  profile_jacobi_stages  -- the Jacobi dialect's Pre / Solve(Edges|
                            Volumes|Collide) / Post (SoftBodyManager.cs
                            :205-236), on the segment formulation;
  trace, trace_summary   -- torch.profiler's Chrome trace in place of
                            jax.profiler's, and its time per op;
  step_rate              -- steps per second of any step function.

A stage timed alone loses the overlap the whole step has: report totals
from the step, shares from here.  Fences: on a CUDA device CUDA events
around the calls (the stream's time per call, launch gaps included), on
the CPU the host clock.

The device-time helpers ``chip_smoke.py`` and ``tools/`` time kernels and
steps with: ``events_ms`` (CUDA events around back-to-back calls),
``device_activity`` (torch.profiler's device events of one call),
``kernel_ms`` (a kernel wrapper's device time per call), ``held_ms``
(CUDA events around calls enqueued on a held stream),
``profile_window`` (an Engine's device time per kernel and busy share)
and ``window_ms`` (host-clock ms per step of a warm run).  The
measurements that only the card can give come from these on a CUDA
device; on the CPU they time PyTorch's CPU kernels.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..collide.primitives import project_ground_plane
from ..core.state import SimState, SolverParams, f32

DT = 1.0 / 60.0
# held_ms: cycles the stream is first held busy while calls are enqueued
# (~10 ms at the H100's 1.98 GHz)
HOLD_CYCLES = 20_000_000
# trace_summary: the Chrome trace's categories of device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync() -> None:
    """Wait for the card's queued work, if this process uses a card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def events_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean stream time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events), after one warm-up call unless ``warm`` is False: the host's
    launch gaps are included, so this times the plain versions as a caller
    pays for them."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed(fn, device: torch.device, repeats: int) -> float:
    """ms per call of ``fn`` over ``repeats`` calls after one warm-up:
    CUDA events on a CUDA device, the host clock on the CPU."""
    if device.type == "cuda":
        return events_ms(fn, repeats)
    fn()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) * 1e3 / repeats


def _sdt(params: SolverParams, dt: float):
    """(substep dt, 1 / dt^2, 1 / dt) in float32, as the steps take them."""
    sdt = np.float32(dt) / np.float32(max(1, params.substeps))
    big = sdt > np.float32(1e-12)
    inv_dt2 = np.float32(1.0) / (sdt * sdt) if big else np.float32(0.0)
    inv_dt = np.float32(1.0) / sdt if big else np.float32(0.0)
    return float(sdt), inv_dt2, float(inv_dt)


def profile_xpbd_stages(topology, params: SolverParams, state: SimState,
                        dt: float = DT, repeats: int = 20
                        ) -> Dict[str, float]:
    """Per-stage mean ms for the XPBD dialect on ``state``'s device, the
    stage taxonomy of Sim.cpp: predict / solve_edges (every edge colour)
    / solve_tets (every tet colour) / ground / commit, on the coloured
    step's stage functions.  A family the topology lacks reads 0."""
    from ..solver.xpbd import ColouredStep, commit, predict, project_ground

    dev = state.x.device
    step = ColouredStep(topology, params, device=dev)
    sdt, inv_dt2, inv_dt = _sdt(params, dt)
    grav = torch.tensor(params.gravity, dtype=torch.float32, device=dev)
    keep = f32(1.0 - min(1.0, max(0.0, params.friction)))
    w = state.inv_mass
    pinned = (w == 0.0)[:, None]
    xs, _ = predict(state.x, state.v, pinned, grav, sdt)

    def solve(fam, lam_pub, compliance, n):
        # the colour-major lambdas and alpha table the stage updates
        if fam not in step._fam:
            return 0.0
        lam = lam_pub[step._fam[fam]["perm"]].clone()
        alpha = torch.full((n,), float(np.maximum(
            np.float32(compliance), np.float32(0.0)) * inv_dt2), device=dev)
        run = step._edges if fam == "edges" else step._tets
        return _timed(lambda: run(xs, w, lam, alpha), dev, repeats)

    return {
        "predict_ms": _timed(
            lambda: predict(state.x, state.v, pinned, grav, sdt), dev,
            repeats),
        "solve_edges_ms": solve("edges", state.edge_lambda,
                                params.edge_compliance, topology.num_edges),
        "solve_tets_ms": solve("tets", state.tet_lambda,
                               params.volume_compliance, topology.num_tets),
        "ground_ms": _timed(
            lambda: project_ground(xs, w, params.ground_y), dev, repeats),
        "commit_ms": _timed(
            lambda: commit(xs, state.x, pinned, inv_dt, params, keep), dev,
            repeats),
    }


def profile_jacobi_stages(topology, params: SolverParams, state: SimState,
                          dt: float = DT, repeats: int = 20
                          ) -> Dict[str, float]:
    """Per-stage mean ms for the Jacobi dialect on ``state``'s device --
    the Unity manager's Pre / Solve(Edges|Volumes|Collide) / Post
    (SoftBodyManager.cs:205-236), on the segment formulation
    (``kernels/jacobi.py``'s per-constraint deltas and apply); collide is
    the ground plane, as in the JAX function."""
    from ..kernels.jacobi import (apply_delta, edge_jacobi_deltas,
                                  tet_jacobi_deltas)

    dev = state.x.device

    def table(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype)).to(dev)

    edges = table(topology.edges, np.int64).reshape(-1, 2)
    edge_rest = table(topology.edge_rest, np.float32)
    tets = table(topology.tets, np.int64).reshape(-1, 4)
    tet_rest = table(topology.tet_rest_vol, np.float32)
    nv = topology.num_particles
    grav = torch.tensor(params.gravity, dtype=torch.float32, device=dev)
    point = torch.tensor(params.ground_point, dtype=torch.float32,
                         device=dev)
    normal = torch.tensor(params.ground_normal, dtype=torch.float32,
                          device=dev)
    sdt, _, inv_dt = _sdt(params, dt)
    k_e, k_t = f32(params.edge_stiffness), f32(params.volume_stiffness)
    omega = f32(params.sor_omega)
    w = state.inv_mass
    pinned = (w == 0.0)[:, None]

    def pre():
        v = torch.where(pinned, 0.0, state.v + grav * sdt)
        return torch.where(pinned, state.x, state.x + v * sdt)

    def post():
        v = torch.where(pinned, 0.0, (x_pred - state.x) * inv_dt)
        return torch.where(pinned, state.x, x_pred), v

    x_pred = pre()
    return {
        "pre_ms": _timed(pre, dev, repeats),
        "solve_edges_ms": _timed(lambda: apply_delta(
            x_pred, w, *edge_jacobi_deltas(x_pred, w, edges, edge_rest, k_e,
                                           nv), omega), dev, repeats),
        "solve_volumes_ms": _timed(lambda: apply_delta(
            x_pred, w, *tet_jacobi_deltas(x_pred, w, tets, tet_rest, k_t,
                                          nv), omega), dev, repeats),
        "collide_ms": _timed(lambda: project_ground_plane(
            x_pred, f32(params.particle_radius), point, normal), dev,
            repeats),
        "post_ms": _timed(post, dev, repeats),
    }


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler over the block -- the host's ops, and the card's
    kernels and copies when CUDA is available -- written on exit as a
    Chrome trace (``<log_dir>/trace-<pid>-<ns>.json``; open it in
    Perfetto or chrome://tracing).  Default directory: ``softbodysim_trace``
    under the temporary directory.  Yields the directory."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "softbodysim_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
        _sync()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def trace_summary(log_dir: str, top: int = 20):
    """[(total_us, name)] over the Chrome traces under ``log_dir``
    (written by ``trace()``), longest first: the device's kernels, copies
    and sets when the traces hold any, else the host's operators -- the
    "where did the step go" view without a trace viewer."""
    device, host = collections.Counter(), collections.Counter()
    files = (glob.glob(os.path.join(log_dir, "**", "*.json"), recursive=True)
             + glob.glob(os.path.join(log_dir, "**", "*.json.gz"),
                         recursive=True))
    for fn in files:
        opener = gzip.open if fn.endswith(".gz") else open
        with opener(fn, "rt") as f:
            data = json.load(f)
        for ev in data.get("traceEvents", []):
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = ev.get("cat", "")
            if cat in DEVICE_CATEGORIES:
                device[ev.get("name", "?")] += ev["dur"]
            elif cat == "cpu_op":
                host[ev.get("name", "?")] += ev["dur"]
    agg = device if device else host
    return [(dur, name) for name, dur in agg.most_common(top)]


def step_rate(step_fn, state, dt, steps: int = 50,
              warmup: int = 3) -> Dict[str, float]:
    """End-to-end steps/sec of ``state = step_fn(state, dt)`` (the FPS
    counter), timed on the host clock to a synchronize of the card.  An
    Engine steps as ``step_rate(lambda e, dt: e.step(dt), engine, dt)``."""
    for _ in range(warmup):
        state = step_fn(state, dt)
    _sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step_fn(state, dt)
    _sync()
    elapsed = time.perf_counter() - t0
    return {"steps_per_sec": steps / elapsed,
            "ms_per_step": elapsed / steps * 1000.0}


# ---- device time of kernels and steps (on the card) ---------------------

def device_activity(fn) -> tuple:
    """Run ``fn`` under torch.profiler: ({name: [count, total us]} over the
    device-side events -- kernels, memory copies and sets --, the host's
    wall us from the start to a synchronize after ``fn``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = collections.defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            row = out[ev.name]
            row[0] += 1
            row[1] += ev.time_range.elapsed_us()
    return dict(out), wall_us


def kernel_ms(fn, reps: int, kernels_per_call: int = 1) -> float:
    """Device time of one call of a kernel wrapper, from the profiler over
    ``reps`` calls (after one warm-up call): the sum over its device
    activities of each one's mean time (each runs once per call; the
    profiler may drop events, so a mean, not a total over ``reps``; a
    window where it saw fewer than half the calls is run again, up to
    three times).  The host's launch time between calls is not
    counted."""
    fn()
    for _ in range(3):          # the profiler now and then drops a run
        acts, _ = device_activity(lambda: [fn() for _ in range(reps)])
        if len(acts) >= kernels_per_call and all(
                c >= reps // 2 for c, _ in acts.values()):
            return sum(t / c for c, t in acts.values()) / 1e3
        print(f"kernel_ms: the profiler saw {acts} for {reps} calls; "
              "again", flush=True)
    ms = held_ms(fn, reps)
    print(f"kernel_ms: the profiler saw no device activity three times; "
          f"CUDA events on a held stream instead: {ms:.4f} ms", flush=True)
    return ms


def held_ms(fn, reps: int) -> float:
    """Device time of one call from CUDA events around ``reps`` calls that
    are all enqueued while the stream is held busy (torch.cuda._sleep), so
    the calls run back to back and the host's launch gaps are not counted
    (the device's own gap between kernels is).  The hold grows until the
    device is still in it when the last call has been enqueued."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = HOLD_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError("held_ms: the hold ended before the calls were "
                         "enqueued")


def window_ms(label: str, run, steps: int, windows: int = 3) -> float:
    """Host-clock ms/step of ``run(steps)`` on a warm path: ``windows``
    windows, each ending in a synchronize of the card; prints each and
    returns their median (the host shares its cores, so one window can be
    slow).  An Engine: ``window_ms(eng.backend, lambda n: eng.run(n, dt),
    steps)``."""
    ms = []
    for _ in range(windows):
        t0 = time.perf_counter()
        run(steps)
        _sync()
        ms.append((time.perf_counter() - t0) * 1e3 / steps)
    print(f"{label}: ms/step in {windows} windows of {steps} steps: "
          f"{', '.join(f'{m:.4f}' for m in ms)}", flush=True)
    return float(np.median(ms))


def short_name(name: str) -> str:
    """A device activity's name without its namespaces and arguments'
    tail."""
    for noise in ("void ", "(anonymous namespace)::", "at::native::"):
        name = name.replace(noise, "")
    return name.split("(")[0][:72] if not name.startswith("Memcpy") \
        else name


def profile_window(eng, steps: int, timed_ms: float, dt: float = DT) -> dict:
    """One profiled window of ``steps`` steps of a warm Engine: per device
    activity its count and mean us, the device's busy ms per step, and
    that over ``timed_ms``
    (the unprofiled window's ms/step) as the busy share.  The profiled
    window's own wall time is printed too; the profiler slows the host's
    launches, so it is not the step's time."""
    acts, wall_us = device_activity(lambda: eng.run(steps, dt).block())
    merged = collections.defaultdict(lambda: [0, 0.0])
    for name, (c, t) in acts.items():
        row = merged[short_name(name)]
        row[0] += c
        row[1] += t
    busy = sum(t for _, t in acts.values()) / 1e3 / steps
    return {"backend": eng.backend, "steps": steps,
            "profiled_wall_ms_per_step": wall_us / 1e3 / steps,
            "device_busy_ms_per_step": busy,
            "device_busy_share": busy / timed_ms,
            "device": {name: {"count": c, "mean_us": t / c,
                              "us_per_step": t / steps}
                       for name, (c, t) in sorted(merged.items(),
                                                  key=lambda kv: -kv[1][1])}}
