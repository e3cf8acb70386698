"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero exit:

1. Require a CUDA device; print the card's name and power limit.
2. Build every CUDA kernel from softbodysim_torch/kernels/csrc/*.cu (one
   nvcc per source, all started together, then one link) and print the
   build time and each kernel's resources.
3. XPBD main path at the north star (tet_cube(47): V = 110,592,
   E = 642,960, T = 519,115): Engine(xpbd, 8 substeps, 1 iteration,
   device="cuda") with xpbd_backend="auto" -> the sweep backend; run(32)
   then step(); check the positions and that every sweep kernel was
   launched; time three warm 20-step windows (their median is the
   path's ms/step).
4. Jacobi main path on the same cube: Engine(jacobi, the in-engine
   tunings, a floor box collider, device="cuda") with
   jacobi_backend="auto" -> the pass backend, one CUDA graph replay per
   substep, the collide stage fused into each iteration's tet pass; run(32)
   then step(); check (a graph was captured, the stand-alone collide
   kernel launched 0 times) and time three warm 20-step windows; then, as
   diagnostics, three windows of the same step run eagerly (kernel by
   kernel) on a copy of its state, and three of Engine.step one step at a
   time with stiffness and omega overrides that change every step (no new
   graph may be captured).  Then the pass path's other variants on the
   same cube, 4 steps each: its edges alone on the floor box (the collide
   stage fused into the edge pass) and the whole cube with no ground and
   no colliders (no collide stage); and tet_ball(6, 0.3) (V = 40,963,
   E = 163,842, T = 81,920; the centre in every tet, so a heavy vertex)
   on the floor box with jacobi_backend="auto" -> 'pass': 10 steps, each
   against the same Engine on the CPU's 'gather' backend within 1e-4 m or
   ten times the CPU's own spread at that step (that Engine against one
   started one ulp away), printed per step; then three warm 20-step
   windows.
5. XPBD legacy path on the same cube: Engine(xpbd, 8 substeps, 1
   iteration, superblocks=False, a box just under the body) -> the sweep
   backend on the 128-wide legacy plans (SweepStep, carry API); print the
   host plan time; run(8) then step(); check the positions (finite, no
   free particle inside the box) and that both legacy sweep kernels and
   the collide kernel were launched; time three warm 5-step windows.
6. XPBD reference checks: small Engines at both block widths against the
   NumPy block-synchronous oracle (tests/oracle.py) at the plans' own
   widths, 10 steps.
7. XPBD colliders on the super-block path: tet_cube(4) onto a box whose
   pose moves mid-run, on the card against the same step on the CPU.
8. XPBD coloured Gauss-Seidel on the card: 'auto' (-> 'gather'; 'scatter'
   resolves to it too) with SampleScene's body on its box (the collide
   kernel launches, the body rests on the box; then three warm 2-step
   windows timed, and, as a diagnostic, three 2-step windows of
   Engine.step with an edge compliance that changes every step: ms/step
   and the CUDA graphs captured, none after the first), then tet_cube(3)
   against the oracle's serial sweep in colour order, 10 steps.
9. SampleScene's body (tet_ball(2, 0.3) at (0, 1, 0), density 0.2) on its
   box through the jacobi gather backend, which launches the collide
   kernel.
10. Jacobi reference check: tet_cube(3) onto a box and the ground, 10 steps
   on the card on the pass and gather backends, against the NumPy
   JacobiOracle (tests/oracle.py).
A-F. The scene paths and the convergence module, after phase 10 and
   before any profiler runs, each at full size with the launch counts set
   to 0 before it and printed after it:
   A. perf.convergence.run_curves on the north star (ss2 x it6, 'auto'
      block scheme, 120 steps, ordering 'blocks_pallas': the sweep
      kernels); the 30-step tail means of the edge and tet residuals
      beside the JAX package's record (0.2328 / 0.4892) and the serial
      Gauss-Seidel anchors (0.2540 / 0.6081), each at most its anchor.
   B. bench.py's partitioned_mixed_dialect (20 bodies, V 118,245,
      1,158,831 constraints): Scene.build_partitioned(backend="pallas")
      -> 2 programs, 'pass' (10 jacobi cubes with their own stiffness:
      per-constraint tables) and 'sweep'; the host plan time; 32 warm
      steps, three 32-step windows of PartitionedSceneEngine.run; every
      body finite.  The checks start from a deformed state (positions
      moved by N(0, 1 cm) draws, the same on both sides) and print how
      many constraints start off rest: each jacobi body of the merged
      program, from its state after the timed windows (on the ground),
      against its solo 'pass' Engine for 4 steps (1e-4 m), and against
      the solo Engine with another body's stiffness (at least 10x that
      off: the tables decide); a reduced copy of the mix (2 + 2 small
      cubes) on the card against the CPU for 10 steps; two xpbd cubes
      with their own compliance merged (the sweep kernels with edge_c /
      tet_c tables), 10 steps reaching the ground (1e-4 m): tet_cube(3)
      against their solo 'sweep' Engines on the card (and 10x off with
      the materials swapped), tet_cube(8) against the CPU, with its plan
      tables read back through the constraint each slot solves.
   C. scenes.batch_test() merged (procedural stand-ins, V 23,600,
      213,020 constraints) -> 'pass', and 'auto' -> 'pass'; one warm
      RUN_CHUNK, three 64-step windows.
   D. bench.py's batched_128x_jacobi: BatchedEngine(tet_cube(10), jacobi
      'gather', batch 128, jitter 0.002 from a seeded generator): three
      50-step windows, ms/step and proj_per_sec; then B = 4 with a box
      (one collide launch per iteration for all scenes) against the solo
      'gather' Engine, 10 steps (1e-6 m).
   E. DynamicMergedWorld growing by tet_cube(12) bodies across 100k
      constraints: jacobi 'gather' -> 'pass', xpbd 'gather' -> 'sweep';
      the retained bodies' x, v and lambdas array-equal across the
      rebuild.
   F. sample_scene().build_world(): 20 steps, the body resting on its box.
G-H. Contact and the mesh pipeline, after phase F and before any profiler
   runs:
   G. BASELINE config #4 at the north star's size: 8 x tet_cube(23) (V
      110,592) merged in two layers of four, 0.1 m apart, the upper layer
      a quarter cube off in x and z; particle radius 0.02, self collision
      (cell 0.04, cap autosized), surface collision (thickness 0.02, cell
      autosized), friction 0.4, ground on.  Run twice: xpbd 8 x 1 'auto'
      (-> the sweep kernels) and jacobi 2 x 6 with the in-engine tunings
      'auto' (-> the pass kernels, the stages inside the substep's graph).
      Each: the host plan time and the autosized caps; 40 steps with a
      checkpoint (io/checkpoint.py) at step 30; a second run to step 30
      equal to the checkpoint bit for bit; the checkpoint loaded into a
      fresh Engine and stepped 10 more, equal bit for bit to the 40 steps;
      stacked: the upper layer's mean height at least 0.1 m over the
      lower's, and at most 10% of the upper vertices over a lower top face
      more than 2 cm below it (the same scene with contact off must fail
      both); three warm 20-step windows.  Then per dialect the stages'
      device ms and device ops per call (torch.profiler) and their
      costliest ops, their peak memory, their share of the step's device
      time and the overflow counts at the end; and a reduced copy
      (two tet_cube(3) bodies that collide) on each backend within 1e-4 m
      of the CPU over 10 steps.
   H. A closed icosphere tetrahedralized by core/tetrahedralize.py on the
      native library (host seconds of voxelizing and snapping), round-
      tripped through io/topology_store.py, dropped on the floor box for
      20 steps on jacobi 'auto', each step against the CPU as phase 4's
      ball (1e-4 m, or ten times the CPU's own spread, its 'gather'
      Engine against one started one ulp away, once the landing makes it
      larger).
   A {"contact": {...}} line sums up G and H (with the card's name and
   power limit).
I-J. Serving, the CLI and the render layer, after phase H and before any
   profiler runs:
   I. A PBD1 client sends INIT for the north star (WireParams(substeps=8,
      iterations=1): bench.py's north star; ~14.8 MB) to a PBDServer on
      port 0 in a background thread on the card, then 20 STEPs: each reply
      bit for bit an Engine built the same way in the process and stepped
      beside it; the sweep kernels launched; the INIT-to-first-reply
      seconds (the server's make time) and the ms per round trip beside
      phase 3's ms/step; that Engine's host dispatch per step beside its
      device time, and one step dispatched while the stream is held busy
      for at least 0.5 s (20x its dispatch): the dispatch must return
      inside the hold (it must not wait for the device).  Then with
      client work of one round trip per frame, 20 timed frames lock-step
      and 20 pipelined: pipelined reply k is lock-step reply k-1 bit for
      bit, and pipelined frames/s at least 1.3x lock-step.  Two concurrent
      north-star clients on a multi-session server (each reply stream bit
      for bit its solo run, no sweep timeout; the aggregate frames/s beside
      one session's), a second north-star INIT while a session steps on
      the same server (the running session's worst frame gap during the
      INIT beside its median gap before it: the INIT's host plans are
      built outside the device lock), two concurrent tet_cube(6) clients
      whose first STEPs
      (the coloured step's captures) are released together (each bit for
      bit its solo run), the native comm loop (NativePBDServer) on one
      north-star session (bit for bit), and the watchdog on the north
      star: a NaN injected gives one rollback, the state bit for bit the
      snapshot.
   J. ``python -m softbodysim_torch info`` and ``scene batch --seconds 2``
      as subprocesses (the scene on the 'pass' kernels); ``serve --view``'s
      viewport frame over HTTP equal to the last reply; vertex_normals of
      the north star's surface on the card within 1e-5 of the CPU.
   A {"serving": {...}} line sums up I and J (with the card's name and
   power limit).
K. Differentiable simulation (``softbodysim_torch/diff.py``), after phase J
   and before any profiler runs:
   K1. The north star on the coloured step's differentiable build (8 x 1,
      ground on, 4 steps): the ballistic identities of a free body
      (d(mean final y)/d(dv0) = nsteps dt, d/d(g_y) = T^2 (n+1) / (2n),
      rel 1e-3); from a random initial velocity field at the edge
      compliance where alpha is twice the median inverse mass, the
      trajectory loss's gradient w.r.t. log edge compliance against a
      central difference on the card (rel 2e-2); ms per value_and_grad
      and its peak memory with and without remat; a 5-step fit from 10x
      off (its losses printed, the last under the first).
   K2. Phase 4's configuration (the floor box) forced to 'segment', the
      body lowered 5 cm into the box: the collide kernel launched (the
      Function's forward), the gradient w.r.t. edge_stiffness against a
      central difference (rel 2e-2), ms and peak memory with and without
      remat; then the gradient w.r.t. sor_omega against two central
      differences (rel 2e-2 each) from a start 0.3 m over the box with a
      random velocity field, where no contact switches inside the
      difference's span (asserted from the trajectories).
   K3. kernels/collide.py::collide_positions at north-star shapes: one
      kernel launch, forward within 1e-6 of collide_plain, gradients
      w.r.t. the positions and the collider table equal to autograd
      through collide_plain (max-abs 0).
   K4. The sweep, legacy and pass steps of phases 3-5 raise when handed
      a state that requires grad, and their state is unchanged.
   K5. tet_cube(6) on the floor box, both dialects, 4 steps: the card's
      trajectory (1e-4 m) and gradients (1e-3 of the largest component)
      against the CPU's.
   A {"diff": {...}} line sums up K (with the card's name and power
   limit).  Every tensor checked is on the card.
L. The kernel-sharded steps (``Engine(mesh=...)``), after phase K and
   before any profiler runs: phase 3's north star on the sweep kernels
   (8 x 1) and phase 4's Jacobi configuration on the passes' accumulate
   mode (2 x 6, the floor box), 'auto' picking the sharded kernel steps,
   each at D = 1 (an NCCL group of one, in this process) and D = 2 (two
   spawned ranks on a gloo group sharing the card, the collectives
   staged through pinned host memory): each run SHARDED_STEPS steps
   twice from the rest shape with seeded velocities N(0, 0.5) m/s (the
   same bits), every rank the same bits, then three timed windows; each
   run's constraint correction (its largest distance from the ballistic
   move, and at D = 2 the same over the ghost windows' rows) at least 10
   times each position limit it is held to; xpbd D = 1 against the
   single-device sweep step within 1e-6 m, jacobi D = 1 and D = 2
   against the single-device pass step within 1e-5 m, xpbd D = 2 one
   step with the kernels against the same ranks with the plain versions
   (1e-4 m, 1e-3 of the largest lambda); 'segment' (phase 4's
   configuration) twice from the same start, the same bits. Prints per
   path and D the ms/step, the ghost and export windows and bytes per
   exchange per rank, the host's share of the windows inside collectives
   and the transport, and a {"sharded": {...}} line (with the card's
   name and power limit). The D = 2 ranks share one card: not a
   scale-out figure.
O. The vertex-sharded, data- and constraint-parallel modes
   (``parallel/{sharding,constraint,vertex}.py``) and the mesh gradients
   (``diff.make_rollout(mesh=)``), after phase L and before phase M and
   any profiler.  O1 (D = 1, an NCCL group of one in this process) and O2
   (D = 2, two spawned ranks on a gloo group sharing the card): the north
   star on ``Engine(mesh=...)`` with xpbd 8 x 1 'gather' (the xpbd
   vertex-sharded step) and phase 4's jacobi 2 x 6 'gather' on the floor
   box (the jacobi vertex-sharded step, the collide kernel on every
   rank), MODES_STEPS steps from phase L's seeded velocities, against the
   single-device Engine on the same backend (xpbd 1e-5 m and lambdas
   1e-4, jacobi 2e-5 m), run twice the same bits, every rank the same
   bits, constraint corrections of at least 10x the limit.  O3: bench.py's
   batched_128x_jacobi (128 x tet_cube(10)) through
   make_data_parallel_step (d = 1, 2) and make_mesh_sharded_step ((1, 1),
   (2, 1), (1, 2)), and 8 xpbd scenes through make_xpbd_sharded_step
   ((1, 1), (1, 2)), against the batched step (1e-5 m).  O4: one
   value_and_grad per dialect of a MODES_STEPS-step mesh rollout at D = 1
   against the single-device gradient of phase K's configurations (1e-3
   of the largest entry).  Prints ms/step, the halo mode and bytes per
   sweep or colour against the full gather, the host's share inside
   collectives and a {"modes": {...}} line (with the card's name and
   power limit).  The D = 2 ranks share one card: not a scale-out
   figure.
P. The entry hooks (``softbodysim_torch/entry.py``) and the examples
   (``softbodysim_torch/examples/``), after phase O and before phase M and
   any profiler.  P1: ``entry()`` (the coloured xpbd step on tet_cube(6),
   2 x 6) on the card, HOOK_STEPS calls each against ``entry(device=
   "cpu")`` within 1e-4 m, then three timed 5-call windows.  P4:
   ``examples.datagen --batch 4096 --steps 10`` (its scene-steps/s and
   projections/s, with the card's name and power limit),
   ``examples.moving_collider --steps 30`` (the collide kernel launched, no
   particle inside the capsule) and ``examples.checkpoint_resume --steps
   20`` (bit for bit).  P2: ``dryrun_multichip(1)`` (NCCL, one rank) and
   ``dryrun_multichip(2, backend="gloo")`` (two ranks on the card), each
   beside the same call with ``device="cpu"``, the four at once: every
   mode's rank-0 positions against the CPU's within 1e-4 m, every rank
   the same bits, and each mode's kernels launched on every rank (collide
   in the jacobi mesh and vertex modes, w_fill, edge_sweep, tet_sweep and
   collide in the kernel-sharded sweeps, the two accumulate kernels and
   collide in the kernel-sharded passes).  P3, meanwhile: ``python -m
   softbodysim_torch.entry`` as a subprocess exits 0 and prints both OK
   lines.  A {"hooks": {...}} line sums it up.
M. The bf16 particle table (``SolverParams.xpbd_x_dtype="bfloat16"``),
   after phase L and before any profiler runs.  M1: the bf16 w fill,
   sweeps and collide stage against their plain versions on phase 11's
   perturbed north-star table rounded to bf16 (the w fill bit for bit;
   coordinates within 1 bf16 ulp, at least 90% of the rows bit-equal;
   lambdas 1e-3 of the largest), each sweep's schedule against one CTA
   bit for bit over 20 launches.  M2: the north star (8 x 1) on the bf16
   table, 33 steps: only the bf16 instantiations launch, positions
   finite, mean y within 2^-7 m of the f32 Engine's; three warm 20-step
   windows beside phase 3's ms/step.  M3: the same on phase 5's box, 9
   steps: the collide stage's bf16 instantiation launches, the body rests
   on the box (within one bf16 ulp under its top).  A {"bf16": {...}}
   line sums it up; the kernels are timed in phase 11.
11. Every kernel at north-star shapes against its plain PyTorch version
   on the card, from one predicted, perturbed state (the Jacobi ones with
   a box collider and the ground); time both.  The passes' accumulate
   mode (the sums and counts, unapplied) against its plain version
   within 1e-5 m, counts equal, the same bits on 20 launches.  Each
   Jacobi pass prints its tile plan (build time, tiles, largest tile,
   shared memory, heavy vertices, CTAs per SM) and must give the same
   bits on 20 launches from one snapshot; each pass with the collide
   stage fused (the floor box, a sphere and a capsule, the body moved
   into them) must equal the pass
   followed by the stand-alone collide kernel bit for bit on 20 launches.
   Each sweep kernel also
   runs its plan's dependency schedule on the card's Q CTAs and on one
   CTA (plan order): 20 back-to-back launches each from the same state,
   which must agree bit for bit; print each schedule (Q, CTAs used,
   levels, length in blocks) and both times beside the earlier one-CTA
   design's.
12. One profiled window of each main path's warm Engine, of the jacobi
   Engine on tet_ball(6) and of the
   coloured step on SampleScene's body (torch.profiler: device time per
   kernel, the device's busy share of the timed window); the jacobi
   window must name the edge pass and the tet pass with its collide stage
   inside its graph replays.  Then one step's value_and_grad of phase
   K1's and K2's configurations (no remat): the device's busy ms and
   kernel count against phase K's unprofiled ms per step.
   It comes last of the timings: once the profiler has run, the host's
   launches are slower.
N. ``softbodysim_torch.perf`` at north-star shapes: profile_xpbd_stages
   (the coloured step's stages, 8 x 1) and profile_jacobi_stages (the
   segment formulation, phase 4's parameters), each stage fenced by CUDA
   events; a trace of 4 steps of phase 3's Engine whose summary's top
   entry is the edge sweep kernel; step_rate.  A {"profile_module": ...}
   line.

Every path runs with the kernels' launch counts set to 0 just before it and
read just after.  A {"scenes": {...}} line sums up phases A-D (with the
card's name and power limit).  The line before the last is
{"kernels": [...]} (per
kernel: launches on its main path, max error against its plain version,
the kernel's device time per call (torch.profiler, so the host's launch
time between calls is not counted; should the profiler see nothing in
three windows, CUDA events around calls enqueued on a held stream), the
plain version's time per call
(CUDA events over back-to-back calls, launch gaps included), the least
time the card could take (bytes over 3.35 TB/s or operations over
67 TFLOP/s fp32), and the time of one PyTorch call that computes the same
function -- null: none does); the last line is {"ok": true, "device":
{...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from softbodysim_torch.perf.profile import (  # noqa: E402
    HOLD_CYCLES, device_activity, events_ms, kernel_ms, profile_window,
    short_name, window_ms)

DT = 1.0 / 60.0
NORTH_STAR = dict(nx=47, ny=47, nz=47, size=1.0, center=(0.0, 2.0, 0.0))
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor)
# operations/s; a kernel's bound is the larger of its two times.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Tolerances, kernel vs plain PyTorch version on the same inputs:
# - w_fill: the same two IEEE products and one sum per value (no FMA on
#   either side): 1 ulp of the largest value.
# - sweeps: the kernel sums each vertex's corrections in the plan's CSR
#   order, the plain version with index_add_ (atomics, run-to-run order);
#   fp32 reassociation moves a position by a few ulp (~2.4e-7 m at |x| ~ 2 m)
#   per block touching it, and later blocks read those positions.  Positions
#   within 1e-4 m (~0.5% of an edge's rest length 0.0213 m); lambdas
#   within 1e-3 of the largest |lambda| of the sweep.
# - Jacobi passes: one pass from one snapshot; the two sides differ in fp32
#   summation (the tile's slot order against the plain version's int64
#   fixed-point sum, rounded once) and rounding
#   (the kernel computes as the TPU kernel: the f32 sixth multiplied,
#   lambda = (-k C) / w), a few ulp at |x| ~ 2 m: within 1e-5 m, and the
#   per-particle counts equal.
# - collide: the same arithmetic in the same order, no FMA on either side:
#   within 1e-6 m.  The pass with the collide stage fused runs the
#   stand-alone kernel's code (csrc/collide_math.cuh) on the row it
#   computed: bit for bit the pass followed by that kernel, and its plain
#   version (the plain pass, then the plain stage) within the passes' 1e-5.
X_TOL = 1e-4
LAM_REL_TOL = 1e-3
PASS_TOL = 1e-5
COLLIDE_TOL = 1e-6
ORACLE_TOL = 1e-4
# the sweep over its schedule's CTAs against one CTA: launches compared
SCHEDULE_LAUNCHES = 20
# a Jacobi pass, launched again from the same snapshot: launches compared
PASS_LAUNCHES = 20
# each sweep kernel's device ms per call at north-star shapes in its
# earlier design, one CTA walking the plan (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md section 6), printed beside this run's
ONE_CTA_DESIGN_MS = {"edge_sweep": 1.895, "tet_sweep": 2.549,
                     "legacy_edge_sweep": 9.666, "legacy_tet_sweep": 15.198}

# The in-engine tunings (softbodysim_tpu/api/scenes.py:314-318) and the
# floor box of four_body_test (scenes.py:360).
JACOBI = dict(dialect="jacobi", substeps=2, iterations=6,
              edge_stiffness=0.9, volume_stiffness=0.98, sor_omega=1.4,
              particle_radius=0.02, gravity=(0.0, -10.0, 0.0))
FLOOR_BOX_TOP = 0.2
# the legacy path's box: its top this far under the body's lowest point
LEDGE_GAP = 0.05
# SampleScene's body on the coloured backends: it lands on its box after
# ~19 steps; its mesh has 162 edge and 320 tet colours (every tet holds
# the centre vertex), ~6k colour passes per step of plain tensor ops
COLOURED_STEPS = 24
# tet_ball(6, 0.3) from 0.55 m over the floor box: it meets the box in
# step 5; from step 8 on, as its sliver tets land, two runs that differ in
# the last bits part by millimetres (the CPU's 'gather' Engine and one
# started one ulp away, which phase 4 runs beside the card at every step:
# cpu_spread_engines, ball_tol); 7 steps keep three in contact and hold
# the smoke's wall time near 900 s
BALL_STEPS = 7


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(bytes_moved: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes / HBM rate and operations
    / fp32 rate."""
    tb, to = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def result(err, ms, plain_ms, bytes_moved, ops) -> dict:
    b_ms, b_by = bound(bytes_moved, ops)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def report(name, r) -> None:
    print(f"{name}: max|kernel - plain| {r['max_abs_err']:.3e}, kernel "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)


def reset_counts():
    from softbodysim_torch.kernels import reset_launch_counts

    reset_launch_counts()


def read_counts() -> dict:
    from softbodysim_torch.kernels import launch_counts

    return launch_counts()


# --------------------------------------------------------------------------
# XPBD (phases 3, 5-8, 11)
# --------------------------------------------------------------------------

def perturbed_table(sbt, topo, device, superblocks: bool) -> tuple:
    """The north-star SweepStep at one block width and its particle table
    in a predicted, perturbed state (one substep of free fall plus noise):
    (step, xw, {family: alpha})."""
    from softbodysim_torch.solver.xpbd_sweep import SweepStep

    params = sbt.SolverParams(dialect="xpbd", substeps=8, iterations=1)
    t0 = time.perf_counter()
    step = SweepStep(topo, params, device=device, superblocks=superblocks)
    print(f"host plans ({'super-blocks' if superblocks else 'legacy'}): "
          f"{time.perf_counter() - t0:.2f} s (edge blocks "
          f"{step.gpu_plans['edges'].num_blocks}, tet blocks "
          f"{step.gpu_plans['tets'].num_blocks})", flush=True)
    xw = step.pack_state(sbt.init_state(topo, device=device)).xw
    sdt = np.float32(DT) / np.float32(8)
    rng = np.random.default_rng(SEED)
    noise = rng.normal(0.0, 1e-3, (xw.shape[0], 3)).astype(np.float32)
    free = (xw[:, 3:4] != 0).float()
    xw[:, 1] -= float(np.float32(9.81) * sdt * sdt) * free[:, 0]
    xw[:, :3] += torch.as_tensor(noise, device=device) * free
    alphas = {"edges": float(np.float32(params.edge_compliance)
                             / (sdt * sdt)),
              "tets": 0.0}
    return step, xw, alphas


def compare_sweep_kernels(sbt, ksw, topo, device) -> dict:
    """Phase 11: each sweep kernel against its plain version, same
    inputs."""
    step, xw, alphas = perturbed_table(sbt, topo, device, superblocks=True)
    ep, tp = step.device_plans["edges"], step.device_plans["tets"]
    ks = step.block_scheme["local_iters"]
    res = {}
    one = {fam: ksw.to_device(step.gpu_plans[fam], device, queues=1)
           for fam in ("edges", "tets")}

    # w_fill (both families): the index and count tables and xw read once,
    # the streamed table written; 2 (edges) or 1 (tets) flops per value
    err, ms, plain_ms, nb, ops = 0.0, 0.0, 0.0, 0, 0
    for plan in (ep, tp):
        wk = ksw.w_fill(plan, xw)
        wp = ksw.w_fill_plain(plan, xw)
        torch.cuda.synchronize()
        e = (wk - wp).abs().max().item()
        tol = float(np.finfo(np.float32).eps) * wp.abs().max().item()
        if not e <= tol:
            raise AssertionError(f"w_fill disagrees: {e} > {tol}")
        err = max(err, e)
        ms += kernel_ms(lambda: ksw.w_fill(plan, xw), 20)
        plain_ms += events_ms(lambda: ksw.w_fill_plain(plan, xw), 20)
        nb += nbytes(plan.verts, plan.counts, xw, wk)
        ops += wk.numel() * (3 if plan.arity == 2 else 1)
    res["w_fill"] = result(err, ms, plain_ms, nb, ops)
    w_e = ksw.w_fill_plain(ep, xw)
    w_t = ksw.w_fill_plain(tp, xw)

    # per live lane and visit: ~26 flops (edge) / ~140 (tet)
    for name, fam, wtab, k, fn, plain, lane_ops in (
            ("edge_sweep", "edges", w_e, ks[0], ksw.edge_sweep,
             ksw.edge_sweep_plain, 26),
            ("tet_sweep", "tets", w_t, ks[1], ksw.tet_sweep,
             ksw.tet_sweep_plain, 140)):
        plan, a = step.device_plans[fam], alphas[fam]
        res[name] = compare_sweep(
            name, plan, xw,
            lambda x, l, p=plan: fn(p, x, l, wtab, a, k),
            lambda x, l: plain(plan, x, l, wtab, a, k), (wtab,), lane_ops, k,
            one_cta=one[fam])
    return res


def compare_legacy_kernels(sbt, ksw, topo, device) -> dict:
    """Phase 11: each legacy 128-wide sweep kernel against its plain
    version (the super-block plain version on a 128-wide plan) at
    north-star shapes, same inputs."""
    step, xw, alphas = perturbed_table(sbt, topo, device, superblocks=False)
    res = {}
    one = {fam: ksw.to_device(step.gpu_plans[fam], device, queues=1)
           for fam in ("edges", "tets")}
    # per live lane ~27 flops (edge) / ~150 (tet); the plain versions
    # take seconds here, so each is timed on its one checked call
    for name, fam, fn, plain, lane_ops in (
            ("legacy_edge_sweep", "edges", ksw.legacy_edge_sweep,
             ksw.edge_sweep_plain, 27),
            ("legacy_tet_sweep", "tets", ksw.legacy_tet_sweep,
             ksw.tet_sweep_plain, 150)):
        plan, a = step.device_plans[fam], alphas[fam]
        res[name] = compare_sweep(
            name, plan, xw, lambda x, l, p=plan: fn(p, x, l, a),
            lambda x, l: plain(plan, x, l, None, a), (), lane_ops,
            plain_reps=0, one_cta=one[fam])
    return res


def check_schedule(name, plan, one_cta, xw, lam0, kernel) -> None:
    """The sweep over its schedule's CTAs against the same kernel on one
    CTA (plan order): SCHEDULE_LAUNCHES back-to-back launches each from the
    same table, every launch's xw and lambda equal bit for bit.  Prints the
    schedule."""
    from softbodysim_torch.kernels import sweep as ksw

    st = plan.staged
    print(f"{name} schedule: Q {st.capacity}, CTAs used {st.queues}, "
          f"levels {st.levels}, length {st.length} blocks of "
          f"{st.qinfo.shape[0]} non-empty ({plan.num_blocks} in the plan); "
          f"largest block {st.max_rows} rows, {st.max_rec} record ints; "
          f"{st.nstages} stages, {st.smem_bytes} bytes of shared memory",
          flush=True)
    outs = []
    for p in (plan, one_cta):
        x, lam = xw.clone(), lam0.clone()
        snaps = []
        for _ in range(SCHEDULE_LAUNCHES):
            kernel(x, lam, p)
            snaps.append(torch.cat([x.float().reshape(-1), lam]))
        outs.append(torch.stack(snaps))
    torch.cuda.synchronize()
    ksw.raise_on_timeouts()
    diff = (outs[0] - outs[1]).abs().max().item()
    print(f"{name}: {st.queues} CTAs against one CTA over "
          f"{SCHEDULE_LAUNCHES} launches: max |diff| {diff:.3e}, bitwise "
          f"equal {torch.equal(outs[0], outs[1])}", flush=True)
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"{name}: the schedule on {st.queues} CTAs "
                             f"differs from one CTA ({diff})")


def compare_sweep(name, plan, xw, kernel, plain, tables, lane_ops: int,
                  k: int = 1, plain_reps: int = 2, one_cta=None) -> dict:
    """One sweep kernel against its plain version from the same table and
    zero lambdas; ``kernel(x, lam, plan=plan)`` / ``plain(x, lam)``, in
    place.  Checks the positions (X_TOL) and lambdas (LAM_REL_TOL) and the
    schedule against ``one_cta`` (``check_schedule``), times the kernel,
    on one CTA too, and the plain version (over ``plain_reps`` calls after
    a warm-up, or on its checked call when 0) and returns the kernel's
    result row.  The bound: xw and lambda read and written once, the
    tables the kernel stages and ``tables`` read once; per live lane
    ``lane_ops`` and per CSR entry 6 flops, per visit."""
    lam0 = torch.zeros(plan.num_blocks * plan.width, device=xw.device)
    xa, la = xw.clone(), lam0.clone()
    xb, lb = xw.clone(), lam0.clone()
    kernel(xa, la, plan)
    if plain_reps:
        plain(xb, lb)
    else:
        plain_ms = events_ms(lambda: plain(xb, lb), 1, warm=False)
    torch.cuda.synchronize()
    if not (torch.isfinite(xa).all() and torch.isfinite(la).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    ex = (xa - xb).abs().max().item()
    el = (la - lb).abs().max().item()
    lmax = lb.abs().max().item()
    moved = (xa - xw).abs().max().item()
    print(f"{name}: max|x_kernel - x_plain| = {ex:.3e} m (tol {X_TOL}),"
          f" max|lam diff| = {el:.3e} (max|lam| {lmax:.3e}, rel tol "
          f"{LAM_REL_TOL}), max move {moved:.3e} m", flush=True)
    if not ex <= X_TOL:
        raise AssertionError(f"{name}: positions disagree ({ex})")
    if not el <= LAM_REL_TOL * lmax:
        raise AssertionError(f"{name}: lambdas disagree ({el})")
    if not moved > 0.0:
        raise AssertionError(f"{name}: the sweep moved nothing")
    check_schedule(name, plan, one_cta, xw, lam0, kernel)
    x1, l1 = xw.clone(), lam0.clone()
    one_ms = kernel_ms(lambda: kernel(x1, l1, one_cta), 10)
    ms = kernel_ms(lambda: kernel(xa, la), 10)
    print(f"{name}: {ms:.4f} ms on {plan.staged.queues} CTAs, {one_ms:.4f} "
          f"ms on one CTA; the earlier one-CTA design "
          f"{ONE_CTA_DESIGN_MS[name]} ms",
          flush=True)
    if plain_reps:
        plain_ms = events_ms(lambda: plain(xb, lb), plain_reps)
    live = int((plan.verts[:, 0] >= 0).sum().item())
    st = plan.staged
    nb = (2 * nbytes(xw, lam0)
          + nbytes(st.lrow, plan.rest, plan.scale, plan.atab, *tables,
                   st.rec, st.qinfo, st.qptr))
    ops = k * (lane_ops * live + 6 * plan.lane.numel())
    return result(max(ex, el), ms, plain_ms, nb, ops)


def xpbd_main_path(sbt, topo, device) -> tuple:
    """Phase 3: the xpbd Engine on the card; (launch counts, ms/step of a
    timed window, the warm Engine)."""
    params = sbt.SolverParams(dialect="xpbd", substeps=8, iterations=1)
    reset_counts()
    t0 = time.perf_counter()
    eng = sbt.Engine(topo, params, device=device)
    if eng.backend != "sweep":
        raise AssertionError(f"backend {eng.backend!r}, expected 'sweep'")
    eng.run(32, DT)
    eng.step(DT)
    eng.block()
    counts = read_counts()
    pos = eng.positions()
    print(f"xpbd main path: backend={eng.backend}, 33 steps in "
          f"{time.perf_counter() - t0:.2f} s (incl. set-up), launches "
          f"{counts}", flush=True)
    if pos.shape != (topo.num_particles, 3):
        raise AssertionError(f"positions shape {pos.shape}")
    if not np.isfinite(pos).all():
        raise AssertionError("non-finite positions after 33 steps")
    if not pos[:, 1].min() >= -1e-4:
        raise AssertionError(f"min y {pos[:, 1].min()} below the ground")
    for name in ("w_fill", "edge_sweep", "tet_sweep"):
        if not counts[name] > 0:
            raise AssertionError(f"{name} was not launched: {counts}")
    drop = float(topo.vertices[:, 1].mean() - pos[:, 1].mean())
    print(f"positions finite, min y {pos[:, 1].min():.6f}, mean drop "
          f"{drop:.6f} m", flush=True)
    if not drop > 0.0:
        raise AssertionError("the body did not fall")

    return counts, window_ms(eng.backend, lambda n: eng.run(n, DT), 20), eng


def xpbd_reference_check(sbt, device, superblocks: bool) -> float:
    """Phase 6: small scene on the card vs the NumPy block oracle, which
    replays the plans at their own block width (1024 or 128)."""
    from oracle import XpbdOracle
    from softbodysim_torch.kernels.sweep_plan import block_width

    topo = sbt.meshes.tet_cube(4, 4, 4, size=0.5, center=(0.0, 0.6, 0.0))
    params = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=4,
                              xpbd_backend="sweep")
    eng = sbt.Engine(topo, params, superblocks=superblocks, device=device)
    step = eng._raw_step

    def blocks(plan):
        rows = plan.perm.reshape(-1, block_width(plan))
        scl = plan.scale.reshape(-1, block_width(plan))
        return [(r[r >= 0], s[r >= 0]) for r, s in zip(rows, scl)
                if (r >= 0).any()]

    eb, tb = blocks(step.block_order["edges"]), blocks(
        step.block_order["tets"])
    oracle = XpbdOracle(topo, params)
    oracle.w = eng.state.inv_mass.cpu().numpy().copy()
    for _ in range(10):
        eng.step(DT)
        oracle.step_blocks(DT, edge_blocks=eb, tet_blocks=tb,
                           **step.block_scheme)
    s = eng.state
    err = max(np.abs(s.x.cpu().numpy() - oracle.x).max(),
              np.abs(s.edge_lambda.cpu().numpy() - oracle.edge_lambda).max(),
              np.abs(s.tet_lambda.cpu().numpy() - oracle.tet_lambda).max())
    label = "super-blocks" if superblocks else "legacy 128-wide blocks"
    print(f"xpbd reference check ({label}, tet_cube(4), 10 steps vs block "
          f"oracle): max abs err {err:.3e} (tol {ORACLE_TOL})", flush=True)
    if not err <= ORACLE_TOL:
        raise AssertionError(f"port disagrees with the oracle ({err})")
    return err


def legacy_main_path(sbt, topo, device) -> tuple:
    """Phase 5: the xpbd Engine on the legacy 128-wide plans with a box
    just under the body; (launch counts, ms/step of a timed window, the
    warm Engine)."""
    from softbodysim_torch.solver import xpbd_sweep as txs

    t0 = time.perf_counter()
    _, _, _, ep, tp = txs.cached_plans(topo, superblocks=False)
    print(f"legacy host plans: {time.perf_counter() - t0:.2f} s (edge "
          f"blocks {ep.num_blocks}, dmax {ep.dmax}; tet blocks "
          f"{tp.num_blocks}, dmax {tp.dmax}; fill "
          f"{topo.num_edges / ep.capacity:.3f} / "
          f"{topo.num_tets / tp.capacity:.3f})", flush=True)
    params = sbt.SolverParams(dialect="xpbd", substeps=8, iterations=1)
    top = float(topo.vertices[:, 1].min()) - LEDGE_GAP
    box = sbt.Colliders.build([sbt.Colliders.box(
        (0.0, top - 0.1, 0.0), (1.5, 0.1, 1.5))], device=device)
    reset_counts()
    t0 = time.perf_counter()
    eng = sbt.Engine(topo, params, colliders=box, superblocks=False,
                     device=device)
    step = eng._raw_step
    if eng.backend != "sweep" or step.superblocks:
        raise AssertionError(f"backend {eng.backend!r}, expected the "
                             "legacy sweep backend")
    eng.run(8, DT)
    eng.step(DT)
    eng.block()
    counts = read_counts()
    pos = eng.positions()
    print(f"legacy path: 9 steps in {time.perf_counter() - t0:.2f} s "
          f"(incl. set-up), launches {counts}", flush=True)
    if pos.shape != (topo.num_particles, 3) or not np.isfinite(pos).all():
        raise AssertionError("non-finite or misshapen positions")
    free = eng.state.inv_mass.cpu().numpy() != 0
    min_y = float(pos[free, 1].min())
    print(f"positions finite, free min y {min_y:.6f} (box top {top:.6f})",
          flush=True)
    if not top - 1e-3 <= min_y <= top + 1e-2:
        raise AssertionError(f"the body is not resting on the box "
                             f"({min_y} against {top})")
    for name in ("legacy_edge_sweep", "legacy_tet_sweep", "collide"):
        if not counts[name] > 0:
            raise AssertionError(f"{name} was not launched: {counts}")

    return counts, window_ms(eng.backend, lambda n: eng.run(n, DT), 5), eng


def xpbd_collider_check(sbt, device) -> float:
    """Phase 7: tet_cube(4) onto a box whose pose rises after step 5, on
    the super-block sweep path on the card against the same step on the
    CPU (its plain versions, which the CPU tests hold against JAX)."""
    from softbodysim_torch.solver.xpbd_sweep import SweepStep

    topo = sbt.meshes.tet_cube(4, 4, 4, size=0.5, center=(0.0, 0.45, 0.0))
    params = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=4,
                              xpbd_backend="sweep")

    def box(y, dev):
        return sbt.Colliders.build([sbt.Colliders.box(
            (0.0, y, 0.0), (0.6, 0.1, 0.6))], device=dev)

    devs = (device, torch.device("cpu"))
    steps = {d: SweepStep(topo, params, box(0.1, d), device=d) for d in devs}
    state = sbt.init_state(topo, device="cpu")
    carries = {d: steps[d].pack_state(state) for d in devs}
    reset_counts()
    for y in [0.1] * 5 + [0.13] * 5:
        for d in devs:
            steps[d].run_carry(carries[d], DT, 1, colliders_rt=box(y, d))
    counts = read_counts()
    out = {d: steps[d].unpack_state(carries[d], state) for d in devs}
    err = max((getattr(out[device], f).cpu() - getattr(out[devs[1]], f))
              .abs().max().item() for f in ("x", "edge_lambda", "tet_lambda"))
    min_y = out[device].x[:, 1].min().item()
    print(f"xpbd colliders, super-blocks (tet_cube(4), box moved mid-run, "
          f"10 steps, card vs CPU): max abs err {err:.3e} (tol "
          f"{ORACLE_TOL}), min y {min_y:.6f}, collide launches "
          f"{counts['collide']}", flush=True)
    if not err <= ORACLE_TOL:
        raise AssertionError(f"card and CPU disagree ({err})")
    if not counts["collide"] == 10 * params.substeps * params.iterations:
        raise AssertionError(f"collide launches {counts}")
    if not min_y >= 0.23 - 1e-3:
        raise AssertionError(f"a particle is inside the moved box ({min_y})")
    return err


def coloured_checks(sbt, device) -> tuple:
    """Phase 8: the coloured Gauss-Seidel backend on the card; (ms/step of
    a timed window, the warm Engine on SampleScene's body)."""
    from oracle import XpbdOracle
    from softbodysim_torch.solver.select import resolve_backend

    ball = sbt.meshes.tet_ball(2, 0.3)
    topo = sbt.build_topology(
        ball.vertices - ball.vertices.mean(0)
        + np.array([0.0, 1.0, 0.0], np.float32), ball.tets)
    cols = sbt.Colliders.build(
        [sbt.Colliders.box((0.0, 0.1, 0.0), (0.6, 0.1, 0.6))], device=device)
    params = sbt.SolverParams(dialect="xpbd")
    alias = resolve_backend(topo, params.replace(xpbd_backend="scatter"),
                            device=device)
    if alias != "gather":
        raise AssertionError(f"'scatter' resolved to {alias!r}")
    reset_counts()
    t0 = time.perf_counter()
    eng = sbt.Engine(topo, params, colliders=cols, device=device)
    if eng.backend != "gather":
        raise AssertionError(f"backend {eng.backend!r}, expected 'gather'")
    eng.run(COLOURED_STEPS, DT)
    eng.block()
    counts = read_counts()
    pos = eng.positions()
    min_y = float(pos[:, 1].min())
    print(f"xpbd SampleScene body (V={topo.num_particles}, "
          f"T={topo.num_tets}, {len(topo.edge_colors.idx)} edge and "
          f"{len(topo.tet_colors.idx)} tet colours): backend="
          f"{eng.backend}, {COLOURED_STEPS} steps in "
          f"{time.perf_counter() - t0:.2f} s (one graph capture included), "
          f"min y {min_y:.6f} (box top {FLOOR_BOX_TOP}), launches {counts}",
          flush=True)
    if not np.isfinite(pos).all():
        raise AssertionError("non-finite positions")
    if not FLOOR_BOX_TOP - 1e-3 <= min_y <= FLOOR_BOX_TOP + 1e-2:
        raise AssertionError(f"the ball is not resting on its box "
                             f"({min_y})")
    if not counts["collide"] > 0:
        raise AssertionError(f"collide was not launched: {counts}")
    c_ms = window_ms(eng.backend, lambda n: eng.run(n, DT), 2)

    topo = sbt.meshes.tet_cube(3, 3, 3, size=0.5, center=(0.0, 0.6, 0.0))
    params = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=4,
                              xpbd_backend="gather")
    ref = sbt.Engine(topo, params, device=device)
    oracle = XpbdOracle(topo, params)
    oracle.w = ref.state.inv_mass.cpu().numpy().copy()
    for _ in range(10):
        ref.step(DT)
        oracle.step(DT, edge_order=topo.edge_colors.order,
                    tet_order=topo.tet_colors.order)
    s = ref.state
    err = max(np.abs(s.x.cpu().numpy() - oracle.x).max(),
              np.abs(s.edge_lambda.cpu().numpy() - oracle.edge_lambda).max(),
              np.abs(s.tet_lambda.cpu().numpy() - oracle.tet_lambda).max())
    print(f"xpbd reference check (gather, tet_cube(3), 10 steps vs the "
          f"serial oracle in colour order): max abs err {err:.3e} (tol "
          f"{ORACLE_TOL})", flush=True)
    if not err <= ORACLE_TOL:
        raise AssertionError(f"gather disagrees with the oracle ({err})")
    return c_ms, eng


# --------------------------------------------------------------------------
# Jacobi (phases 4, 9-11)
# --------------------------------------------------------------------------

def floor_box(sbt, device):
    return sbt.Colliders.build(
        [sbt.Colliders.box((0.0, 0.1, 0.0), (1.5, 0.1, 1.5))], device=device)


def compare_jacobi_kernels(sbt, topo, device) -> dict:
    """Phase 11: the Jacobi passes and the collide stage against their plain
    versions, from one predicted, perturbed state."""
    from softbodysim_torch.kernels import collide as kc
    from softbodysim_torch.kernels import jacobi as kj
    from softbodysim_torch.kernels import jacobi_plan

    params = sbt.SolverParams(**JACOBI)
    V, E, T = topo.num_particles, topo.num_edges, topo.num_tets
    plans = {}
    for name, make, cons, rest in (
            ("jacobi_edge_pass", kj.edge_pass_plan, topo.edges,
             topo.edge_rest),
            ("jacobi_tet_pass", kj.tet_pass_plan, topo.tets,
             topo.tet_rest_vol)):
        t0 = time.perf_counter()
        plan = plans[name] = make(V, cons, rest, device=device,
                                  vertices=topo.vertices,
                                  smem_budget=jacobi_plan.pass_budget(3))
        built = time.perf_counter() - t0
        print(f"{name} tile plan: {built:.2f} s; "
              f"{jacobi_describe(plan)}; "
              f"{kj.ctas_per_sm(plan)} CTAs per SM", flush=True)
    ep, tp = plans["jacobi_edge_pass"], plans["jacobi_tet_pass"]
    state = sbt.init_state(topo, inv_mass_mode="density", device=device)
    sdt = np.float32(DT) / np.float32(params.substeps)
    rng = np.random.default_rng(SEED + 1)
    noise = rng.normal(0.0, 1e-3, (V, 3)).astype(np.float32)
    x = state.x.clone()
    x[:, 1] -= float(np.float32(10.0) * sdt * sdt)
    x += torch.as_tensor(noise, device=device)
    xin = torch.cat([x, state.inv_mass[:, None]], 1).contiguous()
    k_e, k_t = float(np.float32(params.edge_stiffness)), float(
        np.float32(params.volume_stiffness))
    om = float(np.float32(params.sor_omega))
    res = {}

    # the function's own data, whatever implements it: the snapshot read
    # and the rows written once, each constraint's vertex ids, rest value
    # and (when given) stiffness read once; per edge ~22 flops, per tet
    # ~130 plus 3 per corner, per vertex apply 7
    passes = (
        ("jacobi_edge_pass", ep, k_e, kj.jacobi_edge_pass,
         kj.jacobi_edge_pass_plain,
         nbytes(xin, ep.edges, ep.rest, ep.k, xin), 22 * E + 7 * V),
        ("jacobi_tet_pass", tp, k_t, kj.jacobi_tet_pass,
         kj.jacobi_tet_pass_plain,
         nbytes(xin, tp.tets, tp.rest, tp.k, xin), 130 * T + 12 * T + 7 * V))
    for name, plan, k, fn, plain, nb, ops in passes:
        # the kernel reads k and omega from the device, as in the step
        kd, omd = (torch.tensor(v, dtype=torch.float32, device=device)
                   for v in (k, om))
        xa, xb = torch.empty_like(xin), torch.empty_like(xin)
        ca = torch.zeros(V, dtype=torch.int32, device=device)
        cb = torch.zeros_like(ca)
        fn(plan, xin, xa, kd, omd, ca)
        plain(plan, xin, xb, k, om, cb)
        torch.cuda.synchronize()
        if not torch.isfinite(xa).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        err = (xa - xb).abs().max().item()
        moved = (xa - xin).abs().max().item()
        same_cnt = torch.equal(ca, cb)
        print(f"{name}: max|x_kernel - x_plain| = {err:.3e} m (tol "
              f"{PASS_TOL}), counts equal {same_cnt} (max "
              f"{int(ca.max().item())}), max move {moved:.3e} m", flush=True)
        if not err <= PASS_TOL:
            raise AssertionError(f"{name}: positions disagree ({err})")
        if not same_cnt:
            raise AssertionError(f"{name}: counts disagree")
        if not moved > 0.0:
            raise AssertionError(f"{name}: the pass moved nothing")
        # a fixed summation order: every launch gives the same bits
        outs = torch.empty((PASS_LAUNCHES, V, 4), device=device)
        for i in range(PASS_LAUNCHES):
            fn(plan, xin, outs[i], kd, omd)
        torch.cuda.synchronize()
        same = bool((outs == xa).all().item())
        print(f"{name}: {PASS_LAUNCHES} launches bitwise equal {same}",
              flush=True)
        if not same:
            raise AssertionError(f"{name}: launches differ")
        res[name] = result(
            err, kernel_ms(lambda: fn(plan, xin, xa, kd, omd), 20),
            events_ms(lambda: plain(plan, xin, xb, k, om), 5), nb, ops)
        report(name, res[name])
    res.update(compare_fused_passes(sbt, params, passes, xin, device))
    res.update(compare_accumulate(passes, xin, device))

    # collide: the body moved down into the floor box and through the
    # ground plane, so both stages push
    packed = kc.pack_colliders(floor_box(sbt, device))
    ground = kc.make_ground(params)
    xc = xin.clone()
    xc[:, 1] -= 1.9
    xa, xb = xc.clone(), xc.clone()
    kc.collide(xa, packed, ground)
    xb = kc.collide_plain(xb, packed, ground)
    torch.cuda.synchronize()
    err = (xa - xb).abs().max().item()
    moved = (xa - xc).abs().max().item()
    free = int((xc[:, 3] != 0).sum().item())
    pushed = int(((xa - xc).abs().amax(1) > 0).sum().item())
    print(f"collide: max|x_kernel - x_plain| = {err:.3e} m (tol "
          f"{COLLIDE_TOL}), {pushed} of {free} free particles pushed, max "
          f"move {moved:.3e} m", flush=True)
    if not err <= COLLIDE_TOL:
        raise AssertionError(f"collide: positions disagree ({err})")
    if not pushed > 0:
        raise AssertionError("collide: nothing was pushed")
    # per particle: ground ~11 flops, an oriented box ~80
    nb = nbytes(xc, packed) + 12 * free
    res["collide"] = result(
        err, kernel_ms(lambda: kc.collide(xa, packed, ground), 20),
        events_ms(lambda: kc.collide_plain(xb, packed, ground), 5), nb,
        (11 + 80 * packed.shape[0]) * free)
    report("collide", res["collide"])
    return res


def compare_accumulate(passes, xin, device) -> dict:
    """Phase 11: the passes' accumulate-only mode (the kernel-sharded
    Jacobi step's) against its plain version (``edge_jacobi_deltas`` /
    ``tet_jacobi_deltas``) on phase 11's snapshot: sums within 1e-5 m,
    counts equal, PASS_LAUNCHES launches bit for bit.  Its data: the
    pass's reads and one 16-byte row written per vertex."""
    from softbodysim_torch.kernels import jacobi as kj

    kit = {"jacobi_edge_pass": (kj.jacobi_edge_accumulate,
                                kj.jacobi_edge_accumulate_plain),
           "jacobi_tet_pass": (kj.jacobi_tet_accumulate,
                               kj.jacobi_tet_accumulate_plain)}
    res = {}
    for name, plan, k, _, _, nb, ops in passes:
        fn, plain = kit[name]
        kd = torch.tensor(k, dtype=torch.float32, device=device)
        got, want = torch.empty_like(xin), torch.empty_like(xin)
        fn(plan, xin, got, kd)
        plain(plan, xin, want, k)
        outs = torch.empty((PASS_LAUNCHES,) + tuple(xin.shape),
                           device=device)
        for i in range(PASS_LAUNCHES):
            fn(plan, xin, outs[i], kd)
        torch.cuda.synchronize()
        err = (got[:, :3] - want[:, :3]).abs().max().item()
        same_cnt = torch.equal(got[:, 3], want[:, 3])
        same = bool((outs == got).all().item())
        big = got[:, :3].abs().max().item()
        print(f"{fn.__name__}: max|sum_kernel - sum_plain| {err:.3e} m (tol "
              f"{PASS_TOL}), counts equal {same_cnt}, largest |sum| "
              f"{big:.3e} m; {PASS_LAUNCHES} launches bitwise equal {same}",
              flush=True)
        if not (err <= PASS_TOL and same_cnt and same and big > 0.0):
            raise AssertionError(f"{fn.__name__}: disagrees with its plain "
                                 "version, or its launches differ")
        # the snapshot read and the table written are both (V, 4): nb
        # counts them already; no apply (7 flops per vertex fewer)
        res[fn.__name__] = result(
            err, kernel_ms(lambda: fn(plan, xin, got, kd), 20),
            events_ms(lambda: plain(plan, xin, want, k), 5), nb,
            ops - 7 * xin.shape[0])
        report(fn.__name__, res[fn.__name__])
    return res


def compare_fused_passes(sbt, params, passes, xin, device) -> dict:
    """Phase 11: each pass with the collide stage fused against the pass
    followed by the stand-alone collide kernel (bit for bit, 20 launches
    from one snapshot) and against its plain version, the body moved down
    into the floor box, a sphere and a capsule and through the ground
    plane; times the fused pass beside the pass alone on the same
    inputs.  ``passes``: phase 11's rows (name, plan, k, wrapper, plain,
    bytes, operations) of the passes alone."""
    from softbodysim_torch.kernels import collide as kc
    from softbodysim_torch.kernels import jacobi as kj

    q = (0.1826, 0.3651, 0.5477, 0.7303)
    packed = kc.pack_colliders(sbt.Colliders.build([
        sbt.Colliders.box((0.0, 0.1, 0.0), (1.5, 0.1, 1.5)),
        sbt.Colliders.sphere((0.1, 0.45, 0.0), 0.2),
        sbt.Colliders.capsule((-0.3, 0.5, 0.2), 0.1, 0.3, rotation=q)],
        device=device))
    ground = kc.make_ground(params)
    xf = xin.clone()
    xf[:, 1] -= 1.9
    free = int((xf[:, 3] != 0).sum().item())
    om = float(np.float32(params.sor_omega))
    fused_of = {"jacobi_edge_pass": kj.jacobi_edge_pass_collide,
                "jacobi_tet_pass": kj.jacobi_tet_pass_collide}
    res = {}
    for name, plan, k, fn, plain, nb, ops in passes:
        fused = fused_of[name]
        kd, omd = (torch.tensor(v, dtype=torch.float32, device=device)
                   for v in (k, om))
        want = torch.empty_like(xf)
        fn(plan, xf, want, kd, omd)
        moved = want.clone()
        kc.collide(want, packed, ground)
        stage = kc.collide_plain(moved.clone(), packed, ground)
        outs = torch.empty((PASS_LAUNCHES,) + tuple(xf.shape), device=device)
        for i in range(PASS_LAUNCHES):
            fused(plan, xf, outs[i], kd, omd, packed, ground)
        ref = torch.empty_like(xf)
        plain(plan, xf, ref, k, om)
        ref = kc.collide_plain(ref, packed, ground)
        torch.cuda.synchronize()
        same = bool((outs == want).all().item())
        err = (outs[0] - ref).abs().max().item()
        e_stage = (outs[0] - stage).abs().max().item()
        pushed = int(((want - moved).abs().amax(1) > 0).sum().item())
        pinned = xf[:, 3] == 0
        kept = torch.equal(outs[0][pinned], xf[pinned])
        print(f"{fused.__name__}: {PASS_LAUNCHES} launches bitwise equal to "
              f"{name} + collide: {same}; max|fused - plain| {err:.3e} m "
              f"(tol {PASS_TOL}); its collide stage against the plain "
              f"stage on the pass's rows: {e_stage:.3e} m (tol "
              f"{COLLIDE_TOL}); {pushed} of {free} free rows pushed; "
              f"pinned rows untouched: {kept}", flush=True)
        if not same:
            raise AssertionError(f"{fused.__name__}: differs from the pass "
                                 "and the collide kernel")
        if not (err <= PASS_TOL and e_stage <= COLLIDE_TOL):
            raise AssertionError(f"{fused.__name__}: disagrees with its "
                                 f"plain version ({err}, {e_stage})")
        if not (pushed > 0 and kept):
            raise AssertionError(f"{fused.__name__}: nothing pushed, or a "
                                 "pinned row moved")
        def plain_fused():
            plain(plan, xf, ref, k, om)
            kc.collide_plain(ref, packed, ground)

        xa = torch.empty_like(xf)
        ms = kernel_ms(lambda: fused(plan, xf, xa, kd, omd, packed, ground),
                       20)
        alone = kernel_ms(lambda: fn(plan, xf, xa, kd, omd), 20)
        print(f"{fused.__name__}: {ms:.4f} ms; {name} alone on the same "
              f"inputs {alone:.4f} ms (+{(ms - alone) * 1e3:.2f} us for "
              f"the stage)", flush=True)
        res[fused.__name__] = result(
            max(err, e_stage), ms, events_ms(plain_fused, 5),
            # the pass's data and the table; per free row the ground
            # (~11 flops) and ~80 flops per collider
            nb + nbytes(packed), ops + (11 + 80 * packed.shape[0]) * free)
        report(fused.__name__, res[fused.__name__])
    return res


def jacobi_main_path(sbt, topo, device) -> tuple:
    """Phase 4: the jacobi Engine at full width on the card; (launch
    counts, ms/step of a timed window, the warm Engine)."""
    reset_counts()
    t0 = time.perf_counter()
    eng = sbt.Engine(topo, sbt.SolverParams(**JACOBI),
                     colliders=floor_box(sbt, device), device=device)
    if eng.backend != "pass":
        raise AssertionError(f"backend {eng.backend!r}, expected 'pass'")
    eng.run(32, DT)
    eng.step(DT)
    eng.block()
    counts = read_counts()
    pos = eng.positions()
    print(f"jacobi main path: backend={eng.backend}, 33 steps in "
          f"{time.perf_counter() - t0:.2f} s (incl. set-up), launches "
          f"{counts}", flush=True)
    if pos.shape != (topo.num_particles, 3) or not np.isfinite(pos).all():
        raise AssertionError("non-finite or misshapen positions")
    free = eng.state.inv_mass.cpu().numpy() != 0
    min_y = float(pos[free, 1].min())
    drop = float(topo.vertices[:, 1].mean() - pos[:, 1].mean())
    print(f"positions finite, free min y {min_y:.6f} (box top "
          f"{FLOOR_BOX_TOP}), mean drop {drop:.6f} m", flush=True)
    if not min_y >= FLOOR_BOX_TOP - 1e-3:
        raise AssertionError(f"a free particle is inside the box ({min_y})")
    if not drop > 0.0:
        raise AssertionError("the body did not fall")
    for name in ("jacobi_edge_pass", "jacobi_tet_pass_collide"):
        if not counts[name] > 0:
            raise AssertionError(f"{name} was not launched: {counts}")
    # the collide stage runs inside the tet pass
    for name in ("collide", "jacobi_tet_pass"):
        if counts[name] != 0:
            raise AssertionError(f"{name} was launched on the pass path: "
                                 f"{counts}")
    if not eng._raw_step._graphs:
        raise AssertionError("the pass step captured no CUDA graph")

    return counts, window_ms(eng.backend, lambda n: eng.run(n, DT), 20), eng


def jacobi_variant_paths(sbt, topo, device) -> dict:
    """Phase 4, the pass path's other variants on the full cube, 4 steps
    each: its edges alone on the floor box (the collide stage fused into
    the edge pass) and the whole cube with no ground and no colliders (no
    collide stage); their launch counts, added up."""
    import dataclasses

    edges_only = dataclasses.replace(
        topo, tets=np.zeros((0, 4), np.int32),
        tet_rest_vol=np.zeros(0, np.float32))
    total = collections.Counter()
    for label, mesh, cols, ground, want, never in (
            ("edges only, floor box", edges_only, floor_box(sbt, device),
             True, ("jacobi_edge_pass_collide",),
             ("jacobi_edge_pass", "collide")),
            ("no ground, no colliders", topo, None, False,
             ("jacobi_edge_pass", "jacobi_tet_pass"),
             ("jacobi_tet_pass_collide", "collide"))):
        params = sbt.SolverParams(**{**JACOBI, "ground_enabled": ground})
        reset_counts()
        eng = sbt.Engine(mesh, params, colliders=cols, device=device)
        if eng.backend != "pass":
            raise AssertionError(f"{label}: backend {eng.backend!r}")
        eng.run(4, DT).block()
        counts = read_counts()
        pos = eng.positions()
        print(f"jacobi pass path, {label}: 4 steps, min y "
              f"{pos[:, 1].min():.6f}, launches {counts}", flush=True)
        if not np.isfinite(pos).all():
            raise AssertionError(f"{label}: non-finite positions")
        for name in want:
            if not counts[name] > 0:
                raise AssertionError(f"{label}: {name} was not launched")
        for name in never:
            if counts[name] != 0:
                raise AssertionError(f"{label}: {name} was launched")
        total.update(counts)
    return dict(total)


def jacobi_ball_path(sbt, device) -> tuple:
    """Phase 4: tet_ball(6, 0.3) (every tet holds the centre vertex) on the
    floor box with jacobi_backend="auto" -> 'pass', its centre a heavy
    vertex; BALL_STEPS steps, each held against the same Engine on the
    CPU's 'gather' backend at ``ball_tol`` of the CPU's own spread (its
    'gather' Engine against a second one started one ulp away, every
    coordinate moved to the next float32 up, at that step); then timed;
    (ms/step, the warm Engine)."""
    t0 = time.perf_counter()
    topo = sbt.meshes.tet_ball(6, 0.3, center=(0.0, 0.55, 0.0))
    print(f"tet_ball(6, 0.3): V={topo.num_particles} E={topo.num_edges} "
          f"T={topo.num_tets} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    params = sbt.SolverParams(**JACOBI)
    reset_counts()
    t0 = time.perf_counter()
    eng = sbt.Engine(topo, params, colliders=floor_box(sbt, device),
                     device=device)
    if eng.backend != "pass":
        raise AssertionError(f"backend {eng.backend!r}, expected 'pass'")
    step = eng._raw_step
    for plan in (step.edge_plan, step.tet_plan):
        print(f"tet_ball(6) tile plan: {jacobi_describe(plan)}", flush=True)
        if plan.tiles.heavy.tolist() != [topo.num_particles - 1]:
            raise AssertionError("the centre is not the one heavy vertex")
    cards = []
    for _ in range(BALL_STEPS):
        cards.append(eng.run(1, DT).positions())
    counts = read_counts()
    print(f"tet_ball(6) pass path: {BALL_STEPS} steps in "
          f"{time.perf_counter() - t0:.2f} s (incl. set-up), launches "
          f"{counts}", flush=True)
    t0 = time.perf_counter()
    refs = cpu_spread_engines(sbt, topo, params)
    rows = []
    for n, pos in enumerate(cards, 1):
        want, other = (r.run(1, DT).positions() for r in refs)
        err = float(np.abs(pos - want).max())
        spread = float(np.abs(want - other).max())
        rows.append(dict(step=n, card_vs_gather=err,
                         gather_vs_one_ulp=spread, tol=ball_tol(spread),
                         finite=bool(np.isfinite(pos).all())))
    free = eng.state.inv_mass.cpu().numpy() != 0
    min_y = float(cards[-1][free, 1].min())
    print(json.dumps({"tet_ball6_per_step": rows}), flush=True)
    print(f"tet_ball(6): card 'pass' vs CPU 'gather', {BALL_STEPS} steps: "
          f"max abs err {max(r['card_vs_gather'] for r in rows):.3e}; "
          f"free min y {min_y:.6f} (box top {FLOOR_BOX_TOP}); CPU runs "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for r in rows:
        if not (r["finite"] and r["card_vs_gather"] <= r["tol"]):
            raise AssertionError(f"tet_ball(6): card and CPU disagree: {r}")
    if not min_y >= FLOOR_BOX_TOP - 1e-3:
        raise AssertionError(f"tet_ball(6) went into the box ({min_y})")
    for name in ("jacobi_edge_pass", "jacobi_tet_pass_collide"):
        if not counts[name] > 0:
            raise AssertionError(f"{name} was not launched: {counts}")
    if counts["collide"] != 0:
        raise AssertionError(f"collide was launched: {counts}")
    return window_ms(eng.backend, lambda n: eng.run(n, DT), 20), eng


def cpu_spread_engines(sbt, topo, params) -> list:
    """Two CPU 'gather' Engines on the floor box, the second started one
    ulp away (every coordinate at the next float32 up): how far they part
    at a step is the CPU's own spread there, the sensitivity of the run
    to rounding-level differences such as two summation orders."""
    refs = [sbt.Engine(topo, params.replace(jacobi_backend="gather"),
                       colliders=floor_box(sbt, "cpu"), device="cpu")
            for _ in range(2)]
    s0 = refs[1].state
    x = torch.nextafter(s0.x, torch.full_like(s0.x, math.inf))
    refs[1].state = sbt.SimState(
        x=x, v=s0.v, x_star=x, inv_mass=s0.inv_mass,
        edge_lambda=s0.edge_lambda, tet_lambda=s0.tet_lambda)
    return refs


def ball_tol(spread: float) -> float:
    """The card's tolerance against the CPU 'gather' Engine at a step of
    tet_ball(6) where that Engine and a second one started one ulp away
    part by ``spread``: ORACLE_TOL, or ten times the CPU's own spread
    where that is larger."""
    return max(ORACLE_TOL, 10.0 * spread + 1e-6)


def jacobi_describe(plan) -> str:
    """A pass plan's tile plan in one line (``jacobi_plan.describe``)."""
    from softbodysim_torch.kernels import jacobi_plan

    return jacobi_plan.describe(plan.tiles, plan.tiles.rest.shape[0],
                                plan.rest.shape[0])


def jacobi_eager_ms(eng, steps: int) -> float:
    """Host-clock ms/step of the warm jacobi Engine's pass step run
    eagerly -- kernel by kernel, no graph -- on a copy of its state (a
    diagnostic beside the graphed step): three windows of ``steps`` steps
    after a warm one, printed; their median."""
    from softbodysim_torch.kernels import collide as kc

    step = eng._raw_step
    carry = step.pack_state(eng.state)
    scalars = step._scalars(DT)
    packed = kc.pack_colliders(step.colliders, step.device)
    substeps = steps * max(1, step.params.substeps)
    ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        carry = step._run_eager(carry, substeps, scalars, packed)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / steps)
    print(f"pass, eager (diagnostic): ms/step in 3 windows of {steps} "
          f"steps: {', '.join(f'{m:.4f}' for m in ms[1:])}", flush=True)
    return float(np.median(ms[1:]))


def jacobi_override_ms(eng, steps: int) -> float:
    """Host-clock ms/step of the warm jacobi Engine stepped one step at a
    time with stiffness and omega overrides that change every step (a
    diagnostic: the graphs read the step scalars from the device, so no
    step captures a new graph); three windows after a warm one, printed;
    their median."""
    step = eng._raw_step
    graphs = len(step._graphs)
    ms = []
    for w in range(4):
        t0 = time.perf_counter()
        for i in range(steps):
            d = 1e-3 * (w * steps + i)
            eng.step(DT, edge_stiffness=0.9 - d, volume_stiffness=0.98 - d,
                     sor_omega=1.4 - d)
        eng.block()
        ms.append((time.perf_counter() - t0) * 1e3 / steps)
    print(f"pass, graphed, overrides changing every step (diagnostic): "
          f"ms/step in 3 windows of {steps} steps: "
          f"{', '.join(f'{m:.4f}' for m in ms[1:])}; graphs "
          f"{graphs} -> {len(step._graphs)}", flush=True)
    if len(step._graphs) != graphs:
        raise AssertionError("a step-time override captured a new graph")
    return float(np.median(ms[1:]))


def coloured_override_ms(eng, steps: int) -> tuple:
    """Host-clock ms/step of the warm coloured Engine stepped one step at a
    time with an edge compliance that changes every step (a diagnostic:
    the graph reads the compliance scalars from the device, so no step
    after the first captures a graph); three windows after a warm one,
    printed, then raise if a window captured a graph; (their median, the
    CUDA graphs captured in the windows)."""
    captures = []
    begin = torch.cuda.CUDAGraph.capture_begin

    def counted(self, *a, **k):
        captures.append(1)
        return begin(self, *a, **k)

    torch.cuda.CUDAGraph.capture_begin = counted
    try:
        ms = []
        for w in range(4):
            if w == 1:
                captures.clear()
            t0 = time.perf_counter()
            for i in range(steps):
                eng.step(DT, edge_compliance=1e-7 * (1 + w * steps + i))
            eng.block()
            ms.append((time.perf_counter() - t0) * 1e3 / steps)
    finally:
        torch.cuda.CUDAGraph.capture_begin = begin
    print(f"coloured, compliance changing every step (diagnostic): ms/step "
          f"in 3 windows of {steps} steps: "
          f"{', '.join(f'{m:.4f}' for m in ms[1:])}; CUDA graphs captured "
          f"in them: {len(captures)}", flush=True)
    if captures:
        raise AssertionError("a compliance override captured a graph")
    return float(np.median(ms[1:])), len(captures)


def sample_scene(sbt, device) -> dict:
    """Phase 9: SampleScene's body and box through the jacobi gather
    backend."""
    ball = sbt.meshes.tet_ball(2, 0.3)
    topo = sbt.build_topology(
        ball.vertices - ball.vertices.mean(0)
        + np.array([0.0, 1.0, 0.0], np.float32), ball.tets)
    params = sbt.SolverParams(**{**JACOBI, "edge_stiffness": 0.7,
                                 "volume_stiffness": 1.0,
                                 "particle_radius": 0.01})
    cols = sbt.Colliders.build(
        [sbt.Colliders.box((0.0, 0.1, 0.0), (0.6, 0.1, 0.6))], device=device)
    reset_counts()
    eng = sbt.Engine(topo, params, colliders=cols, density=0.2,
                     device=device)
    if eng.backend != "gather":
        raise AssertionError(f"backend {eng.backend!r}, expected 'gather'")
    eng.run(60, DT)
    eng.block()
    counts = read_counts()
    pos = eng.positions()
    print(f"SampleScene body (V={topo.num_particles}, T={topo.num_tets}): "
          f"backend={eng.backend}, 60 steps, min y {pos[:, 1].min():.6f}, "
          f"launches {counts}", flush=True)
    if not np.isfinite(pos).all():
        raise AssertionError("non-finite positions")
    if not pos[:, 1].min() >= FLOOR_BOX_TOP - 1e-3:
        raise AssertionError("the ball went into its box")
    if not counts["collide"] > 0:
        raise AssertionError(f"collide was not launched: {counts}")
    return counts


def jacobi_reference_check(sbt, device) -> float:
    """Phase 10: tet_cube(3) on the card (pass and gather) vs
    JacobiOracle."""
    from oracle import JacobiOracle

    topo = sbt.meshes.tet_cube(3, 3, 3, size=0.5, center=(0.0, 0.55, 0.0))
    box = sbt.Colliders.box((0.0, 0.1, 0.0), (0.6, 0.1, 0.6))
    engines = {b: sbt.Engine(
        topo, sbt.SolverParams(**JACOBI, jacobi_backend=b),
        colliders=sbt.Colliders.build([box], device=device), device=device)
        for b in ("pass", "gather")}
    oracle = JacobiOracle(topo, sbt.SolverParams(**JACOBI), colliders=[box])
    for _ in range(10):
        oracle.step(DT)
        for eng in engines.values():
            eng.step(DT)
    err = 0.0
    for b, eng in engines.items():
        e = float(np.abs(eng.positions() - oracle.x).max())
        print(f"jacobi reference check ({b}, tet_cube(3) onto a box, 10 "
              f"steps vs JacobiOracle): max abs err {e:.3e} (tol "
              f"{ORACLE_TOL}); oracle min y {oracle.x[:, 1].min():.4f}",
              flush=True)
        if not e <= ORACLE_TOL:
            raise AssertionError(f"{b} disagrees with the oracle ({e})")
        err = max(err, e)
    return err


# --------------------------------------------------------------------------
# Scenes and convergence (phases A-F)
# --------------------------------------------------------------------------

# The JAX package's record of the 'auto' block scheme on the north star
# (ss2 x it6, 120 steps, 30-step tail means) and the serial Gauss-Seidel
# anchors (PLAN.md:174-200): residuals, not speeds, so they carry over.
CONV_STEPS, CONV_TAIL = 120, 30
CONV_JAX_RECORD = {"edge": 0.2328, "tet": 0.4892}
CONV_SERIAL = {"edge": 0.2540, "tet": 0.6081}
# a jacobi body of a merged program against its solo Engine: the Jacobi
# dialect is body-independent, only fp32 summation orders differ
SCENE_TOL = 1e-4
# a batch's scenes against their solo Engines on the card
BATCH_TOL = 1e-6
# the scene checks' deformed start: position noise, m
JITTER = 0.01
# a merged body against a solo Engine with another body's material must be
# this many SCENE_TOL off, else the check could not see a wrong table
SWAP_FACTOR = 10.0


def deform(eng, seed: int) -> None:
    """Move an Engine's positions (x and x_star) by N(0, JITTER), drawn on
    the host from ``seed``: a card and a CPU Engine get the same start."""
    import dataclasses

    s = eng.state
    noise = np.random.default_rng(seed).normal(
        0.0, JITTER, tuple(s.x.shape)).astype(np.float32)
    x = s.x + torch.from_numpy(noise).to(s.x.device)
    eng.state = dataclasses.replace(s, x=x, x_star=x.clone())


def off_rest(topo, x) -> str:
    """How many constraints of ``topo`` at positions ``x`` are more than
    1e-5 of their rest value away from it: the corrections a check of
    their stiffness or compliance can see."""
    e, t = topo.edges.astype(np.int64), topo.tets.astype(np.int64)
    length = np.linalg.norm(x[e[:, 0]] - x[e[:, 1]], axis=1)
    ne = int((np.abs(length - topo.edge_rest)
              > 1e-5 * np.abs(topo.edge_rest)).sum())
    vol = np.einsum("ij,ij->i", np.cross(x[t[:, 1]] - x[t[:, 0]],
                                         x[t[:, 2]] - x[t[:, 0]]),
                    x[t[:, 3]] - x[t[:, 0]]) / 6.0
    nt = int((np.abs(vol - topo.tet_rest_vol)
              > 1e-5 * np.abs(topo.tet_rest_vol)).sum())
    return (f"{ne}/{len(e)} edges and {nt}/{len(t)} tets start off rest")


def merged_vs_solo(sbt, eng, voffs, bodies, knob, backend, steps,
                   seed) -> tuple:
    """The merged Engine ``eng`` (its current state deformed) and a solo
    Engine per body from its slice of that start, ``steps`` steps; solos
    with the material of the body half the list away too.  (off-rest
    summary, max err against the own material, min over bodies of the
    max err against the other material)."""
    import dataclasses

    deform(eng, seed)
    start = eng.state
    summary = off_rest(eng.topology, start.x.cpu().numpy())
    runs = []
    for shift in (0, len(bodies) // 2):
        solos = []
        for i, (_, topo, _, _) in enumerate(bodies):
            params = bodies[(i + shift) % len(bodies)][2]
            solo = sbt.Engine(topo, params.replace(**{knob: backend}),
                              device=eng.device)
            sl = slice(int(voffs[i]), int(voffs[i + 1]))
            solo.state = dataclasses.replace(
                solo.state, x=start.x[sl].clone(), v=start.v[sl].clone(),
                x_star=start.x[sl].clone())
            solos.append(solo.run(steps, DT))
        runs.append(solos)
    eng.run(steps, DT)
    merged = eng.positions()
    errs = [[float(np.abs(merged[voffs[i]:voffs[i + 1]]
                          - s.positions()).max())
             for i, s in enumerate(solos)] for solos in runs]
    return summary, max(errs[0]), min(errs[1])


def check_launched(counts: dict, names, label: str) -> None:
    for name in names:
        if not counts[name] > 0:
            raise AssertionError(f"{label}: {name} was not launched: "
                                 f"{counts}")


def convergence_at_scale(sbt, topo, device) -> dict:
    """Phase A: run_curves 'blocks_pallas' (the sweep kernels) on the
    north star, ss2 x it6, 120 steps; the 30-step tails against the JAX
    record and the serial anchors."""
    from softbodysim_torch.perf.convergence import run_curves

    params = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=6)
    reset_counts()
    t0 = time.perf_counter()
    curves = run_curves(topo, params, CONV_STEPS,
                        orderings=("blocks_pallas",), device=device)
    counts = read_counts()
    c = curves["blocks_pallas"]
    tails = {fam: float(np.mean(c[fam][-CONV_TAIL:])) for fam in ("edge",
                                                                  "tet")}
    print(f"phase A convergence (tet_cube(47), ss2 x it6, 'auto' scheme, "
          f"{CONV_STEPS} steps on the sweep kernels, "
          f"{time.perf_counter() - t0:.1f} s): launches {counts}",
          flush=True)
    for fam, tail in tails.items():
        print(f"  {fam} residual, {CONV_TAIL}-step tail mean {tail:.4f}: "
              f"{tail / CONV_SERIAL[fam]:.3f}x the serial anchor "
              f"{CONV_SERIAL[fam]}, {tail / CONV_JAX_RECORD[fam]:.3f}x the "
              f"JAX record {CONV_JAX_RECORD[fam]}", flush=True)
    print(json.dumps({"convergence": {
        "tails": tails, "jax_record": CONV_JAX_RECORD,
        "serial_anchor": CONV_SERIAL,
        "energy_first_last": [float(c["energy"][0]),
                              float(c["energy"][-1])]}}), flush=True)
    check_launched(counts, ("w_fill", "edge_sweep", "tet_sweep"), "phase A")
    if not all(np.isfinite(c[k]).all() for k in c):
        raise AssertionError("non-finite convergence curves")
    for fam, tail in tails.items():
        if not tail <= CONV_SERIAL[fam]:
            raise AssertionError(f"the {fam} tail {tail} is above the "
                                 f"serial anchor {CONV_SERIAL[fam]}")
    return tails


def partitioned_bodies(sbt, scenes, full: bool) -> list:
    """bench.py's partitioned_mixed_dialect world (bench.py:214-227): 10
    jacobi cubes with 10 edge stiffnesses and 10 xpbd cubes; ``full``
    False: a reduced copy of the same mix (2 + 2 small cubes)."""
    px = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=6)
    n = 10 if full else 2
    bodies = []
    for i in range(n):
        cells = ((11 + (i % 3), 11 + ((i + 1) % 2), 11) if full
                 else (3 + i, 3, 4))
        t = sbt.meshes.tet_cube(*cells, size=0.5,
                                center=(i * 1.2 - 6.0, 1.0, -1.0))
        bodies.append((f"j{i}", t, scenes._params(edge=0.5 + 0.04 * i,
                                                  vol=1.0), {}))
    for i in range(n):
        cells = ((20 + (i % 3), 20 + ((i + 1) % 2), 20) if full
                 else (4, 3 + i, 3))
        t = sbt.meshes.tet_cube(*cells, size=1.0,
                                center=(i * 1.5 - 7.0, 1.2, 1.5))
        bodies.append((f"x{i}", t, px, {}))
    return bodies


def check_compliance_tables(eng) -> int:
    """The sweep Engine's per-constraint compliance in its plans, read
    back through the constraint each packed slot solves (the slot's layout
    vertices matched to the public constraint with the same vertices):
    every live slot must hold that constraint's compliance, every pad slot
    0.  Returns the live slots checked."""
    step = eng._raw_step
    old2new = step._old2new.cpu().numpy()
    live_slots = 0
    for fam, cons, table in (("edges", eng.topology.edges, step._edge_c),
                             ("tets", eng.topology.tets, step._tet_c)):
        plan = step.gpu_plans[fam]
        if table is None or plan.atab is None:
            raise AssertionError(f"no {fam} compliance table")
        public = {tuple(sorted(r)): i for i, r in enumerate(
            old2new[cons.astype(np.int64)].tolist())}
        live = plan.verts[:, 0] >= 0
        ids = [public[tuple(sorted(r))] for r in plan.verts[live].tolist()]
        want = np.maximum(np.asarray(table, np.float32), 0.0)[ids]
        if (sorted(ids) != list(range(len(cons)))
                or not np.array_equal(plan.atab[live], want)
                or plan.atab[~live].any()):
            raise AssertionError(f"the {fam} compliance table does not "
                                 f"follow its constraints")
        live_slots += int(live.sum())
    return live_slots


def partitioned_path(sbt, device) -> tuple:
    """Phase B: partitioned_mixed_dialect at full size; (ms/step, host
    plan s, [(label, program Engine, its own ms/step)])."""
    from softbodysim_torch.api import scenes

    t0 = time.perf_counter()
    bodies = partitioned_bodies(sbt, scenes, full=True)
    t_topo = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    part = scenes.Scene(name="partitioned_mixed", colliders=[],
                        bodies=bodies).build_partitioned(backend="pallas",
                                                         device=device)
    t_plan = time.perf_counter() - t0
    backends = [e.backend for e, _, _ in part.entries]
    sizes = [(e.topology.num_particles,
              e.topology.num_edges + e.topology.num_tets)
             for e, _, _ in part.entries]
    print(f"phase B partitioned_mixed_dialect: 20 bodies, V "
          f"{sum(t.num_particles for _, t, _, _ in bodies)}, constraints "
          f"{sum(t.num_edges + t.num_tets for _, t, _, _ in bodies)}; "
          f"topologies {t_topo:.2f} s, build_partitioned (host plans) "
          f"{t_plan:.2f} s; programs {part.num_programs}, backends "
          f"{backends}, (V, constraints) {sizes}", flush=True)
    if part.num_programs != 2 or backends != ["pass", "sweep"]:
        raise AssertionError(f"expected 2 programs on ('pass', 'sweep'): "
                             f"{backends}")
    part.run(32, DT)
    counts = read_counts()
    print(f"phase B launches (32 warm steps): {counts}", flush=True)
    check_launched(counts, ("jacobi_edge_pass", "jacobi_tet_pass_collide",
                            "w_fill", "edge_sweep", "tet_sweep"), "phase B")
    ms = window_ms("phase B partitioned_mixed_dialect", part.run, 32)
    # each program alone, for its profile's busy share
    programs = [(f"partitioned_mixed_dialect {e.backend} program", e,
                 window_ms(e.backend, lambda n: e.run(n, DT), 32))
                for e, _, _ in part.entries]
    pos = part.positions()
    bad = [n for n, x in pos.items() if not np.isfinite(x).all()]
    if bad or len(pos) != 20:
        raise AssertionError(f"non-finite bodies {bad}")

    # each jacobi body of the merged 'pass' program against its solo
    # 'pass' Engine, 4 steps from its state after the windows, deformed
    jeng, jnames, voffs = part.entries[0]
    summary, err, other = merged_vs_solo(sbt, jeng, voffs, bodies[:10],
                                         "jacobi_backend", "pass", 4, 50)
    print(f"phase B jacobi bodies of the merged 'pass' program vs their "
          f"solo 'pass' Engines, 4 steps from the windows' end state "
          f"deformed ({summary}): max abs err {err:.3e} (tol {SCENE_TOL}); "
          f"vs solo Engines with the stiffness of the body 5 away: min "
          f"over bodies {other:.3e} (must exceed "
          f"{SWAP_FACTOR * SCENE_TOL})", flush=True)
    if not err <= SCENE_TOL:
        raise AssertionError(f"merged jacobi bodies disagree ({err})")
    if not other > SWAP_FACTOR * SCENE_TOL:
        raise AssertionError(f"the check cannot tell the bodies' "
                             f"stiffness apart ({other})")

    # a reduced copy of the mix, the card against the CPU
    small = partitioned_bodies(sbt, scenes, full=False)
    runs = {}
    for dev in (device, torch.device("cpu")):
        eng = scenes.Scene(name="mix", colliders=[], bodies=small
                           ).build_partitioned(backend="pallas", device=dev)
        for i, (e, _, _) in enumerate(eng.entries):
            deform(e, 60 + i)
        if dev.type == "cuda":
            summary = "; ".join(off_rest(e.topology,
                                         e.state.x.cpu().numpy())
                                for e, _, _ in eng.entries)
        for _ in range(10):
            eng.step(DT)
        runs[dev.type] = eng.positions()
    err = max(float(np.abs(runs["cuda"][n] - runs["cpu"][n]).max())
              for n in runs["cpu"])
    print(f"phase B reduced mix (2 + 2 cubes), card vs CPU, 10 steps from "
          f"a deformed start ({summary}): max abs err {err:.3e} (tol "
          f"{SCENE_TOL})", flush=True)
    if not err <= SCENE_TOL:
        raise AssertionError(f"the reduced mix disagrees with the CPU "
                             f"({err})")

    # two xpbd cubes with their own compliance: the sweep kernels with
    # edge_c / tet_c tables.  Small cubes, whose merged sweep plans order
    # each body's constraints as its solo plans do, against solo 'sweep'
    # Engines (no table); larger ones against the CPU, their tables read
    # back through the constraint each packed slot solves
    base = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=6)
    materials = (base.replace(edge_compliance=1e-4, volume_compliance=0.0),
                 base.replace(edge_compliance=5e-3, volume_compliance=1e-3))

    def pair(n):
        return scenes.Scene(name="compliance", colliders=[], bodies=[
            (f"b{i}", sbt.meshes.tet_cube(n, n, n - i, size=0.4,
                                          center=(1.2 * i - 0.6, 0.25, 0.0)),
             p, {}) for i, p in enumerate(materials)])

    reset_counts()
    scene = pair(3)
    xeng, voffs = scene.build_merged(backend="pallas", device=device)
    summary, err, other = merged_vs_solo(sbt, xeng, voffs, scene.bodies,
                                         "xpbd_backend", "sweep", 10, 70)
    counts = read_counts()
    check_launched(counts, ("w_fill", "edge_sweep", "tet_sweep"),
                   "phase B compliance")
    scene = pair(8)
    runs = {}
    for dev in (device, torch.device("cpu")):
        eng, _ = scene.build_merged(backend="pallas", device=dev)
        deform(eng, 71)
        runs[dev.type] = eng.run(10, DT).positions()
    err_cpu = float(np.abs(runs["cuda"] - runs["cpu"]).max())
    slots = check_compliance_tables(eng)
    print(f"phase B mixed compliance (2 xpbd cubes, sweep kernels with "
          f"edge_c / tet_c; launches {counts}): tet_cube(3) merged vs solo "
          f"'sweep' Engines, 10 steps ({summary}), max abs err {err:.3e} "
          f"(tol {SCENE_TOL}); vs the other body's compliance {other:.3e} "
          f"(must exceed {SWAP_FACTOR * SCENE_TOL}); tet_cube(8) card vs "
          f"CPU {err_cpu:.3e} (tol {SCENE_TOL}); its {slots} live plan "
          f"slots hold their constraint's compliance", flush=True)
    if not max(err, err_cpu) <= SCENE_TOL:
        raise AssertionError(f"the mixed-compliance merge disagrees "
                             f"({err}, {err_cpu})")
    if not other > SWAP_FACTOR * SCENE_TOL:
        raise AssertionError(f"the check cannot tell the bodies' "
                             f"compliance apart ({other})")
    return ms, t_plan, programs


def batch_test_path(sbt, device) -> tuple:
    """Phase C: BatchTest merged into one 'pass' program; (ms/step, the
    warm Engine)."""
    from softbodysim_torch.api import scenes

    scene = scenes.batch_test()
    reset_counts()
    t0 = time.perf_counter()
    eng, voffs = scene.build_merged(device=device)
    t_plan = time.perf_counter() - t0
    auto_backend = scene.build_merged(backend="auto",
                                      device=device)[0].backend
    topo = eng.topology
    print(f"phase C BatchTest merged (procedural stand-ins: the "
          f"reference's assets are absent): {len(scene.bodies)} bodies, V "
          f"{topo.num_particles}, constraints "
          f"{topo.num_edges + topo.num_tets}; build {t_plan:.2f} s; "
          f"backend {eng.backend}, 'auto' -> {auto_backend}", flush=True)
    if eng.backend != "pass" or auto_backend != "pass":
        raise AssertionError(f"BatchTest merged on {eng.backend!r} / auto "
                             f"{auto_backend!r}, expected 'pass'")
    eng.run(eng.RUN_CHUNK, DT)
    eng.block()
    counts = read_counts()
    print(f"phase C launches (one warm RUN_CHUNK): {counts}", flush=True)
    check_launched(counts, ("jacobi_edge_pass", "jacobi_tet_pass_collide"),
                   "phase C")
    if counts["collide"] or counts["jacobi_tet_pass"]:
        raise AssertionError(f"the collide stage ran outside the tet pass: "
                             f"{counts}")
    ms = window_ms("phase C BatchTest merged", lambda n: eng.run(n, DT),
                   2 * eng.RUN_CHUNK)
    pos = eng.positions()
    if not np.isfinite(pos).all():
        raise AssertionError("non-finite BatchTest positions")
    return ms, eng


def batched_path(sbt, device) -> tuple:
    """Phase D: bench.py's batched_128x_jacobi (bench.py:174-192) on the
    'gather' backend, one step for all 128 scenes; (ms/step, proj/s, the
    warm batch for profile_window)."""
    from softbodysim_torch.parallel import BatchedEngine

    topo = sbt.meshes.tet_cube(10, 10, 10, size=0.8, center=(0.0, 1.0, 0.0))
    params = sbt.SolverParams(**{**JACOBI, "jacobi_backend": "gather"})
    batch, steps = 128, 50
    reset_counts()
    eng = BatchedEngine(topo, params, batch=batch, pos_jitter=0.002,
                        key=torch.Generator().manual_seed(SEED),
                        device=device)
    eng.step(DT)
    eng.block()
    counts = read_counts()

    def run(n):
        for _ in range(n):
            eng.step(DT)

    ms = window_ms("phase D batched_128x_jacobi", run, steps)
    proj = (batch * (topo.num_edges + topo.num_tets) * params.iterations
            * params.substeps * 1e3 / ms)
    print(f"phase D batched_128x_jacobi (tet_cube(10): V "
          f"{topo.num_particles}, E {topo.num_edges}, T {topo.num_tets}; "
          f"B {batch}, backend {eng.backend}): {ms:.4f} ms/step, "
          f"proj_per_sec {proj:.4e}; launches in one step {counts}",
          flush=True)
    if not np.isfinite(eng.positions()).all():
        raise AssertionError("non-finite batched positions")

    # B = 4, no jitter, a box: the collide kernel once per iteration for
    # all 4 scenes; each scene against the solo 'gather' Engine (the four
    # solo Engines of identical scenes are one)
    box = sbt.Colliders.build(
        [sbt.Colliders.box((0.0, 0.55, 0.0), (0.6, 0.1, 0.6))],
        device=device)
    small = BatchedEngine(topo, params, batch=4, colliders=box,
                          device=device)
    solo = sbt.Engine(topo, params, colliders=box, device=device)
    reset_counts()
    for _ in range(10):
        small.step(DT)
    small.block()
    c4 = read_counts()
    for _ in range(10):
        solo.step(DT)
    err = float(np.abs(small.positions() - solo.positions()[None]).max())
    expected = 10 * params.substeps * params.iterations
    print(f"phase D check: B=4 with a box, 10 steps: collide launches "
          f"{c4['collide']} (expected {expected}), max |scene - solo| "
          f"{err:.3e} m (tol {BATCH_TOL})", flush=True)
    if c4["collide"] != expected:
        raise AssertionError(f"collide launches {c4}")
    if not err <= BATCH_TOL:
        raise AssertionError(f"batched scenes disagree with solo ({err})")
    return ms, proj, BatchRunner(eng)


class BatchRunner:
    """The Engine calls profile_window makes, on a BatchedEngine."""

    def __init__(self, eng):
        self.eng, self.backend = eng, eng.backend

    def run(self, steps, dt):
        for _ in range(steps):
            self.eng.step(dt)
        return self

    def block(self):
        self.eng.block()
        return self


def dynamic_path(sbt, device) -> dict:
    """Phase E: DynamicMergedWorld growing across the kernel threshold,
    jacobi ('gather' -> 'pass') and xpbd ('gather' -> 'sweep', lambdas
    carried); retained state array-equal across each rebuild."""
    from softbodysim_torch.solver.select import SWEEP_MIN_CONSTRAINTS

    out = {}
    for dialect, kernel in (("jacobi", "pass"), ("xpbd", "sweep")):
        params = (sbt.SolverParams(**JACOBI) if dialect == "jacobi" else
                  sbt.SolverParams(dialect="xpbd", substeps=2, iterations=6))
        w = sbt.DynamicMergedWorld(params, device=device)
        n = 0

        def add():
            nonlocal n
            w.add_body(f"b{n}", sbt.meshes.tet_cube(
                12, 12, 12, size=0.5, center=(n * 0.8, 0.6, 0.0)))
            n += 1

        reset_counts()
        while True:
            add()
            topo = w.engine.topology
            if topo.num_edges + topo.num_tets >= SWEEP_MIN_CONSTRAINTS:
                break
            before = w.backend
            w.run(8, DT)
            keep = w.engine.state
        if before != "gather" or w.backend != kernel:
            raise AssertionError(f"{dialect}: backend {before!r} -> "
                                 f"{w.backend!r}, expected 'gather' -> "
                                 f"{kernel!r}")
        new = w.engine.state
        for f in ("x", "v", "edge_lambda", "tet_lambda"):
            old_t, new_t = getattr(keep, f), getattr(new, f)
            if not torch.equal(new_t[:len(old_t)], old_t):
                raise AssertionError(f"{dialect}: {f} changed across the "
                                     f"rebuild")
        if dialect == "xpbd" and not keep.edge_lambda.abs().max() > 0:
            raise AssertionError("no lambda to carry")
        w.run(8, DT)
        pos = w.positions()
        counts = read_counts()
        print(f"phase E {dialect}: {n} tet_cube(12) bodies, "
              f"{topo.num_edges + topo.num_tets} constraints: 'gather' -> "
              f"{w.backend!r}; x, v and lambdas of the retained bodies "
              f"array-equal across the rebuild; launches {counts}",
              flush=True)
        if not np.isfinite(pos).all():
            raise AssertionError(f"{dialect}: non-finite positions")
        check_launched(counts, (("jacobi_edge_pass",) if dialect == "jacobi"
                                else ("edge_sweep", "tet_sweep")),
                       "phase E")
        out[dialect] = counts
    return out


def sample_world_path(sbt, device) -> dict:
    """Phase F: sample_scene().build_world() on the card, 20 steps."""
    from softbodysim_torch.api import scenes

    reset_counts()
    world = scenes.sample_scene().build_world(device=device)
    for _ in range(20):
        world.step()
    world.sync()
    counts = read_counts()
    pos = world.positions()["fumo"]
    min_y = float(pos[:, 1].min())
    rest = FLOOR_BOX_TOP + 0.01               # the box top + its radius
    print(f"phase F SampleScene world: 20 steps, min y {min_y:.6f} (resting "
          f"height {rest}), backend {world.bodies[0].engine.backend}, "
          f"launches {counts}", flush=True)
    if not np.isfinite(pos).all():
        raise AssertionError("non-finite SampleScene positions")
    if not abs(min_y - rest) <= 2e-3:
        raise AssertionError(f"the body is not resting on its box ({min_y})")
    check_launched(counts, ("collide",), "phase F")
    return counts


# --------------------------------------------------------------------------
# Contact and the mesh pipeline (phases G-H)
# --------------------------------------------------------------------------

# BASELINE.json config #4 (soft bodies with spatial-hash self and
# inter-body collision and friction) at the north star's particle count:
# contact radius 0.02 (2r = 0.04, under the lattice spacing 1/23 m), the
# self cap autosized, the surface cell autosized
CONTACT = dict(particle_radius=0.02, self_collision=True,
               self_collision_cell=0.04, self_collision_max_per_cell=0,
               surface_collision=True, surface_thickness=0.02,
               surface_collision_cell=0.0, friction=0.4)
CONTACT_STEPS = 40
CHECKPOINT_AT = 30
# stacked after the drop: the upper layer's mean height stays this far over
# the lower layer's, and of the upper vertices over a lower cube's top face
# at most STACK_MAX_DEEP sink more than STACK_DEPTH below the nearest
# top-face vertex (the Jacobi cubes are soft enough at 2 x 6 to flatten
# and let a few percent through); with contact off the upper layer falls
# through the lower one to the ground, and the same scene must fail both
STACK_MIN_RISE = 0.1
STACK_DEPTH = 0.02
STACK_MAX_DEEP = 0.10
# the reduced copy of phase G (two tet_cube(3) bodies, the upper 1 cm over
# the lower and off its lattice) on the card against the CPU
CONTACT_PAIR_STEPS = 10
# phase H: the icosphere's voxel resolution (cells across its extent)
MESH_RESOLUTION = 16


def contact_scene(sbt) -> tuple:
    """8 x tet_cube(23) (V 110,592) merged in two layers of four, 0.1 m
    apart, the upper layer shifted by a quarter cube in x and z so each
    upper cube lands across lower ones: (topology, body slices)."""
    from softbodysim_torch.core.adjacency import combine_topologies

    cubes = [sbt.meshes.tet_cube(23, 23, 23, size=1.0,
                                 center=(cx + shift, y, cz + shift))
             for y, shift in ((0.5, 0.0), (1.6, 0.25))
             for cx in (-0.55, 0.55) for cz in (-0.55, 0.55)]
    return combine_topologies(cubes)


def stacking(topo, slices, x) -> tuple:
    """(the upper layer's mean height over the lower layer's in m, the
    share of the upper vertices over a lower top face (within a lattice
    spacing of a top-face vertex, in x and z) that lie more than
    STACK_DEPTH below the nearest one) at positions x (V, 3) on the card."""
    ys = [float(x[s, 1].mean()) for s in slices]
    rise = float(np.mean(ys[4:]) - np.mean(ys[:4]))
    tops = np.concatenate([
        s.start + np.nonzero(topo.vertices[s, 1]
                             >= topo.vertices[s, 1].max() - 1e-4)[0]
        for s in slices[:4]])
    top = x[torch.as_tensor(tops, device=x.device)]
    up = x[slices[4].start:]
    dist, near = torch.cdist(up[:, [0, 2]], top[:, [0, 2]]).min(1)
    depth = (top[near, 1] - up[:, 1])[dist < 1.0 / 23]
    if not depth.numel():                     # nothing over a top face
        return rise, 1.0
    return rise, float((depth > STACK_DEPTH).float().mean())


def stacked(rise: float, deep: float) -> bool:
    return rise >= STACK_MIN_RISE and deep <= STACK_MAX_DEEP


def same_bits(a, b, label: str) -> None:
    for f in ("x", "v", "x_star", "inv_mass", "edge_lambda", "tet_lambda"):
        if not torch.equal(getattr(a, f), getattr(b, f)):
            diff = float((getattr(a, f) - getattr(b, f)).abs().max())
            raise AssertionError(f"{label}: {f} differs (max {diff:.3e})")


def contact_run(sbt, topo, slices, params, device, label: str) -> dict:
    """One dialect of phase G: the Engine (host plan time, the autosized
    caps), 40 steps with a checkpoint at step 30, a second run to step 30
    (the same bits as the checkpoint), the checkpoint loaded into a fresh
    Engine and stepped 10 more (the same bits as the 40 steps), then three
    warm 20-step windows."""
    import tempfile

    from softbodysim_torch.io import checkpoint

    t0 = time.perf_counter()
    eng = sbt.Engine(topo, params, device=device)
    plan_s = time.perf_counter() - t0
    caps = eng._raw_step.contact.caps
    print(f"phase G {label}: backend {eng.backend}, host plan "
          f"{plan_s:.2f} s, caps {caps}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "contact.npz")
        reset_counts()
        t0 = time.perf_counter()
        for k in range(CONTACT_STEPS):
            eng.step(DT)
            if k + 1 == CHECKPOINT_AT:
                checkpoint.save_state(path, eng.state, params,
                                      {"step": CHECKPOINT_AT})
        eng.block()
        counts = read_counts()
        run_s = time.perf_counter() - t0
        saved, meta = checkpoint.load_state(path, device=device)
        again = sbt.Engine(topo, params, device=device)
        for _ in range(CHECKPOINT_AT):
            again.step(DT)
        same_bits(again.state, saved, f"phase G {label}: a second run")
        del again
        resumed = sbt.Engine(topo, params, device=device)
        resumed.state = saved
        for _ in range(CONTACT_STEPS - meta["step"]):
            resumed.step(DT)
        same_bits(resumed.state, eng.state, f"phase G {label}: resume")
        del resumed
    pos = eng.positions()
    rise, deep = stacking(topo, slices, eng.state.x)
    print(f"phase G {label}: {CONTACT_STEPS} steps in {run_s:.2f} s; a "
          f"second run equal bit for bit at step {CHECKPOINT_AT}, the "
          f"checkpoint resumed {CONTACT_STEPS - CHECKPOINT_AT} steps equal "
          f"bit for bit; upper layer {rise:.4f} m over the lower (at least "
          f"{STACK_MIN_RISE}), {deep:.5f} of its vertices over a lower top "
          f"more than {STACK_DEPTH} m under it (at most {STACK_MAX_DEEP}); "
          f"launches {counts}", flush=True)
    if not np.isfinite(pos).all():
        raise AssertionError(f"phase G {label}: non-finite positions")
    if not stacked(rise, deep):
        raise AssertionError(f"phase G {label}: the layers interpenetrate "
                             f"(rise {rise:.4f} m, {deep:.5f} deep)")
    kernels = (("w_fill", "edge_sweep", "tet_sweep") if eng.backend ==
               "sweep" else ("jacobi_edge_pass", "jacobi_tet_pass_collide"))
    check_launched(counts, kernels, f"phase G {label}")
    ms = window_ms(eng.backend, lambda n: eng.run(n, DT), 20)
    return {"engine": eng, "backend": eng.backend, "host_plan_s": plan_s,
            "caps": caps, "ms_per_step": ms, "rise_m": rise,
            "deep_share": deep, "launches": counts}


def contact_profile(eng, params, ms: float) -> dict:
    """The contact stages of a warm phase-G Engine on its current state, in
    the stage's own layout: device ms and device ops per call of each stage
    (torch.profiler over 5 calls) and the five costliest device ops, the
    stages' peak memory above what was allocated, the share of the step's
    device time, and the overflow."""
    st = eng._raw_step.contact
    x, w = st.rows(eng.state.x, eng.state.inv_mass)
    q = x if st.iso is None else x + st.iso
    calls = max(1, params.substeps) * params.iterations
    out = {}
    for name, fn in (("self", lambda: st.self_fn(q, w, st.radius)),
                     ("surface", lambda: st.surf_fn(q, w)),
                     ("both", lambda: st(x, w))):
        fn()
        acts, _ = device_activity(lambda: [fn() for _ in range(5)])
        dev_ms = sum(t for _, t in acts.values()) / 1e3 / 5
        ops = sum(c for c, _ in acts.values()) / 5
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        by_name = collections.defaultdict(float)
        for k, (_, t) in acts.items():
            by_name[short_name(k)] += t / 5
        out[name] = {"device_ms_per_call": dev_ms,
                     "device_ops_per_call": ops, "peak_mb": peak / 1e6,
                     "top_us_per_call": dict(sorted(
                         by_name.items(), key=lambda kv: -kv[1])[:5])}
    prof = profile_window(eng, 2, ms)
    both = out["both"]
    out.update(
        calls_per_step=calls,
        device_ops_per_step=both["device_ops_per_call"] * calls,
        step_device_busy_ms=prof["device_busy_ms_per_step"],
        contact_share_of_device=both["device_ms_per_call"] * calls
        / prof["device_busy_ms_per_step"],
        overflow=st.overflow(eng.state.x, eng.state.inv_mass))
    return out


def contact_pair(sbt, device) -> dict:
    """Phase G's reduced copy: two tet_cube(3) bodies that collide, on the
    card against the same Engine on the CPU, each backend: max |card - CPU|
    over 10 steps."""
    from softbodysim_torch.core.adjacency import combine_topologies

    pair, _ = combine_topologies([
        sbt.meshes.tet_cube(3, 3, 3, size=0.3, center=(0.0, 0.15, 0.0)),
        sbt.meshes.tet_cube(3, 3, 3, size=0.3, center=(0.037, 0.46, 0.023))])
    out = {}
    for dialect, backend in (("xpbd", "gather"), ("xpbd", "sweep"),
                             ("jacobi", "gather"), ("jacobi", "segment"),
                             ("jacobi", "pass")):
        base = (dict(dialect="xpbd", substeps=2, iterations=3)
                if dialect == "xpbd" else JACOBI)
        knob = f"{dialect}_backend"
        params = sbt.SolverParams(**{**base, **CONTACT, knob: backend})
        card = sbt.Engine(pair, params, device=device)
        cpu = sbt.Engine(pair, params, device="cpu")
        err = 0.0
        for _ in range(CONTACT_PAIR_STEPS):
            card.step(DT)
            cpu.step(DT)
            err = max(err, float(np.abs(card.positions()
                                        - cpu.positions()).max()))
        out[f"{dialect}_{backend}"] = err
        if not err <= ORACLE_TOL:
            raise AssertionError(f"phase G pair {dialect} {backend}: card "
                                 f"vs CPU {err:.3e}")
    print(f"phase G reduced copy (2 x tet_cube(3), contact), card vs CPU "
          f"over {CONTACT_PAIR_STEPS} steps: {out}", flush=True)
    return out


def contact_path(sbt, device) -> dict:
    """Phase G: contact at the north star's size on xpbd 8 x 1 'auto'
    (-> the sweep kernels) and jacobi 2 x 6 'auto' (-> the pass kernels):
    checks, then the stages' profile, then the reduced copy."""
    topo, slices = contact_scene(sbt)
    print(f"phase G scene: 8 x tet_cube(23), V {topo.num_particles}, E "
          f"{topo.num_edges}, T {topo.num_tets}, surface triangles "
          f"{len(topo.surface_tris)}", flush=True)
    dialects = {
        "xpbd": sbt.SolverParams(dialect="xpbd", substeps=8, iterations=1,
                                 **CONTACT),
        "jacobi": sbt.SolverParams(**{**JACOBI, **CONTACT})}
    runs = {label: contact_run(sbt, topo, slices, params, device, label)
            for label, params in dialects.items()}
    for label, params in dialects.items():
        off = sbt.Engine(topo, params.replace(self_collision=False,
                                              surface_collision=False),
                         device=device)
        off.run(CONTACT_STEPS, DT)
        rise, deep = stacking(topo, slices, off.state.x)
        print(f"phase G {label}, contact off: upper layer {rise:.4f} m over "
              f"the lower after {CONTACT_STEPS} steps, {deep:.5f} deep",
              flush=True)
        if rise >= STACK_MIN_RISE or deep <= STACK_MAX_DEEP:
            raise AssertionError(f"phase G {label}: the contact-off scene "
                                 "passes a stacking check")
        runs[label].update(rise_off_m=rise, deep_share_off=deep)
        del off
    for label, params in dialects.items():
        r = runs[label]
        r["profile"] = contact_profile(r.pop("engine"), params,
                                       r["ms_per_step"])
        print(f"phase G {label} contact stages: {json.dumps(r['profile'])}",
              flush=True)
    torch.cuda.empty_cache()
    runs["reduced_card_vs_cpu"] = contact_pair(sbt, device)
    return runs


def mesh_pipeline_path(sbt, device) -> dict:
    """Phase H: a closed icosphere tetrahedralized (native path), its
    topology round-tripped through topology_store, dropped on the floor
    box for 20 steps on 'auto' (-> 'gather'), each step against the same
    Engine on the CPU at ``ball_tol``: 1e-4 m until the ball lands, then
    ten times the CPU's own spread (``cpu_spread_engines``), which the
    landing turns from 1e-7 to centimetres (the voxel ball's flat bottom
    layer meets the box at once, and which rows the push-out catches in a
    substep turns on the last bits)."""
    import tempfile

    from softbodysim_torch.core import native
    from softbodysim_torch.core import tetrahedralize as tet
    from softbodysim_torch.io import topology_store

    if native.get_lib() is None:
        raise AssertionError("phase H: the native library did not build")
    v, f = sbt.meshes.icosphere(3)
    v = (v * 0.3 + np.array([0.0, 0.55, 0.0])).astype(np.float32)
    t0 = time.perf_counter()
    verts, tets = tet.tetrahedralize(v, f, resolution=MESH_RESOLUTION)
    vox_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    snapped = tet.snap_to_surface(verts, tets, v, f)
    snap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    topo = tet.topology_from_mesh(v, f, resolution=MESH_RESOLUTION)
    total_s = time.perf_counter() - t0
    if not np.array_equal(topo.vertices, snapped):
        raise AssertionError("phase H: the pipeline's vertices differ from "
                             "its steps'")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ball.tet.npz")
        topology_store.save_topology(path, topo)
        back = topology_store.load_topology(path)
    for k in ("vertices", "edges", "tets", "surface_tris", "edge_rest",
              "tet_rest_vol"):
        if not np.array_equal(getattr(topo, k), getattr(back, k)):
            raise AssertionError(f"phase H: {k} changed in the round trip")
    params = sbt.SolverParams(**JACOBI)
    reset_counts()
    card = sbt.Engine(back, params, colliders=floor_box(sbt, device),
                      device=device)
    refs = cpu_spread_engines(sbt, back, params)
    rows = []
    for n in range(1, 21):
        pos = card.run(1, DT).positions()
        want, other = (e.run(1, DT).positions() for e in refs)
        spread = float(np.abs(want - other).max())
        rows.append(dict(step=n, card_vs_cpu=float(np.abs(pos - want).max()),
                         gather_vs_one_ulp=spread, tol=ball_tol(spread)))
    counts = read_counts()
    min_y = float(card.positions()[:, 1].min())
    out = {"V": back.num_particles, "T": back.num_tets,
           "voxelize_s": vox_s, "snap_s": snap_s, "pipeline_s": total_s,
           "backend": card.backend, "min_y": min_y, "per_step": rows}
    print(f"phase H mesh pipeline (icosphere(3) r 0.3, resolution "
          f"{MESH_RESOLUTION}, native voxelizer): {json.dumps(out)}; "
          f"launches {counts}", flush=True)
    for r in rows:
        if not r["card_vs_cpu"] <= r["tol"]:
            raise AssertionError(f"phase H: card and CPU disagree: {r}")
    if not min_y < FLOOR_BOX_TOP + 0.05:
        raise AssertionError(f"phase H: the ball did not reach the box "
                             f"({min_y})")
    check_launched(counts, ("collide",), "phase H")
    return out


# --------------------------------------------------------------------------
# Serving, the CLI and the render layer (phases I-J)
# --------------------------------------------------------------------------

# the PBD1 north star: bench.py's (8 substeps, 1 iteration, the rest the
# SolverParams defaults) as the wire carries it
SERVE_STEPS = 20
# small sessions (tet_cube(6): the coloured step, captured at first use)
SMALL_STEPS = 10
# pipelined frames/s over lock-step frames/s at matched client work
PIPELINE_GAIN = 1.3
# the device holds of the no-wait check (the sweep step's dispatch must
# return while the stream is still held: no hidden synchronize), each at
# least this many times the step's median host dispatch
DISPATCH_HOLDS_MS = (500.0, 2000.0)
DISPATCH_HOLD_FACTOR = 20.0
# vertex_normals on the card against the CPU (index_add_ sums in no fixed
# order on the card; unit normals)
NORMALS_TOL = 1e-5


def wire_message(protocol, topo, wire):
    return protocol.InitMessage(
        params=wire, pinned=np.zeros(0, np.uint32), x0=topo.vertices,
        edges=topo.edges, tets=topo.tets)


def client_session(api, port, topo, wire, steps, work_s=0.0,
                   start=None, steady=None) -> dict:
    """One PBD1 client: INIT, ``steps`` STEPs, SHUTDOWN.  The first reply's
    wait carries the server's make time; with ``work_s`` the client sleeps
    that long after each reply (its frame work), and the frames after the
    first are timed.  ``start``, ``steady``: barriers passed between INIT
    and the first STEP, and after the first reply."""
    with api.PBDClient(port=port, timeout=600.0) as cli:
        t0 = time.perf_counter()
        cli.init(topo.vertices, topo.edges, topo.tets, params=wire)
        if start is not None:
            start.wait(timeout=600.0)
            t0 = time.perf_counter()
        replies = [cli.step(DT)]
        first_s = time.perf_counter() - t0
        if steady is not None:
            steady.wait(timeout=600.0)
        rtt, t_frames = [], time.perf_counter()
        for _ in range(steps - 1):
            t = time.perf_counter()
            replies.append(cli.step(DT))
            rtt.append(time.perf_counter() - t)
            if work_s:
                time.sleep(work_s)
        frames_s = time.perf_counter() - t_frames
    return {"replies": replies, "first_s": first_s, "rtt": rtt,
            "frames_s": frames_s, "t_end": time.perf_counter()}


def served(server, target, *args) -> dict:
    """Run ``target(*args)`` against a started server, then wait for the
    server's thread to end."""
    out = target(*args)
    server._thread.join(timeout=60.0)
    if server._thread.is_alive():
        raise AssertionError("the server thread did not end")
    return out


def same_replies(got, want, label: str) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} replies, {len(want)} "
                             "expected")
    for k, (a, b) in enumerate(zip(got, want)):
        if not np.array_equal(a, b):
            raise AssertionError(
                f"{label}: reply {k + 1} differs, max "
                f"{np.abs(a - b).max():.3e} m")


def concurrent_sessions(api, port, topo, wire, steps, n=2) -> tuple:
    """``n`` clients on one multi-session server, from ``n`` threads, their
    first STEPs (which wait for the servers' make time) released together:
    (their sessions, the wall seconds from the release of their second
    STEPs, once every first reply is in, to the last reply)."""
    import threading

    start, steady = threading.Barrier(n), threading.Barrier(n + 1)
    out, errors = [None] * n, []

    def run(i):
        try:
            out[i] = client_session(api, port, topo, wire, steps,
                                    start=start, steady=steady)
        except Exception as e:          # re-raised below
            errors.append(e)
            start.abort()
            steady.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    steady.wait(timeout=600.0)
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout=600.0)
        if th.is_alive():
            raise AssertionError("a client thread did not end")
    if errors:
        raise errors[0]
    return out, max(s["t_end"] for s in out) - t0


def init_beside_a_session(api, port, topo, wire, steady=6,
                          after=5) -> dict:
    """Client A steps without pause on a multi-session server while client
    B sends a second INIT and waits for its first reply: A's frame gaps
    before B's INIT (median) and while it runs (worst), and B's INIT to
    first reply.  A's first ``steady`` frames come before B starts, and A
    goes on for ``after`` frames past B's first reply."""
    import threading

    a_steady, b_done, a_out, errors = (threading.Event(), threading.Event(),
                                       {}, [])

    def run_a():
        try:
            with api.PBDClient(port=port, timeout=600.0) as cli:
                cli.init(topo.vertices, topo.edges, topo.tets, params=wire)
                replies, times, tail = [], [], 0
                while tail < after:
                    replies.append(cli.step(DT))
                    times.append(time.perf_counter())
                    if len(replies) == steady:
                        a_steady.set()
                    tail += b_done.is_set()
            a_out.update(replies=replies, times=np.array(times))
        except Exception as e:          # re-raised below
            errors.append(e)
        finally:
            a_steady.set()

    th = threading.Thread(target=run_a)
    th.start()
    a_steady.wait(timeout=600.0)
    try:
        with api.PBDClient(port=port, timeout=600.0) as cli:
            t0 = time.perf_counter()
            cli.init(topo.vertices, topo.edges, topo.tets, params=wire)
            b_first = cli.step(DT)
            t1 = time.perf_counter()
    finally:
        b_done.set()
        th.join(timeout=600.0)
    if th.is_alive():
        raise AssertionError("client A did not end")
    if errors:
        raise errors[0]
    times = a_out["times"]
    gaps = np.diff(times)
    before = gaps[1:steady - 1]            # frames 2..steady, A alone
    # every gap that overlaps B's INIT-to-first-reply window
    during = gaps[(times[1:] > t0) & (times[:-1] < t1)]
    return {"replies": a_out["replies"], "b_first": b_first,
            "a_median_gap_ms": float(np.median(before)) * 1e3,
            "a_worst_gap_during_init_ms": float(during.max()) * 1e3,
            "a_frames_during_init": int(len(during)),
            "b_init_to_first_reply_s": t1 - t0}


def dispatch_vs_device(eng, steps: int) -> tuple:
    """Per step of a warm Engine: (median host ms of ``step``'s dispatch,
    median device ms from CUDA events around it)."""
    host, dev = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        eng.step(DT)
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end))
    return float(np.median(host)), float(np.median(dev))


def dispatch_waits(eng, host_ms: float) -> tuple:
    """Whether a warm Engine's ``step`` waits for the device: the step is
    dispatched while its stream is held busy (torch.cuda._sleep) for at
    least ``DISPATCH_HOLD_FACTOR`` times its median host dispatch
    ``host_ms``, and an event recorded after the hold is queried as the
    dispatch returns.  A synchronize anywhere in the dispatch finds the
    hold over; a dispatch that waits for nothing returns inside it.  Each
    hold of ``DISPATCH_HOLDS_MS`` is tried in turn, so only a dispatch
    that outlasts every one of them reads as waiting.  Returns (waited,
    the last dispatch's host ms, its hold's ms)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(HOLD_CYCLES)
    end.record()
    end.synchronize()
    cycles_per_ms = HOLD_CYCLES / start.elapsed_time(end)
    for hold in DISPATCH_HOLDS_MS:
        hold = max(hold, DISPATCH_HOLD_FACTOR * host_ms)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(hold * cycles_per_ms))
        held = torch.cuda.Event()
        held.record()
        t0 = time.perf_counter()
        eng.step(DT)
        host = (time.perf_counter() - t0) * 1e3
        waited = held.query()
        torch.cuda.synchronize()
        if not waited:
            return False, host, hold
    return True, host, hold


def serving_path(sbt, topo, device, x_ms: float) -> dict:
    """Phase I: the PBD1 server on the card at the north star (lock-step,
    pipelined, two concurrent sessions, the native comm loop), two
    concurrent small sessions, and the watchdog."""
    import dataclasses

    from softbodysim_torch import api
    from softbodysim_torch.api import protocol
    from softbodysim_torch.api.native_server import NativePBDServer
    from softbodysim_torch.api.server import engine_from_init
    from softbodysim_torch.api.watchdog import WatchdogConfig
    from softbodysim_torch.kernels import sweep as ksw

    wire = protocol.WireParams(substeps=8, iterations=1)
    msg = wire_message(protocol, topo, wire)
    payload = protocol.pack_init(msg)
    print(f"phase I north star over PBD1: INIT {len(payload)} bytes, reply "
          f"{len(protocol.pack_positions(topo.vertices))} bytes", flush=True)

    # lock-step: SERVE_STEPS round trips, then SERVE_STEPS frames with
    # client work of about one round trip each
    reset_counts()
    srv = api.PBDServer(port=0, verbose=False, device=device)
    srv.start_background().wait_ready()
    lock = served(srv, client_session, api, srv.port, topo, wire,
                  SERVE_STEPS)
    counts = read_counts()
    backend, make_s = srv.engine.backend, srv.init_seconds
    print(f"phase I lock-step: backend {backend}, INIT to first reply "
          f"{lock['first_s']:.2f} s (server make {make_s:.2f} s), "
          f"launches {counts}", flush=True)
    if backend != "sweep":
        raise AssertionError(f"phase I: backend {backend!r}, expected "
                             "'sweep'")
    check_launched(counts, ("w_fill", "edge_sweep", "tet_sweep"), "phase I")
    lock_ms = float(np.median(lock["rtt"])) * 1e3
    ref = engine_from_init(protocol.unpack_init(payload[12:]), device)
    want = [ref.step(DT).positions().copy() for _ in range(SERVE_STEPS)]
    same_replies(lock["replies"], want, "phase I lock-step")
    print(f"phase I lock-step: {SERVE_STEPS} replies equal the in-process "
          f"Engine bit for bit; {lock_ms:.3f} ms per round trip (median of "
          f"{len(lock['rtt'])}) against phase 3's {x_ms:.3f} ms/step",
          flush=True)
    host_ms, dev_ms = dispatch_vs_device(ref, 10)
    print(f"phase I sweep step: host dispatch {host_ms:.3f} ms, device "
          f"{dev_ms:.3f} ms (median of 10)", flush=True)
    waited, held_host, hold_ms = dispatch_waits(ref, host_ms)
    print(f"phase I sweep step dispatched behind a {hold_ms:.0f} ms device "
          f"hold: returned in {held_host:.3f} ms, "
          f"{'after' if waited else 'inside'} the hold", flush=True)
    if waited:
        raise AssertionError("phase I: the step's dispatch waits for the "
                             "device")

    # matched client work: lock-step against pipelined frames
    work_s = lock_ms / 1e3
    frames = {}
    for mode in ("lock-step", "pipelined"):
        srv = api.PBDServer(port=0, verbose=mode == "pipelined",
                            pipeline=mode == "pipelined", device=device)
        srv.start_background().wait_ready()
        frames[mode] = served(srv, client_session, api, srv.port, topo, wire,
                              SERVE_STEPS + 1, work_s)
    same_replies(frames["lock-step"]["replies"][:SERVE_STEPS], want,
                 "phase I lock-step with client work")
    pipe = frames["pipelined"]["replies"]
    same_replies(pipe, [topo.vertices] + want, "phase I pipelined (reply k "
                 "against lock-step reply k-1)")
    fps = {m: SERVE_STEPS / r["frames_s"] for m, r in frames.items()}
    gain = fps["pipelined"] / fps["lock-step"]
    print(f"phase I frames with {work_s * 1e3:.2f} ms of client work each: "
          f"lock-step {fps['lock-step']:.2f} frames/s, pipelined "
          f"{fps['pipelined']:.2f} frames/s ({gain:.2f}x)", flush=True)
    if not gain >= PIPELINE_GAIN:
        raise AssertionError(f"phase I: pipelined {gain:.2f}x lock-step, "
                             f"under {PIPELINE_GAIN}x")

    # two north-star sessions at once on one multi-session server
    srv = api.PBDServer(port=0, verbose=False, device=device)
    srv.start_background(multi=True).wait_ready()
    try:
        multi, wall = concurrent_sessions(api, srv.port, topo, wire,
                                          SERVE_STEPS)
    finally:
        srv.stop()
    ksw.raise_on_timeouts()
    for i, s in enumerate(multi):
        same_replies(s["replies"], want, f"phase I concurrent session {i}")
    aggregate = 2 * (SERVE_STEPS - 1) / wall
    print(f"phase I two concurrent north-star sessions: each bit for bit "
          f"its solo run, no sweep timeout; aggregate {aggregate:.2f} "
          f"frames/s, one session alone {1e3 / lock_ms:.2f} frames/s",
          flush=True)

    # a second INIT while a session steps: the INIT's host work runs
    # outside the device lock, so the running session goes on stepping
    srv = api.PBDServer(port=0, verbose=False, device=device)
    srv.start_background(multi=True).wait_ready()
    try:
        beside = init_beside_a_session(api, srv.port, topo, wire)
    finally:
        srv.stop()
    ksw.raise_on_timeouts()
    same_replies(beside["replies"][:SERVE_STEPS], want,
                 "phase I session stepping beside a second INIT")
    same_replies([beside["b_first"]], want[:1],
                 "phase I second INIT's first reply")
    print(f"phase I second INIT beside a stepping session: its INIT to "
          f"first reply {beside['b_init_to_first_reply_s']:.2f} s; the "
          f"running session's frame gap median "
          f"{beside['a_median_gap_ms']:.3f} ms before it, worst "
          f"{beside['a_worst_gap_during_init_ms']:.3f} ms during it "
          f"({beside['a_frames_during_init']} frames)", flush=True)

    # two small sessions at once: their first STEPs capture the coloured
    # step's graph
    small = sbt.meshes.tet_cube(6, 6, 6, size=0.5, center=(0.0, 0.5, 0.0))
    small_wire = protocol.WireParams(substeps=2, iterations=4)
    srv = api.PBDServer(port=0, verbose=False, device=device)
    srv.start_background().wait_ready()
    solo = served(srv, client_session, api, srv.port, small, small_wire,
                  SMALL_STEPS)
    if srv.engine.backend != "gather":
        raise AssertionError(f"phase I small: backend {srv.engine.backend}")
    srv = api.PBDServer(port=0, verbose=False, device=device)
    srv.start_background(multi=True).wait_ready()
    try:
        pair, _ = concurrent_sessions(api, srv.port, small, small_wire,
                                      SMALL_STEPS)
    finally:
        srv.stop()
    for i, s in enumerate(pair):
        same_replies(s["replies"], solo["replies"],
                     f"phase I small concurrent session {i}")
    print(f"phase I two concurrent tet_cube(6) sessions (coloured step, "
          f"graphs captured at their first STEPs): each bit for bit its "
          f"solo run", flush=True)

    # the native comm loop
    nat = NativePBDServer(port=0, verbose=False, device=device)
    nat.start_background().wait_ready()
    native = served(nat, client_session, api, nat.port, topo, wire,
                    SERVE_STEPS)
    same_replies(native["replies"], want, "phase I native server")
    print(f"phase I native server: {SERVE_STEPS} replies equal the "
          f"in-process Engine bit for bit, "
          f"{np.median(native['rtt']) * 1e3:.3f} ms per round trip",
          flush=True)

    # the watchdog on the north star: NaN -> one rollback to a snapshot
    wd = api.Watchdog(ref, WatchdogConfig(check_every=5))
    for _ in range(10):
        if not wd.step(DT):
            raise AssertionError("phase I watchdog: a healthy step rolled "
                                 "back")
    step0, snap = wd._snapshots[0]
    snap = {f.name: getattr(snap, f.name).clone()
            for f in dataclasses.fields(snap)}
    st = ref.state
    x = st.x.clone()
    x[0, 0] = float("nan")
    ref.state = dataclasses.replace(st, x=x)
    ok = [wd.step(DT) for _ in range(5)]
    if ok.count(False) != 1 or wd.rollbacks != 1 or wd.steps != step0:
        raise AssertionError(f"phase I watchdog: {ok}, rollbacks "
                             f"{wd.rollbacks}, at step {wd.steps}")
    for name, t in snap.items():
        if not torch.equal(getattr(ref.state, name), t):
            raise AssertionError(f"phase I watchdog: restored {name} is not "
                                 "the snapshot")
    ref.step(DT)
    if not np.isfinite(ref.positions()).all():
        raise AssertionError("phase I watchdog: non-finite after rollback")
    print(f"phase I watchdog: NaN injected at step 10, one rollback to step "
          f"{step0}, the state bit for bit the snapshot", flush=True)
    ksw.raise_on_timeouts()
    return {"init_to_first_reply_s": lock["first_s"],
            "server_make_s": make_s,
            "lock_step_ms_per_round_trip": lock_ms,
            "phase3_ms_per_step": x_ms,
            "dispatch_host_ms": host_ms, "step_device_ms": dev_ms,
            "client_work_ms": work_s * 1e3,
            "lock_step_ms_per_frame": 1e3 / fps["lock-step"],
            "pipelined_ms_per_frame": 1e3 / fps["pipelined"],
            "pipelined_gain": gain,
            "two_session_aggregate_frames_per_s": aggregate,
            "one_session_frames_per_s": 1e3 / lock_ms,
            "second_init_to_first_reply_s":
                beside["b_init_to_first_reply_s"],
            "frame_gap_median_ms": beside["a_median_gap_ms"],
            "frame_gap_worst_during_second_init_ms":
                beside["a_worst_gap_during_init_ms"],
            "native_ms_per_round_trip": float(np.median(native["rtt"]))
            * 1e3}


def cli_and_render_path(sbt, topo, device, x: np.ndarray) -> dict:
    """Phase J: ``python -m softbodysim_torch info`` and ``scene batch``
    as subprocesses on the card, ``serve --view``'s viewport frame against
    the last reply, and vertex_normals on the card against the CPU."""
    import urllib.request

    from softbodysim_torch import api
    from softbodysim_torch.api import protocol
    from softbodysim_torch.render import vertex_normals

    out = {}
    for args, want in ((["info"], "kernel library: built"),
                       (["scene", "batch", "--seconds", "2"],
                        "backend pass")):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "softbodysim_torch",
                              *args], cwd=ROOT, capture_output=True,
                             text=True, timeout=300)
        secs = time.perf_counter() - t0
        print(f"phase J: python -m softbodysim_torch {' '.join(args)} -> "
              f"rc {run.returncode} in {secs:.1f} s", flush=True)
        for line in (run.stdout + run.stderr).strip().splitlines():
            print("  " + line, flush=True)
        if run.returncode != 0 or want not in run.stdout:
            raise AssertionError(f"phase J: {args[0]} failed or printed no "
                                 f"{want!r}")
        out[f"{args[0]}_s"] = secs

    # serve --view: the viewport's frame is the last reply
    small = sbt.meshes.tet_cube(6, 6, 6, size=0.5, center=(0.0, 0.5, 0.0))
    srv = api.PBDServer(port=0, verbose=False, view=True, view_port=0,
                        device=device)
    srv.start_background().wait_ready()
    try:
        session = served(srv, client_session, api, srv.port, small,
                         protocol.WireParams(substeps=2, iterations=4), 3)
        with urllib.request.urlopen(srv._viewer.url + "frame",
                                    timeout=30) as r:
            frame = np.frombuffer(r.read(), np.float32).reshape(-1, 3)
    finally:
        srv.stop()
    same_replies([frame], session["replies"][-1:], "phase J serve --view")
    print("phase J serve --view: the viewport's frame is the last reply, "
          "bit for bit", flush=True)

    # vertex normals at the north star's surface, phase 3's positions
    tris = torch.as_tensor(topo.surface_tris, dtype=torch.int64)
    cpu = vertex_normals(torch.from_numpy(x), tris)
    card = vertex_normals(torch.from_numpy(x).to(device),
                          tris.to(device)).cpu()
    err = float((card - cpu).abs().max())
    print(f"phase J vertex_normals: {len(topo.surface_tris)} surface "
          f"triangles, card against CPU max {err:.3e}", flush=True)
    if not err <= NORMALS_TOL:
        raise AssertionError(f"phase J: normals differ by {err:.3e}")
    out["normals_max_err"] = err
    return out


# --------------------------------------------------------------------------
# Differentiable simulation (phase K)
# --------------------------------------------------------------------------

# K1: the north star on the coloured step's differentiable build, 8 x 1,
# ground on, DIFF_STEPS steps; K2: phase 4's configuration on 'segment'
DIFF_STEPS = 4
# the ballistic identities: exact in real arithmetic at any size
IDENTITY_TOL = 1e-3
# central differences: step in log compliance (K1) and in the physical
# stiffness / omega (K2).  A float32 loss over ~1.3M positions rounds at
# ~1e-7 relative, and the Jacobi forward sums with atomics (run-to-run
# order), so a difference moves by ~1e-4 of the loss, over 2h: within
# 2e-2 of the gradient, truncation error (h^2 / 6 of the third
# derivative) well under it where no contact switches inside +-h.  The
# omega difference is taken FD_REPEATS times from a start FREE_GAP over
# the box, where none does (a switch bends the loss inside the span)
FD_STEP = {"log_edge_compliance": 2e-2, "edge_stiffness": 2e-2,
           "sor_omega": 2e-2}
FD_TOL = 2e-2
FD_REPEATS = 2
FREE_GAP = 0.3
FIT_STEPS = 5
# K5: the card against the CPU at tet_cube(6): trajectories 1e-4 m (the
# oracle contract), gradients 1e-3 of their largest component (fp32
# reassociation: index_add in the card's atomic order in the backward)
K5_GRAD_TOL = 1e-3


def on_card(label: str, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise AssertionError(f"{label}: a tensor on {t.device}")


def timed_grad(fn, inputs) -> tuple:
    """(value, gradients, host ms, peak MB over the memory held before)
    of one ``fn()`` and its backward on the card, ending in a
    synchronize."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    val = fn()
    grads = torch.autograd.grad(val, inputs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    return val.detach(), grads, ms, peak


def with_velocity(sbt, state, v):
    return sbt.SimState(x=state.x, v=v, x_star=state.x_star,
                        inv_mass=state.inv_mass,
                        edge_lambda=state.edge_lambda,
                        tet_lambda=state.tet_lambda)


def diff_xpbd_path(sbt, topo, device, nsteps: int = DIFF_STEPS,
                   fit_steps: int = FIT_STEPS) -> dict:
    """Phase K1: ``diff.make_rollout`` / ``make_trajectory_loss`` /
    ``fit`` on the coloured step's differentiable build at full width:
    the ballistic identities, the gradient w.r.t. log edge compliance
    against a central difference, ms and peak memory per gradient with
    and without remat, and a short fit from 10x off."""
    from softbodysim_torch import diff

    out = {}
    f32t = dict(dtype=torch.float32, device=device)
    base = sbt.SolverParams(substeps=8, iterations=1)
    s0 = sbt.init_state(topo, device=device)
    # the identities: no ground, no colliders, free body
    free = base.replace(ground_enabled=False)
    r = diff.make_rollout(topo, free, dt=DT, nsteps=nsteps, device=device)
    if not (r.step.backend == "gather" and r.step.differentiable):
        raise AssertionError(f"phase K1: backend {r.step.backend!r}")
    dv = torch.zeros(3, **f32t, requires_grad=True)
    g = torch.tensor(free.gravity, **f32t, requires_grad=True)

    def final_mean_y():
        tr = r(with_velocity(sbt, s0, s0.v + dv), {"gravity_override": g})
        on_card("phase K1", tr)
        return tr[-1, :, 1].mean()

    _, (g_dv, g_g), ms, peak = timed_grad(final_mean_y, (dv, g))
    n, total = nsteps * free.substeps, nsteps * DT
    want = {"translation": nsteps * DT,
            "gravity": total * total * (n + 1) / (2 * n)}
    got = {"translation": float(g_dv[1]), "gravity": float(g_g[1])}
    for k in want:
        rel = abs(got[k] - want[k]) / want[k]
        print(f"phase K1 {k} identity: d(mean y)/d = {got[k]:.7g}, want "
              f"{want[k]:.7g}, rel {rel:.2e} (tol {IDENTITY_TOL})",
              flush=True)
        if not rel <= IDENTITY_TOL:
            raise AssertionError(f"phase K1: the {k} identity fails")
        out[f"{k}_identity_rel"] = rel
    print(f"phase K1 identities: one value_and_grad in {ms:.1f} ms, peak "
          f"{peak:.0f} MB", flush=True)

    # a deformed, soft body with the ground on: the edge compliance at
    # which alpha = c / sdt^2 is the median vertex's 2 w, so the
    # trajectory depends on it
    rng = np.random.default_rng(SEED)
    v0 = torch.from_numpy(rng.normal(0.0, 0.5, (topo.num_particles, 3))
                          .astype(np.float32)).to(device)
    st = with_velocity(sbt, s0, v0)
    sdt = DT / base.substeps
    c_true = float(2.0 * s0.inv_mass.median() * sdt * sdt)
    with torch.no_grad():
        target = diff.make_rollout(topo, base, dt=DT, nsteps=nsteps,
                                   device=device)(
            st, {"edge_compliance": torch.tensor(c_true, **f32t)})
    timings = {}
    for remat in (True, False):
        loss = diff.make_trajectory_loss(topo, base, target, dt=DT,
                                         state0=st, remat=remat,
                                         device=device)
        theta = torch.tensor(math.log(3.0 * c_true), **f32t,
                             requires_grad=True)
        fn = (lambda: loss({"edge_compliance": torch.exp(theta)}))
        timed_grad(fn, (theta,))                               # warm
        val, (gt,), ms, peak = timed_grad(fn, (theta,))
        timings[remat] = (ms, peak)
        print(f"phase K1 value_and_grad (remat={remat}): {ms:.1f} ms, peak "
              f"{peak:.0f} MB over {torch.cuda.memory_allocated() / 2**20:.0f}"
              f" MB held, loss {float(val):.6e}, dL/dlog c {float(gt):.6e}",
              flush=True)
        if remat:
            h = FD_STEP["log_edge_compliance"]
            with torch.no_grad():
                lp, lm = (float(loss({"edge_compliance": torch.exp(
                    theta + s)})) for s in (h, -h))
            fd = (lp - lm) / (2 * h)
            rel = abs(float(gt) - fd) / abs(fd)
            print(f"phase K1 dL/dlog(edge_compliance) {float(gt):.6e} "
                  f"against the central difference {fd:.6e} (h {h}): rel "
                  f"{rel:.2e} (tol {FD_TOL})", flush=True)
            if not rel <= FD_TOL:
                raise AssertionError("phase K1: gradient and central "
                                     "difference disagree")
            out["fd_rel"] = rel
            on_card("phase K1", val, gt, target)
    out.update(ms_remat=timings[True][0], peak_mb_remat=timings[True][1],
               ms_no_remat=timings[False][0],
               peak_mb_no_remat=timings[False][1], c_true=c_true)

    t0 = time.perf_counter()
    res = diff.fit(topo, base, target, dt=DT, state0=st,
                   fit_params=("edge_compliance",),
                   init={"edge_compliance": 10.0 * c_true},
                   steps=fit_steps, learning_rate=0.25, device=device)
    secs = time.perf_counter() - t0
    print(f"phase K1 fit ({fit_steps} steps from 10x off): losses "
          f"{', '.join(f'{x:.6e}' for x in res.losses)}; edge_compliance "
          f"{res.params['edge_compliance']:.6e} (true {c_true:.6e}) in "
          f"{secs:.1f} s", flush=True)
    if not (np.isfinite(res.losses).all()
            and res.losses[-1] < res.losses[0]):
        raise AssertionError("phase K1: the fit did not lower the loss")
    out.update(fit_losses=[float(x) for x in res.losses], fit_s=secs,
               fit_edge_compliance=res.params["edge_compliance"])
    return out


def diff_jacobi_path(sbt, topo, device, nsteps: int = DIFF_STEPS) -> dict:
    """Phase K2: phase 4's configuration (the floor box) forced to
    'segment', the body lowered into the box: the collide kernel's launch
    count, the gradient w.r.t. edge_stiffness against a central
    difference, ms and peak memory per gradient; then the gradient
    w.r.t. sor_omega against central differences from a contact-free
    start (``omega_check``)."""
    from softbodysim_torch import diff

    f32t = dict(dtype=torch.float32, device=device)
    params = sbt.SolverParams(**JACOBI)
    box = floor_box(sbt, device)
    s0 = sbt.init_state(topo, device=device)
    # the body's lowest layer 5 cm into the box: both stages push
    drop = float(topo.vertices[:, 1].min()) - (FLOOR_BOX_TOP - 0.05)
    x = s0.x - torch.tensor([0.0, drop, 0.0], **f32t)
    st = sbt.SimState(x=x, v=s0.v, x_star=x, inv_mass=s0.inv_mass,
                      edge_lambda=s0.edge_lambda, tet_lambda=s0.tet_lambda)
    with torch.no_grad():
        target = diff.make_rollout(topo, params, dt=DT, nsteps=nsteps,
                                   colliders=box, device=device)(
            st, {"edge_stiffness": 0.6, "sor_omega": 1.2})
    out, timings = {}, {}
    for remat in (True, False):
        loss = diff.make_trajectory_loss(topo, params, target, dt=DT,
                                         state0=st, colliders=box,
                                         remat=remat, device=device)
        k = torch.tensor(params.edge_stiffness, **f32t, requires_grad=True)
        om = torch.tensor(params.sor_omega, **f32t, requires_grad=True)

        def fn():
            return loss({"edge_stiffness": k, "sor_omega": om})

        timed_grad(fn, (k, om))                                 # warm
        reset_counts()
        val, grads, ms, peak = timed_grad(fn, (k, om))
        counts = read_counts()
        timings[remat] = (ms, peak)
        print(f"phase K2 value_and_grad (remat={remat}, 'segment'): "
              f"{ms:.1f} ms, peak {peak:.0f} MB, loss {float(val):.6e}, "
              f"launches {counts}", flush=True)
        check_launched(counts, ("collide",), "phase K2")
        on_card("phase K2", val, *grads, target)
        if not remat:
            continue
        out["collide_launches"] = counts["collide"]
        h = FD_STEP["edge_stiffness"]
        with torch.no_grad():
            lp, lm = (float(loss({"edge_stiffness": k + s,
                                  "sor_omega": om})) for s in (h, -h))
        fd = (lp - lm) / (2 * h)
        rel = abs(float(grads[0]) - fd) / abs(fd)
        print(f"phase K2 dL/dedge_stiffness {float(grads[0]):.6e} against "
              f"the central difference {fd:.6e} (h {h}): rel {rel:.2e} "
              f"(tol {FD_TOL})", flush=True)
        if not rel <= FD_TOL:
            raise AssertionError("phase K2: the edge_stiffness gradient "
                                 "and its central difference disagree")
        out["fd_rel_edge_stiffness"] = rel
    out.update(ms_remat=timings[True][0], peak_mb_remat=timings[True][1],
               ms_no_remat=timings[False][0],
               peak_mb_no_remat=timings[False][1])
    out.update(omega_check(sbt, topo, device, params, box, nsteps))
    return out


def omega_check(sbt, topo, device, params, box, nsteps: int) -> dict:
    """K2's sor_omega gradient against FD_REPEATS central differences,
    from the body FREE_GAP over the floor box with a random velocity
    field: every trajectory of the differences stays clear of the box
    (and so of the ground under it), so no contact switches inside the
    span and the loss is smooth in omega there."""
    from softbodysim_torch import diff

    f32t = dict(dtype=torch.float32, device=device)
    s0 = sbt.init_state(topo, device=device)
    lift = FLOOR_BOX_TOP + FREE_GAP - float(topo.vertices[:, 1].min())
    x = s0.x + torch.tensor([0.0, lift, 0.0], **f32t)
    v0 = torch.from_numpy(np.random.default_rng(SEED + 3).normal(
        0.0, 0.5, (topo.num_particles, 3)).astype(np.float32)).to(device)
    st = sbt.SimState(x=x, v=v0, x_star=x, inv_mass=s0.inv_mass,
                      edge_lambda=s0.edge_lambda, tet_lambda=s0.tet_lambda)
    r = diff.make_rollout(topo, params, dt=DT, nsteps=nsteps,
                          colliders=box, device=device)
    with torch.no_grad():
        target = r(st, {"edge_stiffness": 0.6, "sor_omega": 1.2})
    loss = diff.make_trajectory_loss(topo, params, target, dt=DT,
                                     state0=st, colliders=box, device=device)
    om = torch.tensor(params.sor_omega, **f32t, requires_grad=True)
    val, (g,), _, _ = timed_grad(lambda: loss({"sor_omega": om}), (om,))
    on_card("phase K2", val, g, target)
    h, fds, lowest = FD_STEP["sor_omega"], [], [float(target[..., 1].min())]
    for _ in range(FD_REPEATS):
        pair = []
        for s in (h, -h):
            with torch.no_grad():
                tr = r(st, {"sor_omega": om + s})
            lowest.append(float(tr[..., 1].min()))
            pair.append(float(torch.mean(torch.square(tr - target))))
        fds.append((pair[0] - pair[1]) / (2 * h))
    clear = min(lowest) - FLOOR_BOX_TOP - params.particle_radius
    rels = [abs(float(g) - fd) / abs(fd) for fd in fds]
    print(f"phase K2 dL/dsor_omega {float(g):.6e} (loss {float(val):.6e}) "
          f"against {FD_REPEATS} central differences "
          f"{', '.join(f'{fd:.6e}' for fd in fds)} (h {h}, the body "
          f"{clear:.3f} m clear of the box): rel "
          f"{', '.join(f'{x:.2e}' for x in rels)} (tol {FD_TOL})",
          flush=True)
    if not clear > 0.0:
        raise AssertionError("phase K2: the omega check's body reached the "
                             "box")
    if not max(rels) <= FD_TOL:
        raise AssertionError("phase K2: the sor_omega gradient and its "
                             "central differences disagree")
    return {"fd_rel_sor_omega": max(rels), "omega_clear_m": clear}


def collide_function_check(sbt, topo, device) -> dict:
    """Phase K3: the collide Function at north-star shapes (the floor box,
    a sphere, a capsule and the ground plane, the body moved into them):
    its forward within 1e-6 of the plain version, its gradients w.r.t.
    the positions and the colliders equal to autograd through
    collide_plain on the same inputs (max-abs 0: the backward is those
    ops)."""
    from softbodysim_torch.kernels import collide as kc

    q = (0.1826, 0.3651, 0.5477, 0.7303)
    packed = kc.pack_colliders(sbt.Colliders.build([
        sbt.Colliders.box((0.0, 0.1, 0.0), (1.5, 0.1, 1.5)),
        sbt.Colliders.sphere((0.1, 0.45, 0.0), 0.2),
        sbt.Colliders.capsule((-0.3, 0.5, 0.2), 0.1, 0.3, rotation=q)],
        device=device))
    ground = kc.make_ground(sbt.SolverParams(**JACOBI))
    s0 = sbt.init_state(topo, device=device)
    xw = torch.cat([s0.x, s0.inv_mass[:, None]], 1).contiguous()
    xw[:, 1] -= 1.9
    xw[::97, 3] = 0.0                                  # some pinned rows
    rng = np.random.default_rng(SEED + 1)
    cot = torch.from_numpy(rng.standard_normal((xw.shape[0], 3))
                           .astype(np.float32)).to(device)
    w = xw[:, 3].contiguous()
    xi, pi = (t.clone().requires_grad_(True) for t in (xw[:, :3], packed))
    reset_counts()
    out = kc.collide_positions(xi, w, pi, ground)
    launches = read_counts()["collide"]
    got = torch.autograd.grad(out, (xi, pi), cot)
    xr, pr = (t.clone().requires_grad_(True) for t in (xw[:, :3], packed))
    ref = kc.collide_plain(torch.cat([xr, w[:, None]], 1), pr, ground)[:, :3]
    want = torch.autograd.grad(ref, (xr, pr), cot)
    torch.cuda.synchronize()
    on_card("phase K3", out, ref, *got, *want)
    err = (out - ref).abs().max().item()
    gerr = max((a - b).abs().max().item() for a, b in zip(got, want))
    pushed = int(((out - xw[:, :3]).abs().amax(1) > 0).sum().item())
    print(f"phase K3 collide Function (V {xw.shape[0]}, 3 colliders + "
          f"ground): {launches} kernel launch, max|forward - plain| "
          f"{err:.3e} m (tol {COLLIDE_TOL}), {pushed} rows pushed; "
          f"max|grad - plain VJP| {gerr:.3e} (must be 0; max|grad p| "
          f"{got[0].abs().max().item():.3e}, |grad packed| "
          f"{got[1].abs().max().item():.3e})", flush=True)
    if launches != int(device.type == "cuda") or not err <= COLLIDE_TOL \
            or gerr != 0.0 \
            or not pushed > 0 \
            or not torch.equal(xi.detach(), xw[:, :3]):
        raise AssertionError("phase K3: the collide Function fails")
    return {"forward_max_abs_err": err, "grad_max_abs_err": gerr}


def refusal_check(sbt, engines) -> None:
    """Phase K4: the kernel steps ('sweep', legacy 128-wide, 'pass') raise
    when handed a state that requires grad, and change nothing."""
    for label, eng in engines:
        st = eng.state
        before = eng.positions()
        v = st.v.clone().requires_grad_(True)
        try:
            eng._raw_step(with_velocity(sbt, st, v), DT)
        except RuntimeError as e:
            if "diff.make_rollout" not in str(e):
                raise
            print(f"phase K4 {label} ({eng.backend}): raises under grad: "
                  f"{str(e)[:60]}...", flush=True)
        else:
            raise AssertionError(f"phase K4: {label} stepped a state that "
                                 "requires grad")
        if not np.array_equal(eng.positions(), before):
            raise AssertionError(f"phase K4: {label}'s state changed")


def diff_profile(sbt, topo, device, grads: dict) -> None:
    """Phase K's profile (after phase 12): one step's value_and_grad (no
    remat) of K1's and K2's configurations under torch.profiler: the
    device's busy ms and kernel count against phase K's unprofiled ms per
    step (its 4-step gradient over 4)."""
    from softbodysim_torch import diff

    s0 = sbt.init_state(topo, device=device)
    for label, params, cols, knob in (
            ("xpbd", sbt.SolverParams(substeps=8, iterations=1), None,
             "edge_compliance"),
            ("jacobi", sbt.SolverParams(**JACOBI), floor_box(sbt, device),
             "edge_stiffness")):
        r = diff.make_rollout(topo, params, dt=DT, nsteps=1, colliders=cols,
                              remat=False, device=device)
        k = torch.tensor(float(getattr(params, knob)), dtype=torch.float32,
                         device=device, requires_grad=True)

        def value_and_grad():
            torch.autograd.grad(r(s0, {knob: k}).square().mean(), k)

        value_and_grad()
        acts, wall_us = device_activity(value_and_grad)
        busy = sum(t for _, t in acts.values()) / 1e3
        kernels = sum(c for c, _ in acts.values())
        ms = grads[label]["ms_no_remat"] / DIFF_STEPS
        top = sorted(((short_name(n), c, t) for n, (c, t) in acts.items()),
                     key=lambda x: -x[2])[:8]
        print(json.dumps({
            "profile": f"diff {label} value_and_grad, 1 step, no remat",
            "profiled_wall_ms": wall_us / 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / ms, "unprofiled_ms_per_step": ms,
            "device_activities": kernels,
            "top": {n: {"count": c, "ms": t / 1e3} for n, c, t in top}}),
            flush=True)


def diff_card_vs_cpu(sbt, device) -> dict:
    """Phase K5: tet_cube(6) on the floor box, both dialects, 4 steps:
    the card's trajectory and gradients against the CPU's."""
    from softbodysim_torch import diff

    topo = sbt.meshes.tet_cube(6, 6, 6, size=0.5, center=(0.0, 0.5, 0.0))
    # the body lands on the box, above the ground: no friction at commit
    cases = (("xpbd", sbt.SolverParams(substeps=2, iterations=2,
                                       edge_compliance=1e-2),
              ("edge_compliance", "volume_compliance")),
             ("jacobi", sbt.SolverParams(**JACOBI),
              ("edge_stiffness", "volume_stiffness", "sor_omega")))
    out = {}
    for dialect, params, names in cases:
        res = {}
        for dev in ("cpu", device):
            s0 = sbt.init_state(topo, device=dev)
            v = torch.full_like(s0.v, -2.0).requires_grad_(True)
            r = diff.make_rollout(topo, params, dt=DT, nsteps=DIFF_STEPS,
                                  colliders=floor_box(sbt, dev), device=dev)
            ov = {n: torch.tensor(float(getattr(params, n)),
                                  dtype=torch.float32, device=dev,
                                  requires_grad=True) for n in names}
            tr = r(with_velocity(sbt, s0, v), ov)
            w = torch.from_numpy(np.random.default_rng(SEED + 2)
                                 .standard_normal(tuple(tr.shape))
                                 .astype(np.float32)).to(dev)
            grads = torch.autograd.grad((tr * w).sum(), [*ov.values(), v])
            if dev != "cpu":
                on_card("phase K5", tr, *grads)
            res[str(dev)] = [tr.detach().cpu()] + [g.cpu() for g in grads]
        cpu, card = res["cpu"], res[str(device)]
        x_err = (card[0] - cpu[0]).abs().max().item()
        g_rel = max(((a - b).abs().max() / b.abs().max()).item()
                    if b.abs().max() > 0 else float("inf")
                    for a, b in zip(card[1:], cpu[1:]))
        print(f"phase K5 {dialect} tet_cube(6), {DIFF_STEPS} steps on the "
              f"floor box: card vs CPU trajectory {x_err:.3e} m (tol "
              f"{X_TOL}), gradients ({', '.join(names)}, v0) rel "
              f"{g_rel:.3e} (tol {K5_GRAD_TOL})", flush=True)
        if not (x_err <= X_TOL and g_rel <= K5_GRAD_TOL):
            raise AssertionError(f"phase K5 {dialect}: card and CPU "
                                 "disagree")
        out[dialect] = {"x_err": x_err, "grad_rel": g_rel}
    return out


# --------------------------------------------------------------------------
# Phase L: the kernel-sharded steps on torch.distributed
# --------------------------------------------------------------------------

# steps of each sharded path's checked run, and of its timed windows
SHARDED_STEPS = 4
# XPBD at D = 2 with the sweep kernels against the same ranks with their
# plain versions: steps compared
SHARDED_PLAIN_STEPS = 1
# the sharded xpbd at D = 1 against the single-device sweep step (it runs
# the same plans and kernels in the same order: bit for bit in fact)
SHARDED_X_TOL = 1e-6
# every phase L run starts from the rest shape with velocities N(0, this)
# m/s drawn from SEED, so the constraints work from the first substep
SHARDED_V_SIGMA = 0.5
# a run's constraint correction -- its largest distance from the
# ballistic move, over all rows and, at D > 1, over the rows of the
# ghost windows -- must reach this many times each position limit it is
# held to, so that a dropped or doubled halo contribution would fail
SHARDED_WORK = 10.0


def sharded_params(sbt) -> dict:
    """Phase L's two paths: the north star on the sweep kernels (8 x 1)
    and phase 4's Jacobi configuration on the pass kernels (2 x 6, the
    floor box); 'auto' picks the kernel-sharded step at this size."""
    return {"xpbd": (sbt.SolverParams(dialect="xpbd", substeps=8,
                                      iterations=1), False),
            "jacobi": (sbt.SolverParams(**JACOBI), True)}


def halo_info(step) -> dict:
    """Per family: this rank's ghost windows, the windows it exports, and
    the bytes one exchange sends out and takes back per rank (the padded
    all-gathers: exported rows x, y, z, w out; ghost deltas back, three
    floats for xpbd, four for jacobi's sums and counts)."""
    out = {}
    back = 12 if step.backend == "sweep" else 16
    for name, f in step.fams.items():
        h = f.halo
        exports = f.fam.exports[step.axis.index]
        out[name] = {"ghost_windows": h.g,
                     "export_windows": int(len(exports)),
                     "bytes_out": h.emax * 128 * 16 if h.active else 0,
                     "bytes_back": h.gmax * 128 * back if h.active else 0}
    return out


def run_sharded(sbt, topo, device, mesh, label: str) -> dict:
    """One rank's phase L: each path's Engine(mesh=...) driven with the
    launch counts set to 0 just before and read just after, run
    SHARDED_STEPS steps twice from the same start (the same bits), then
    timed in three windows; the host's seconds inside collectives over the
    windows' wall time."""
    import torch_sharded_ranks as tr

    out = {}
    for name, (params, boxed) in sharded_params(sbt).items():
        cols = floor_box(sbt, device) if boxed else None
        t0 = time.perf_counter()
        eng = sbt.Engine(topo, params, colliders=cols, mesh=mesh,
                         device=device)
        step = eng._raw_step
        build_s = time.perf_counter() - t0
        s0 = eng.state = tr.kicked(eng, SEED, SHARDED_V_SIGMA)
        reset_counts()
        eng.run(SHARDED_STEPS, DT)
        eng.block()
        counts = read_counts()
        first = eng.state
        eng.state = s0
        eng.run(SHARDED_STEPS, DT)
        again = eng.state
        same = all(torch.equal(getattr(first, f), getattr(again, f))
                   for f in ("x", "v", "edge_lambda", "tet_lambda"))
        ax = step.axis
        ax.host_seconds = 0.0
        t1 = time.perf_counter()
        ms = window_ms(f"phase L {label} {name}",
                       lambda n: eng.run(n, DT), SHARDED_STEPS)
        share = ax.host_seconds / (time.perf_counter() - t1)
        out[name] = {"x": first.x.cpu().numpy(),
                     "edge_lambda": first.edge_lambda.cpu().numpy(),
                     "same_bits": same, "counts": counts, "ms": ms,
                     "build_s": build_s, "collective_host_share": share,
                     "transport": ax.transport(first.x),
                     "backend": eng.backend, "halo": halo_info(step),
                     "halo_vertices": (
                         tr.halo_vertices(step, topo.num_particles)
                         if ax.size > 1 else None)}
        if name == "xpbd" and ax.size > 1:
            out[name].update(plain_check(eng, s0, params))
    return out


def plain_check(eng, s0, params) -> dict:
    """XPBD at D > 1: SHARDED_PLAIN_STEPS steps with the sweep kernels
    against the same ranks with the plain versions of the w fill and the
    sweeps (run on the card's tensors; the plain run launches none of
    the three kernels).  A block adds at most the family's multiplicity
    cap (2 edges, 3 tets) of contributions to a vertex, so the two sides'
    sums rarely differ in order, and then by an ulp."""
    import torch_sharded_ranks as tr

    from softbodysim_torch.kernels import sweep as ksw

    eng.state = s0
    eng.run(SHARDED_PLAIN_STEPS, DT)
    kern = eng.state
    saved = ksw.w_fill, ksw.edge_sweep, ksw.tet_sweep
    reset_counts()
    ksw.w_fill, ksw.edge_sweep, ksw.tet_sweep = (
        ksw.w_fill_plain, ksw.edge_sweep_plain, ksw.tet_sweep_plain)
    try:
        eng.state = s0
        eng.run(SHARDED_PLAIN_STEPS, DT)
        plain = eng.state
    finally:
        ksw.w_fill, ksw.edge_sweep, ksw.tet_sweep = saved
    launched = read_counts()              # the wrappers' counts, restored
    if any(launched[n] for n in ("w_fill", "edge_sweep", "tet_sweep")):
        raise AssertionError(f"phase L: the plain run launched kernels: "
                             f"{launched}")
    x_err = (kern.x - plain.x).abs().max().item()
    lam_rel = max(((getattr(kern, f) - getattr(plain, f)).abs().max()
                   / getattr(plain, f).abs().max()).item()
                  for f in ("edge_lambda", "tet_lambda"))
    work = np.abs(plain.x.double().cpu().numpy()
                  - tr.ballistic(s0, params, SHARDED_PLAIN_STEPS)).max()
    lam_max = min(getattr(plain, f).abs().max().item()
                  for f in ("edge_lambda", "tet_lambda"))
    return {"plain_x_err": x_err, "plain_lam_rel": lam_rel,
            "plain_work": float(work), "plain_lam_max": lam_max}


def sharded_rank(rank, world):
    """A spawned rank of phase L's D > 1 run: every rank on cuda:0, a gloo
    group whose collectives go through pinned host memory."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import softbodysim_torch as sbt
    from softbodysim_torch.parallel import make_mesh

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    topo = sbt.meshes.tet_cube(**NORTH_STAR)
    return run_sharded(sbt, topo, device, make_mesh(device_type="cuda"),
                       f"D={world} rank {rank}")


def sharded_path(sbt, topo, device, card: str) -> tuple:
    """Phase L: the kernel-sharded steps at full width.  D = 1 on NCCL in
    this process, then D = 2 as two spawned ranks sharing the card (gloo);
    each against the single-device step, each run twice equal bit for bit;
    'segment' twice bit for bit.  Returns (the D = 1 run's launch counts,
    a summary)."""
    import tempfile

    import torch.distributed as dist
    import torch_sharded_ranks as tr

    from softbodysim_torch.parallel import make_mesh, spawn

    t0 = time.perf_counter()
    # the single-device references: SHARDED_STEPS steps from the start,
    # and the ballistic move from it
    ref, free_move = {}, {}
    for name, (params, boxed) in sharded_params(sbt).items():
        e = sbt.Engine(topo, params, device=device,
                       colliders=floor_box(sbt, device) if boxed else None)
        e.state = tr.kicked(e, SEED, SHARDED_V_SIGMA)
        free_move[name] = tr.ballistic(e.state, params, SHARDED_STEPS)
        e.run(SHARDED_STEPS, DT)
        ref[name] = e.positions()
        del e
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            d1 = run_sharded(sbt, topo, device, make_mesh(), "D=1")
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    d2 = spawn(sharded_rank, 2, backend="gloo", timeout_s=600.0)

    def check(ok, what):
        if not ok:
            raise AssertionError(f"phase L: {what}")

    summary = {"card": card, "steps": SHARDED_STEPS}
    for D, runs in ((1, [d1]), (2, d2)):
        for name in ("xpbd", "jacobi"):
            r = runs[0][name]
            tol = (SHARDED_X_TOL if name == "xpbd" else PASS_TOL)
            err = float(np.abs(r["x"] - ref[name]).max())
            moved = np.abs(r["x"] - free_move[name]).max(axis=1)
            work = float(moved.max())
            halo_work = (float(moved[r["halo_vertices"]].max()) if D > 1
                         else None)
            # the largest position limit this run is held to
            need = SHARDED_WORK * (X_TOL if name == "xpbd" and D > 1
                                   else tol)
            ranks_same = all(np.array_equal(q[name]["x"], r["x"])
                             for q in runs[1:])
            line = {"ms_per_step": [q[name]["ms"] for q in runs],
                    "build_s": [q[name]["build_s"] for q in runs],
                    "collective_host_share": [
                        q[name]["collective_host_share"] for q in runs],
                    "transport": r["transport"], "backend": r["backend"],
                    "halo_per_rank": [q[name]["halo"] for q in runs],
                    "same_bits_twice": [q[name]["same_bits"] for q in runs],
                    "ranks_same_bits": ranks_same,
                    "err_vs_single_device": err,
                    "constraint_correction_m": work,
                    "halo_rows_correction_m": halo_work,
                    "correction_needed_m": need}
            print(f"phase L {name} D={D}: {json.dumps(line)} on {card}",
                  flush=True)
            check(all(line["same_bits_twice"]) and ranks_same,
                  f"{name} D={D}: a second run or another rank differs")
            check(np.isfinite(r["x"]).all(), f"{name} D={D}: non-finite")
            check(work >= need and (halo_work is None or halo_work >= need),
                  f"{name} D={D}: the constraints corrected {work} m "
                  f"({halo_work} m on the halo's rows), under {need} m: "
                  "the checks would not see a wrong halo")
            if name == "jacobi" or D == 1:
                check(err <= tol, f"{name} D={D} against the single-device "
                      f"step: {err} > {tol}")
            if name == "xpbd" and D > 1:
                pe = max(q[name]["plain_x_err"] for q in runs)
                pl = max(q[name]["plain_lam_rel"] for q in runs)
                pw = min(q[name]["plain_work"] for q in runs)
                lm = min(q[name]["plain_lam_max"] for q in runs)
                line.update(plain_x_err=pe, plain_lam_rel=pl, plain_work=pw,
                            plain_lam_max=lm)
                print(f"phase L xpbd D={D}: {SHARDED_PLAIN_STEPS} step with "
                      f"the kernels against the plain versions: positions "
                      f"{pe:.3e} m (tol {X_TOL}), lambdas {pl:.3e} of the "
                      f"largest (tol {LAM_REL_TOL}); constraint correction "
                      f"{pw:.3e} m (needed {SHARDED_WORK * X_TOL:.1e}), "
                      f"largest |lambda| {lm:.3e}", flush=True)
                check(pe <= X_TOL and pl <= LAM_REL_TOL,
                      f"xpbd D={D}: kernels and plain versions disagree")
                check(pw >= SHARDED_WORK * X_TOL and lm > 0.0,
                      f"xpbd D={D}: the plain check's run did no "
                      f"constraint work ({pw} m)")
            summary[f"{name}_D{D}"] = line
    counts = {name: d1[name]["counts"] for name in ("xpbd", "jacobi")}
    check_launched(counts["xpbd"], ("w_fill", "edge_sweep", "tet_sweep"),
                   "phase L xpbd D=1")
    check_launched(counts["jacobi"], ("jacobi_edge_accumulate",
                                      "jacobi_tet_accumulate", "collide"),
                   "phase L jacobi D=1")
    for q in d2:
        check_launched(q["jacobi"]["counts"], (
            "jacobi_edge_accumulate", "jacobi_tet_accumulate", "collide"),
            "phase L jacobi D=2")
        check_launched(q["xpbd"]["counts"], ("w_fill", "edge_sweep",
                                             "tet_sweep"), "phase L xpbd D=2")
    summary["segment"] = segment_repeat(sbt, topo, device)
    summary["seconds"] = time.perf_counter() - t0
    merged = collections.Counter()
    for c in counts.values():
        merged.update(c)
    return dict(merged), summary


def segment_repeat(sbt, topo, device) -> dict:
    """Phase 4's configuration forced to 'segment', SHARDED_STEPS steps
    twice from phase L's start: the same bits (its sums are int64 fixed
    point)."""
    import torch_sharded_ranks as tr

    params = sbt.SolverParams(**{**JACOBI, "jacobi_backend": "segment"})
    eng = sbt.Engine(topo, params, colliders=floor_box(sbt, device),
                     device=device)
    s0 = eng.state = tr.kicked(eng, SEED, SHARDED_V_SIGMA)
    eng.run(SHARDED_STEPS, DT)
    a = eng.state
    eng.state = s0
    eng.run(SHARDED_STEPS, DT)
    b = eng.state
    same = torch.equal(a.x, b.x) and torch.equal(a.v, b.v)
    work = float(np.abs(a.x.double().cpu().numpy()
                        - tr.ballistic(s0, params, SHARDED_STEPS)).max())
    print(f"phase L 'segment' twice, {SHARDED_STEPS} steps: bit for bit "
          f"{same}, constraint correction {work:.3e} m", flush=True)
    if not same:
        raise AssertionError("phase L: two 'segment' runs differ")
    if not work >= SHARDED_WORK * PASS_TOL:
        raise AssertionError(f"phase L: 'segment' corrected {work} m")
    return {"same_bits": same, "constraint_correction_m": work}


# --------------------------------------------------------------------------
# Phase O: the vertex-sharded, data-parallel and constraint-parallel modes
# --------------------------------------------------------------------------

# steps of each phase O run (and of its timed repeat)
MODES_STEPS = 4
# the xpbd vertex-sharded step against the single-device coloured step:
# positions (m) and lambdas; the jacobi vertex-sharded step (m)
MODES_X_TOL = 1e-5
MODES_LAM_TOL = 1e-4
MODES_J_TOL = 2e-5
# O3: the data- and constraint-parallel steps against the batched step (m)
MODES_BATCH_TOL = 1e-5
# O4: a mesh rollout's gradient against the single-device one, relative
# to the latter's largest entry
MODES_GRAD_TOL = 1e-3
# O3's scenes: bench.py's batched_128x_jacobi, and an xpbd batch
MODES_CUBE = dict(nx=10, ny=10, nz=10, size=0.8, center=(0.0, 1.0, 0.0))
MODES_JACOBI_B, MODES_XPBD_B = 128, 8


def modes_params(sbt) -> dict:
    """O1 / O2's two paths: the north star on the xpbd vertex-sharded step
    (8 x 1, 'gather') and phase 4's configuration on the jacobi
    vertex-sharded step (2 x 6, 'gather', the floor box)."""
    return {"xpbd": (sbt.SolverParams(dialect="xpbd", substeps=8,
                                      iterations=1, xpbd_backend="gather"),
                     False),
            "jacobi": (sbt.SolverParams(**{**JACOBI,
                                           "jacobi_backend": "gather"}),
                       True)}


def modes_halo(step) -> dict:
    """The vertex-sharded step's halo: its mode and bytes per exchange
    against the full gather's."""
    inner = getattr(step, "inner", step)
    if hasattr(inner, "comm_bytes_per_sweep"):
        return {"mode": inner.halo_mode, "per": "sweep",
                "bytes": inner.comm_bytes_per_sweep,
                "full_gather_bytes": inner.comm_bytes_full_gather}
    return {"mode": inner.halo_mode, "per": "colour",
            "bytes": inner.comm_bytes_per_color,
            "full_gather_bytes": inner.full_gather_bytes}


def run_modes(sbt, topo, device, mesh) -> dict:
    """One rank's O1 / O2: each path's Engine(mesh=...) run MODES_STEPS
    steps from seeded velocities with the launch counts set to 0 just
    before and read just after, then again from the same start, timed
    (host clock, ending in a synchronize; the gathers of the public state
    included), the host's seconds inside collectives over it."""
    import torch_sharded_ranks as tr

    out = {}
    for name, (params, boxed) in modes_params(sbt).items():
        cols = floor_box(sbt, device) if boxed else None
        t0 = time.perf_counter()
        eng = sbt.Engine(topo, params, colliders=cols, mesh=mesh,
                         device=device)
        build_s = time.perf_counter() - t0
        s0 = eng.state = tr.kicked(eng, SEED, SHARDED_V_SIGMA)
        reset_counts()
        eng.run(MODES_STEPS, DT)
        first = eng.state
        eng.block()
        counts = read_counts()
        ax = eng._raw_step.axis
        ax.host_seconds = 0.0
        eng.state = s0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.run(MODES_STEPS, DT)
        again = eng.state
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        out[name] = {
            "x": first.x.cpu().numpy(),
            "edge_lambda": first.edge_lambda.cpu().numpy(),
            "tet_lambda": first.tet_lambda.cpu().numpy(),
            "same_bits": all(torch.equal(getattr(first, f),
                                         getattr(again, f))
                             for f in ("x", "v", "edge_lambda",
                                       "tet_lambda")),
            "counts": counts, "ms": wall * 1e3 / MODES_STEPS,
            "build_s": build_s,
            "work": float(np.abs(first.x.double().cpu().numpy()
                                 - tr.ballistic(s0, params,
                                                MODES_STEPS)).max()),
            "collective_host_share": ax.host_seconds / wall,
            "transport": ax.transport(first.x), "backend": eng.backend,
            "halo": modes_halo(eng._raw_step)}
        del eng
        torch.cuda.empty_cache()
    return out


def batched_modes(sbt, device, world: int) -> dict:
    """One rank's O3: bench.py's batched_128x_jacobi through
    make_data_parallel_step (d = world) and make_mesh_sharded_step
    ((1, 1) at one rank; (2, 1) and (1, 2) at two), and 8 xpbd scenes
    through make_xpbd_sharded_step ((1, 1); (1, 2)): MODES_STEPS steps
    each, all but the first (which builds the union's step) timed (host
    clock, ending in a synchronize), the whole batch gathered back."""
    from softbodysim_torch.parallel import (
        gather_batch, init_batch_state, make_data_parallel_step, make_mesh,
        make_mesh_sharded_step, make_xpbd_sharded_step, shard_batch)

    topo = sbt.meshes.tet_cube(**MODES_CUBE)
    jp, xp = modes_batch_params(sbt)

    def batch(b, mode):
        return init_batch_state(topo, b, inv_mass_mode=mode,
                                key=torch.Generator().manual_seed(SEED),
                                pos_jitter=0.002, device=device)

    dc = "cuda"
    shapes = [(1, 1)] if world == 1 else [(2, 1), (1, 2)]
    runs = [("data_parallel", f"d={world}", make_data_parallel_step, jp,
             make_mesh(axis_names=("data",), device_type=dc),
             MODES_JACOBI_B, "density")]
    for d, m in shapes:
        runs.append(("mesh_sharded", f"{d}x{m}", make_mesh_sharded_step,
                     jp, make_mesh(shape=(d, m), axis_names=("data",
                                                             "model"),
                                   device_type=dc), MODES_JACOBI_B,
                     "density"))
    xshape = (1, world)
    runs.append(("xpbd_sharded", f"{xshape[0]}x{xshape[1]}",
                 make_xpbd_sharded_step, xp,
                 make_mesh(shape=xshape, axis_names=("data", "model"),
                           device_type=dc), MODES_XPBD_B, "tet"))
    out = {}
    for kind, label, make, params, mesh, b, mode in runs:
        step = make(topo, params, mesh, device=device)
        # the first step builds the block's union: untimed
        block = step(shard_batch(batch(b, mode), mesh), DT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MODES_STEPS - 1):
            block = step(block, DT)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (MODES_STEPS - 1)
        full = gather_batch(block, mesh)
        out[f"{kind} {label}"] = {
            "x": full.x.cpu().numpy(), "ms": ms,
            "edge_lambda": full.edge_lambda.cpu().numpy(),
            "block": int(block.x.shape[0])}
    return out


def modes_batch_params(sbt) -> tuple:
    """O3's jacobi (phase D's: phase 4's configuration on 'gather') and
    xpbd (the north star's 8 x 1 on the coloured backend) parameters."""
    return (sbt.SolverParams(**{**JACOBI, "jacobi_backend": "gather"}),
            sbt.SolverParams(dialect="xpbd", substeps=8, iterations=1,
                             xpbd_backend="gather"))


def modes_rank(rank, world):
    """A spawned rank of O2 / O3's two-rank runs: every rank on cuda:0, a
    gloo group whose collectives go through pinned host memory."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import softbodysim_torch as sbt
    from softbodysim_torch.parallel import make_mesh

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    topo = sbt.meshes.tet_cube(**NORTH_STAR)
    out = run_modes(sbt, topo, device, make_mesh(device_type="cuda"))
    out["batched"] = batched_modes(sbt, device, world)
    return out


def modes_grads(sbt, topo, device) -> dict:
    """O4 at D = 1: one value_and_grad of ``diff.make_rollout(mesh=)`` per
    dialect over MODES_STEPS steps, against the single-device gradient of
    phase K's configurations: xpbd (K1's 8 x 1 coloured build; the mesh
    step is make_xpbd_sharded_step forward, the coloured build's VJP
    backward) d mean(traj^2) / d v0 from seeded velocities; jacobi (K2's
    floor box, 'segment', the body 5 cm into the box) d loss / d
    (edge_stiffness, sor_omega) of a trajectory loss."""
    from softbodysim_torch import diff
    from softbodysim_torch.parallel import make_mesh

    mesh = make_mesh(shape=(1, 1), axis_names=("data", "model"))
    f32t = dict(dtype=torch.float32, device=device)
    out = {}

    def batched(st):
        return sbt.SimState(**{f: getattr(st, f)[None] for f in (
            "x", "v", "x_star", "inv_mass", "edge_lambda", "tet_lambda")})

    xp = sbt.SolverParams(substeps=8, iterations=1)
    s0 = sbt.init_state(topo, device=device)
    v0 = torch.from_numpy(np.random.default_rng(SEED).normal(
        0.0, 0.5, (topo.num_particles, 3)).astype(np.float32)).to(device)
    grads = {}
    for label, kw, wrap in (("single", {}, lambda st: st),
                            ("mesh", {"mesh": mesh}, batched)):
        roll = diff.make_rollout(topo, xp, dt=DT, nsteps=MODES_STEPS,
                                 remat=False, device=device, **kw)
        v = v0.clone().requires_grad_(True)
        reset_counts()
        _, (g,), ms, peak = timed_grad(lambda: torch.mean(torch.square(
            roll(wrap(with_velocity(sbt, s0, v))))), (v,))
        grads[label] = g
        out[f"xpbd_{label}_ms"] = ms
    ref = grads["single"]
    err = float((grads["mesh"] - ref).abs().max() / ref.abs().max())
    out["xpbd_grad_rel"] = err
    print(f"phase O4 xpbd d mean(traj^2)/d v0 over {MODES_STEPS} steps, "
          f"mesh (1, 1) against the single-device coloured build: max "
          f"|diff| / max |ref| {err:.3e} (tol {MODES_GRAD_TOL}); "
          f"{out['xpbd_mesh_ms']:.0f} / {out['xpbd_single_ms']:.0f} ms",
          flush=True)
    if not err <= MODES_GRAD_TOL:
        raise AssertionError("phase O4: the xpbd mesh gradient differs")

    jp = sbt.SolverParams(**JACOBI)
    box = floor_box(sbt, device)
    drop = float(topo.vertices[:, 1].min()) - (FLOOR_BOX_TOP - 0.05)
    x = s0.x - torch.tensor([0.0, drop, 0.0], **f32t)
    st = sbt.SimState(x=x, v=s0.v, x_star=x, inv_mass=s0.inv_mass,
                      edge_lambda=s0.edge_lambda, tet_lambda=s0.tet_lambda)
    with torch.no_grad():
        target = diff.make_rollout(topo, jp, dt=DT, nsteps=MODES_STEPS,
                                   colliders=box, device=device)(
            st, {"edge_stiffness": 0.6, "sor_omega": 1.2})
    grads = {}
    for label, kw, state0, tgt in (("single", {}, st, target),
                                   ("mesh", {"mesh": mesh}, batched(st),
                                    target[:, None])):
        loss = diff.make_trajectory_loss(topo, jp, tgt, dt=DT,
                                         state0=state0, colliders=box,
                                         remat=False, device=device, **kw)
        k = torch.tensor(jp.edge_stiffness, **f32t, requires_grad=True)
        om = torch.tensor(jp.sor_omega, **f32t, requires_grad=True)
        reset_counts()
        _, g, ms, _ = timed_grad(
            lambda: loss({"edge_stiffness": k, "sor_omega": om}), (k, om))
        counts = read_counts()
        check_launched(counts, ("collide",), f"phase O4 jacobi {label}")
        grads[label] = torch.stack(g)
        out[f"jacobi_{label}_ms"] = ms
    ref = grads["single"]
    err = float((grads["mesh"] - ref).abs().max() / ref.abs().max())
    out["jacobi_grad_rel"] = err
    print(f"phase O4 jacobi d loss/d (edge_stiffness, sor_omega) "
          f"{grads['mesh'].tolist()} against the single-device "
          f"{ref.tolist()}: rel {err:.3e} (tol {MODES_GRAD_TOL})",
          flush=True)
    if not err <= MODES_GRAD_TOL:
        raise AssertionError("phase O4: the jacobi mesh gradient differs")
    return out


def modes_path(sbt, topo, device, card: str) -> tuple:
    """Phase O: the vertex-sharded steps behind Engine(mesh=...) (O1 at
    D = 1 on NCCL in this process, O2 at D = 2 as two spawned gloo ranks
    on the card), the data- and constraint-parallel steps (O3) and the
    mesh rollouts' gradients (O4).  Returns (O1's launch counts, a
    summary)."""
    import tempfile

    import torch.distributed as dist
    import torch_sharded_ranks as tr

    from softbodysim_torch.parallel import make_batched_step, spawn

    t0 = time.perf_counter()
    ref = {}
    for name, (params, boxed) in modes_params(sbt).items():
        e = sbt.Engine(topo, params, device=device,
                       colliders=floor_box(sbt, device) if boxed else None)
        e.state = tr.kicked(e, SEED, SHARDED_V_SIGMA)
        e.run(MODES_STEPS, DT)
        ref[name] = {f: getattr(e.state, f).cpu().numpy()
                     for f in ("x", "edge_lambda", "tet_lambda")}
        del e
    cube = sbt.meshes.tet_cube(**MODES_CUBE)
    batch_ref = {}
    for kind, params, b, mode in zip(
            ("jacobi", "xpbd"), modes_batch_params(sbt),
            (MODES_JACOBI_B, MODES_XPBD_B), ("density", "tet")):
        from softbodysim_torch.parallel import init_batch_state

        st = init_batch_state(cube, b, inv_mass_mode=mode,
                              key=torch.Generator().manual_seed(SEED),
                              pos_jitter=0.002, device=device)
        step = make_batched_step(cube, params, device=device)
        for _ in range(MODES_STEPS):
            st = step(st, DT)
        batch_ref[kind] = {"x": st.x.cpu().numpy(),
                           "edge_lambda": st.edge_lambda.cpu().numpy()}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            from softbodysim_torch.parallel import make_mesh

            d1 = run_modes(sbt, topo, device, make_mesh())
            d1["batched"] = batched_modes(sbt, device, 1)
            grads = modes_grads(sbt, topo, device)
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    d2 = spawn(modes_rank, 2, backend="gloo", timeout_s=600.0)

    def check(ok, what):
        if not ok:
            raise AssertionError(f"phase O: {what}")

    summary = {"card": card, "steps": MODES_STEPS, "gradients": grads}
    for D, runs in ((1, [d1]), (2, d2)):
        for name in ("xpbd", "jacobi"):
            r = runs[0][name]
            err = float(np.abs(r["x"] - ref[name]["x"]).max())
            lam = max(float(np.abs(r[f] - ref[name][f]).max())
                      for f in ("edge_lambda", "tet_lambda"))
            ranks_same = all(
                np.array_equal(q[name][f], r[f]) for q in runs[1:]
                for f in ("x", "edge_lambda", "tet_lambda"))
            line = {"ms_per_step": [q[name]["ms"] for q in runs],
                    "build_s": [q[name]["build_s"] for q in runs],
                    "collective_host_share": [
                        q[name]["collective_host_share"] for q in runs],
                    "transport": r["transport"], "backend": r["backend"],
                    "halo": [q[name]["halo"] for q in runs],
                    "same_bits_twice": [q[name]["same_bits"] for q in runs],
                    "ranks_same_bits": ranks_same,
                    "err_vs_single_device": err,
                    "lambda_err_vs_single_device": lam,
                    "constraint_correction_m": r["work"],
                    "launches": [{k: v for k, v in q[name][
                        "counts"].items() if v} for q in runs]}
            print(f"phase O {name} D={D}: {json.dumps(line)} on {card}",
                  flush=True)
            tol = MODES_X_TOL if name == "xpbd" else MODES_J_TOL
            check(all(line["same_bits_twice"]) and ranks_same,
                  f"{name} D={D}: a second run or another rank differs")
            check(np.isfinite(r["x"]).all(), f"{name} D={D}: non-finite")
            check(err <= tol, f"{name} D={D} against the single-device "
                  f"step: {err} > {tol}")
            check(r["work"] >= SHARDED_WORK * tol, f"{name} D={D}: the "
                  f"constraints corrected {r['work']} m, under "
                  f"{SHARDED_WORK * tol} m")
            if name == "xpbd":
                check(lam <= MODES_LAM_TOL, f"xpbd D={D}: lambdas {lam}")
            else:
                for q in runs:
                    check_launched(q[name]["counts"], ("collide",),
                                   f"phase O jacobi D={D}")
            summary[f"{name}_D{D}"] = line
        for label, r in runs[0]["batched"].items():
            kind = "xpbd" if label.startswith("xpbd") else "jacobi"
            want = batch_ref[kind]
            err = float(np.abs(r["x"] - want["x"]).max())
            lam = float(np.abs(r["edge_lambda"]
                               - want["edge_lambda"]).max())
            same = all(np.array_equal(q["batched"][label]["x"], r["x"])
                       for q in runs[1:])
            line = {"ms_per_step": [q["batched"][label]["ms"]
                                    for q in runs],
                    "block": r["block"], "err_vs_batched": err,
                    "lambda_err_vs_batched": lam, "ranks_same_bits": same}
            print(f"phase O3 {label} D={D}: {json.dumps(line)} on {card}",
                  flush=True)
            check(same, f"O3 {label}: the ranks differ")
            check(err <= MODES_BATCH_TOL, f"O3 {label} against the batched "
                  f"step: {err} > {MODES_BATCH_TOL}")
            if kind == "xpbd":
                check(lam <= MODES_LAM_TOL, f"O3 {label}: lambdas {lam}")
            summary[f"O3 {label} D={D}"] = line
    summary["seconds"] = time.perf_counter() - t0
    merged = collections.Counter()
    for name in ("xpbd", "jacobi"):
        merged.update(d1[name]["counts"])
    return dict(merged), summary


# --------------------------------------------------------------------------
# Phase P: the entry hooks (softbodysim_torch/entry.py) and the examples
# --------------------------------------------------------------------------

# entry()'s step on the card against entry(device="cpu"), calls compared
HOOK_STEPS = 10
# entry() and every dry-run mode, card against CPU (m)
HOOK_TOL = 1e-4
# the kernels each dry-run mode launches on the card (modes 1, 3 and 6
# push out of the ground or the sphere with the collide kernel; 2 and 4
# clamp the ground in plain ops and have no collider)
HOOK_KERNELS = {
    "jacobi_mesh": ("collide",),
    "jacobi_vertex": ("collide",),
    "xpbd_sweep_sharded": ("w_fill", "edge_sweep", "tet_sweep", "collide"),
    "jacobi_pass_sharded": ("jacobi_edge_accumulate",
                            "jacobi_tet_accumulate", "collide")}
HOOK_COUNTED = ("collide", "w_fill", "edge_sweep", "tet_sweep",
                "jacobi_edge_accumulate", "jacobi_tet_accumulate")
# examples.datagen: scenes and timed steps
DATAGEN_ARGS = ("--batch", "4096", "--steps", "10")
COLLIDER_ARGS = ("--steps", "30")
# examples.checkpoint_resume: the uninterrupted run's steps (saved half way)
CHECKPOINT_ARGS = ("--steps", "20")


def entry_check(device) -> dict:
    """P1: ``entry()`` on the card, HOOK_STEPS calls, each against the same
    call of ``entry(device="cpu")``; then three warm 5-call windows."""
    from softbodysim_torch.entry import entry

    fn, (st, dt) = entry()
    cfn, (cst, _) = entry(device="cpu")
    if st.x.device != device:
        raise AssertionError(f"phase P: entry() built on {st.x.device}")
    reset_counts()
    errs = []
    for _ in range(HOOK_STEPS):
        st, cst = fn(st, dt), cfn(cst, dt)
        errs.append(float((st.x.cpu() - cst.x).abs().max()))
    counts = {k: v for k, v in read_counts().items() if v}
    print(f"phase P entry(): {tuple(st.x.shape)} after {HOOK_STEPS} calls, "
          f"max |card - cpu| per call {[f'{e:.2e}' for e in errs]} (tol "
          f"{HOOK_TOL}); launches {counts}", flush=True)
    if not (np.isfinite(st.x.cpu().numpy()).all()
            and max(errs) <= HOOK_TOL):
        raise AssertionError("phase P: entry() on the card differs from "
                             "the CPU")

    def run(n):
        nonlocal st
        for _ in range(n):
            st = fn(st, dt)

    ms = window_ms("phase P entry()", run, 5)
    return {"max_err": max(errs), "ms_per_step": ms, "launches": counts}


def dryrun_check(device) -> dict:
    """P2: ``dryrun_multichip(1)`` (NCCL, one rank) and
    ``dryrun_multichip(2, backend="gloo")`` (two ranks on the card), each
    mode's rank-0 positions against the same call with device="cpu", every
    rank's replicated positions the same bits, and each mode's kernels
    launched on every rank.  The four calls run at once, a thread each."""
    import threading

    from softbodysim_torch.entry import MODES, dryrun_multichip

    card, cpu, errors = {}, {}, []

    def call(out, n, **kw):
        try:
            t0 = time.perf_counter()
            out[n] = dryrun_multichip(n, **kw)
            out[n]["seconds"] = time.perf_counter() - t0
        except Exception as e:                    # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=call, args=args, kwargs=kw)
               for args, kw in (((card, 1), {}),
                                ((card, 2), {"backend": "gloo"}),
                                ((cpu, 1), {"device": "cpu"}),
                                ((cpu, 2), {"device": "cpu"}))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    out = {}
    for n, backend in ((1, "nccl"), (2, "gloo")):
        res = card[n]
        line = {"backend": backend, "seconds": res["seconds"], "modes": {}}
        for mode in MODES:
            x = res["positions"][mode]
            err = float(np.abs(x - cpu[n]["positions"][mode]).max())
            same = all(np.array_equal(r[mode], x) for r in res["ranks"])
            launches = [{k: r[mode].get(k, 0) for k in HOOK_COUNTED}
                        for r in res["launches"]]
            line["modes"][mode] = {"max_err_vs_cpu": err,
                                   "ranks_same_bits": same,
                                   "launches": launches}
            print(f"phase P dryrun_multichip({n}, {backend}) {mode}: "
                  f"{x.shape}, max |card - cpu| {err:.3e} (tol {HOOK_TOL}), "
                  f"ranks the same bits {same}, launches per rank "
                  f"{launches}", flush=True)
            if not (np.isfinite(x).all() and err <= HOOK_TOL and same):
                raise AssertionError(f"phase P dryrun {n} {mode}: {err}, "
                                     f"ranks the same {same}")
            for counts in launches:
                check_launched(counts, HOOK_KERNELS.get(mode, ()),
                               f"phase P dryrun {n} {mode}")
        out[f"D{n}"] = line
    return out


def entry_module_start():
    """P3: ``python -m softbodysim_torch.entry`` as a subprocess."""
    return subprocess.Popen(
        [sys.executable, "-m", "softbodysim_torch.entry"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def entry_module_check(proc) -> None:
    out, _ = proc.communicate(timeout=300)
    tail = out.strip().splitlines()[-2:]
    print(f"phase P python -m softbodysim_torch.entry: exit "
          f"{proc.returncode}, {tail}", flush=True)
    if proc.returncode != 0 or not (
            any(s.startswith("entry OK: (343, 3)") for s in tail)
            and tail[-1] == "dryrun_multichip OK"):
        raise AssertionError(f"phase P: python -m softbodysim_torch.entry "
                             f"failed:\n{out[-4000:]}")


def examples_check(card: str) -> dict:
    """P4: examples.datagen at 4096 scenes (its rates), moving_collider
    (the collide kernel launched, no particle inside the capsule) and
    checkpoint_resume (bit for bit), on the card."""
    from softbodysim_torch.examples import (checkpoint_resume, datagen,
                                            moving_collider)

    out = {}
    gen = datagen.main(list(DATAGEN_ARGS))
    out["datagen_4096"] = {k: gen[k] for k in (
        "seconds", "scene_steps_per_s", "projections_per_s")}
    print(f"phase P examples.datagen {' '.join(DATAGEN_ARGS)}: "
          f"{gen['scene_steps_per_s']:.1f} scene-steps/s, "
          f"{gen['projections_per_s']:.4g} projections/s on {card}",
          flush=True)
    if not np.isfinite(gen["positions"]).all():
        raise AssertionError("phase P: datagen diverged")
    reset_counts()
    moving_collider.main(list(COLLIDER_ARGS))
    counts = read_counts()
    check_launched(counts, ("collide",), "phase P moving_collider")
    out["moving_collider_collide_launches"] = counts["collide"]
    diff = checkpoint_resume.main(list(CHECKPOINT_ARGS))
    print(f"phase P examples: moving_collider {' '.join(COLLIDER_ARGS)} "
          f"collide launches {counts['collide']}; checkpoint_resume "
          f"{' '.join(CHECKPOINT_ARGS)} max diff {diff}", flush=True)
    if diff != 0.0:
        raise AssertionError("phase P: checkpoint_resume is not bit-exact")
    out["checkpoint_resume_diff"] = diff
    return out


def hooks_path(device, card: str) -> dict:
    """Phase P: entry() (P1), dryrun_multichip (P2), the module's
    ``__main__`` (P3) and three examples (P4)."""
    t0 = time.perf_counter()
    out = {"entry": entry_check(device)}
    out["examples"] = examples_check(card)
    # the module and the dry runs last: they share the card with this
    # process's timed work otherwise
    proc = entry_module_start()
    try:
        out["dryrun"] = dryrun_check(device)
        entry_module_check(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out["seconds"] = time.perf_counter() - t0
    out["card"] = card
    return out


# --------------------------------------------------------------------------
# Phase M: the bf16 particle table; phase N: softbodysim_torch.perf
# --------------------------------------------------------------------------

# M1: the bf16 kernels against their plain versions on the same bf16
# table.  The two sum a row's corrections in f32 in different orders (CSR
# rows against index_add_), and a difference of a few f32 ulp at a bf16
# rounding boundary rounds one bf16 ulp apart: every coordinate within 1
# bf16 ulp of its magnitude (2^-7 m at |x| in [1, 2), 2^-6 at [2, 4)), at
# least BF16_ROWS_EQUAL of the rows bit-equal; the w fill bit for bit;
# lambdas within LAM_REL_TOL of the largest.  Never held at X_TOL.
BF16_ROWS_EQUAL = 0.9
# M2: the north star on the bf16 table against the f32 Engine, both 33
# steps from rest (the body reaches the ground): mean y within this (m),
# under one bf16 ulp at the body's height (2^-7 m)
BF16_MEAN_Y_TOL = 2.0 ** -7
# phase N: north-star steps traced
TRACE_STEPS = 4


def bf16_agreement(got, want) -> tuple:
    """(largest |got - want| in bf16 ulps of the coordinate, share of the
    rows bit-equal) of two (V, 4) tables."""
    a, b = got[:, :3].float(), want[:, :3].float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulps = ((a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7))
    return (ulps.max().item(),
            (got == want).all(1).float().mean().item())


def check_bf16(name, got, want, before) -> float:
    """Hold a bf16 table against its plain version (BF16_ROWS_EQUAL, 1
    bf16 ulp; w untouched); its max |diff| in m."""
    ulps, equal = bf16_agreement(got, want)
    err = (got.float() - want.float()).abs().max().item()
    moved = (got.float() - before.float()).abs().max().item()
    print(f"{name}: max|x_kernel - x_plain| = {err:.3e} m, {ulps:.2f} bf16 "
          f"ulp (tol 1), rows bit-equal {equal:.4f} (at least "
          f"{BF16_ROWS_EQUAL}), max move {moved:.3e} m", flush=True)
    if not (ulps <= 1.0 and equal >= BF16_ROWS_EQUAL):
        raise AssertionError(f"{name}: the bf16 tables disagree")
    if not torch.equal(got[:, 3], before[:, 3]):
        raise AssertionError(f"{name}: the inverse masses were written")
    if not moved > 0.0:
        raise AssertionError(f"{name}: nothing moved")
    return err


def compare_bf16_kernels(sbt, ksw, topo, device) -> tuple:
    """Phase M1: the bf16 w fill, sweeps and collide stage against their
    plain versions on the north star's perturbed table (phase 11's)
    rounded to bf16, and each sweep's schedule against one CTA bit for
    bit.  No profiler runs here: returns ({name: the result row without
    its kernel time}, {name: a call of the kernel}) for phase 11 to time."""
    from softbodysim_torch.kernels import collide as kc

    step, xw32, alphas = perturbed_table(sbt, topo, device, superblocks=True)
    xw = xw32.to(torch.bfloat16)
    ks = step.block_scheme["local_iters"]
    rows, calls = {}, {}

    # w fill: bit for bit (the same two products and sum on the same
    # upcast w)
    err, plain_ms, nb, ops = 0.0, 0.0, 0, 0
    wtabs = {}
    for fam in ("edges", "tets"):
        plan = step.device_plans[fam]
        wk = wtabs[fam] = ksw.w_fill(plan, xw)
        wp = ksw.w_fill_plain(plan, xw)
        torch.cuda.synchronize()
        if not torch.equal(wk, wp):
            raise AssertionError(f"w_fill_bf16 ({fam}) disagrees: "
                                 f"{(wk - wp).abs().max().item()}")
        plain_ms += events_ms(lambda p=plan: ksw.w_fill_plain(p, xw), 20)
        nb += nbytes(plan.verts, plan.counts, xw, wk)
        ops += wk.numel() * (3 if plan.arity == 2 else 1)
    print("w_fill_bf16: the kernel's tables equal the plain version's bit "
          "for bit", flush=True)
    rows["w_fill_bf16"] = (err, plain_ms, nb, ops)
    calls["w_fill_bf16"] = [lambda p=step.device_plans[f]: ksw.w_fill(p, xw)
                            for f in ("edges", "tets")]

    for name, fam, k, fn, plain, lane_ops in (
            ("edge_sweep_bf16", "edges", ks[0], ksw.edge_sweep,
             ksw.edge_sweep_plain, 26),
            ("tet_sweep_bf16", "tets", ks[1], ksw.tet_sweep,
             ksw.tet_sweep_plain, 140)):
        plan, a, wt = step.device_plans[fam], alphas[fam], wtabs[fam]
        lam0 = torch.zeros(plan.num_blocks * plan.width, device=device)
        xa, la, xb, lb = xw.clone(), lam0.clone(), xw.clone(), lam0.clone()
        fn(plan, xa, la, wt, a, k)
        plain(plan, xb, lb, wt, a, k)
        torch.cuda.synchronize()
        ex = check_bf16(name, xa, xb, xw)
        el = (la - lb).abs().max().item()
        lmax = lb.abs().max().item()
        print(f"{name}: max|lam diff| = {el:.3e} (max|lam| {lmax:.3e}, rel "
              f"tol {LAM_REL_TOL})", flush=True)
        if not el <= LAM_REL_TOL * lmax:
            raise AssertionError(f"{name}: lambdas disagree ({el})")
        one = ksw.to_device(step.gpu_plans[fam], device, queues=1)
        check_schedule(name, plan, one, xw, lam0,
                       lambda x, l, p=plan: fn(p, x, l, wt, a, k))
        plain_ms = events_ms(lambda: plain(plan, xb, lb, wt, a, k), 2)
        st = plan.staged
        live = int((plan.verts[:, 0] >= 0).sum().item())
        nb = (2 * nbytes(xw, lam0)
              + nbytes(st.lrow, plan.rest, plan.scale, plan.atab, wt,
                       st.rec, st.qinfo, st.qptr))
        rows[name] = (max(ex, el), plain_ms, nb,
                      k * (lane_ops * live + 6 * plan.lane.numel()))
        calls[name] = [lambda p=plan, f=fn, x=xa, l=la, w=wt, a=a, k=k:
                       f(p, x, l, w, a, k)]

    # collide on the bf16 table: the lowest 5 cm of the body inside a box
    # (free rows read and written once; an oriented box ~80 flops each)
    ymin = float(xw[:, 1].float()[xw[:, 3] != 0].min().item())
    packed = kc.pack_colliders(sbt.Colliders.build([sbt.Colliders.box(
        (0.0, ymin - 0.05, 0.0), (1.5, 0.1, 1.5))], device=device))
    xa = xw.clone()
    kc.collide(xa, packed, kc.XPBD_GROUND)
    xb = kc.collide_plain(xw, packed, kc.XPBD_GROUND)
    torch.cuda.synchronize()
    err = check_bf16("collide_bf16", xa, xb, xw)
    free = int((xw[:, 3] != 0).sum().item())
    rows["collide_bf16"] = (
        err, events_ms(lambda: kc.collide_plain(xw, packed, kc.XPBD_GROUND),
                       5), nbytes(xw, packed) + 8 * free, 80 * free)
    calls["collide_bf16"] = [lambda: kc.collide(xa, packed, kc.XPBD_GROUND)]
    return rows, calls


def time_bf16_kernels(rows, calls) -> dict:
    """Phase 11: each bf16 kernel's device time per call; its result row."""
    res = {}
    for name, (err, plain_ms, nb, ops) in rows.items():
        ms = sum(kernel_ms(c, 10) for c in calls[name])
        res[name] = result(err, ms, plain_ms, nb, ops)
        report(name, res[name])
    return res


def bf16_main_path(sbt, topo, device, x_ms: float) -> tuple:
    """Phase M2-M3: the north star on the bf16 table (8 x 1), against the
    f32 Engine, then on a box just under the body; (launch counts of each,
    ms/step of a timed window)."""
    params = sbt.SolverParams(dialect="xpbd", substeps=8, iterations=1)
    bf16 = params.replace(xpbd_x_dtype="bfloat16")
    f32_eng = sbt.Engine(topo, params, device=device)
    f32_eng.run(32, DT)
    f32_eng.step(DT)
    reset_counts()
    t0 = time.perf_counter()
    eng = sbt.Engine(topo, bf16, device=device)
    eng.run(32, DT)
    eng.step(DT)
    eng.block()
    counts = read_counts()
    eng.raise_on_timeouts()
    if eng.backend != "sweep" or eng._carry.xw.dtype != torch.bfloat16:
        raise AssertionError("phase M: not the sweep step on a bf16 table")
    pos, ref = eng.positions(), f32_eng.positions()
    del f32_eng
    print(f"phase M bf16 north star: backend {eng.backend}, table "
          f"{eng._carry.xw.dtype}, 33 steps in {time.perf_counter() - t0:.2f}"
          f" s (incl. set-up), launches {counts}", flush=True)
    check_launched(counts, ("w_fill_bf16", "edge_sweep_bf16",
                            "tet_sweep_bf16"), "phase M")
    ran_f32 = {k: counts[k] for k in ("w_fill", "edge_sweep", "tet_sweep")
               if counts[k]}
    if ran_f32:
        raise AssertionError(f"phase M: f32 kernels launched: {ran_f32}")
    if not np.isfinite(pos).all():
        raise AssertionError("phase M: non-finite positions")
    dy = abs(float(pos[:, 1].mean() - ref[:, 1].mean()))
    d = np.abs(pos - ref)
    worst = np.unravel_index(d.argmax(), d.shape)
    print(f"phase M bf16 against f32 after 33 steps: mean y "
          f"{pos[:, 1].mean():.6f} / {ref[:, 1].mean():.6f} m (|diff| "
          f"{dy:.3e}, tol {BF16_MEAN_Y_TOL}), min y {pos[:, 1].min():.6f}; "
          f"|diff| per coordinate: median {np.median(d):.3e}, 99th "
          f"percentile {np.percentile(d, 99):.3e}, max {d.max():.3e} m "
          f"(axis {'xyz'[worst[1]]}, f32 y {ref[worst[0], 1]:.4f} m)",
          flush=True)
    if not dy <= BF16_MEAN_Y_TOL:
        raise AssertionError(f"phase M: mean y {dy} off the f32 run")
    ms = window_ms("phase M bf16 north star",
                   lambda n: eng.run(n, DT), 20)
    print(f"xpbd north star on the bf16 table: {ms:.3f} ms/step against "
          f"phase 3's {x_ms:.3f} on the f32 table", flush=True)

    # M3: a box LEDGE_GAP under the body (phase 5's): the collide stage's
    # bf16 instantiation; the body rests on the box within one bf16 ulp
    # (the push-out rounds to nearest, half an ulp) below its top
    top = float(topo.vertices[:, 1].min()) - LEDGE_GAP
    box = sbt.Colliders.build([sbt.Colliders.box(
        (0.0, top - 0.1, 0.0), (1.5, 0.1, 1.5))], device=device)
    reset_counts()
    ceng = sbt.Engine(topo, bf16, colliders=box, device=device)
    ceng.run(8, DT)
    ceng.step(DT)
    ceng.block()
    c_counts = read_counts()
    ceng.raise_on_timeouts()
    cpos = ceng.positions()
    free = ceng.state.inv_mass.cpu().numpy() != 0
    min_y = float(cpos[free, 1].min())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    print(f"phase M bf16 on the box: 9 steps, launches {c_counts}, free "
          f"min y {min_y:.6f} (box top {top:.6f}, one bf16 ulp {ulp})",
          flush=True)
    check_launched(c_counts, ("collide_bf16", "edge_sweep_bf16",
                              "tet_sweep_bf16"), "phase M box")
    if c_counts["collide"]:
        raise AssertionError("phase M box: the f32 collide kernel ran")
    if not np.isfinite(cpos).all() or not top - ulp <= min_y <= top + 1e-2:
        raise AssertionError(f"phase M box: the body is not resting on "
                             f"the box ({min_y} against {top})")
    return counts, c_counts, ms


def profile_module_path(sbt, topo, device, x_eng) -> dict:
    """Phase N: softbodysim_torch.perf at north-star shapes -- both stage
    profiles (CUDA events per stage), a trace of TRACE_STEPS north-star
    steps summed by kernel (its top entry the edge sweep) and the step
    rate; prints them and returns them."""
    import tempfile

    from softbodysim_torch import perf

    t0 = time.perf_counter()
    out = {
        "xpbd_stages": perf.profile_xpbd_stages(
            topo, sbt.SolverParams(dialect="xpbd", substeps=8,
                                   iterations=1),
            sbt.init_state(topo, device=device)),
        "jacobi_stages": perf.profile_jacobi_stages(
            topo, sbt.SolverParams(**JACOBI),
            sbt.init_state(topo, inv_mass_mode="density", device=device))}
    for key, stages in out.items():
        print(f"phase N {key} (tet_cube(47), ms per call): "
              f"{json.dumps(stages)}", flush=True)
        if not all(math.isfinite(v) and v > 0.0 for v in stages.values()):
            raise AssertionError(f"phase N: {key} {stages}")
    with tempfile.TemporaryDirectory() as log_dir:
        with perf.trace(log_dir):
            x_eng.run(TRACE_STEPS, DT)
        top = perf.trace_summary(log_dir, 8)
    print(f"phase N trace of {TRACE_STEPS} north-star steps, device us by "
          f"kernel: {[(round(us, 1), short_name(n)) for us, n in top]}",
          flush=True)
    if not top or "edge_sweep_kernel" not in top[0][1]:
        raise AssertionError(f"phase N: the trace's top entry is not the "
                             f"edge sweep: {top[:2]}")
    out["trace_top"] = [[us, short_name(n)] for us, n in top]
    out["step_rate"] = perf.step_rate(lambda e, dt: e.step(dt), x_eng, DT,
                                      steps=10)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase N step_rate (after the profiler ran): "
          f"{json.dumps(out['step_rate'])}; {out['seconds']:.1f} s",
          flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import softbodysim_torch as sbt
    from softbodysim_torch.kernels import _build
    from softbodysim_torch.kernels import sweep as ksw

    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build ({len(_build.SOURCES)} sources): "
          f"{time.perf_counter() - t0:.2f} s; nvcc says:", flush=True)
    for line in _build.build_log().splitlines():   # registers, smem, spills
        print("  " + line.strip(), flush=True)

    t0 = time.perf_counter()
    topo = sbt.meshes.tet_cube(**NORTH_STAR)
    print(f"north-star topology V={topo.num_particles} E={topo.num_edges} "
          f"T={topo.num_tets} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    # the main paths' timed windows first: once torch.profiler has run in
    # this process, the host's kernel launches are slower
    x_counts, x_ms, x_eng = xpbd_main_path(sbt, topo, device)
    print(f"xpbd north star (8 substeps, 1 iteration): {x_ms:.3f} ms/step, "
          f"{1e3 / x_ms:.2f} steps/s on {card}", flush=True)
    j_counts, j_ms, j_eng = jacobi_main_path(sbt, topo, device)
    print(f"jacobi tet_cube(47) (2 substeps, 6 iterations, floor box), "
          f"graphed: {j_ms:.3f} ms/step, {1e3 / j_ms:.2f} steps/s on {card}",
          flush=True)
    je_ms = jacobi_eager_ms(j_eng, 20)
    print(f"jacobi tet_cube(47), eager (diagnostic): {je_ms:.3f} ms/step "
          f"on {card}", flush=True)
    jo_ms = jacobi_override_ms(j_eng, 20)
    print(f"jacobi tet_cube(47), graphed, one step per call with overrides "
          f"(diagnostic): {jo_ms:.3f} ms/step on {card}", flush=True)
    v_counts = jacobi_variant_paths(sbt, topo, device)
    b_ms, b_eng = jacobi_ball_path(sbt, device)
    print(f"jacobi tet_ball(6, 0.3) (2 substeps, 6 iterations, floor box), "
          f"graphed: {b_ms:.3f} ms/step, {1e3 / b_ms:.2f} steps/s on {card}",
          flush=True)
    l_counts, l_ms, l_eng = legacy_main_path(sbt, topo, device)
    print(f"xpbd legacy 128-wide tet_cube(47) (8 substeps, 1 iteration, "
          f"box): {l_ms:.3f} ms/step, {1e3 / l_ms:.2f} steps/s on {card}",
          flush=True)
    ksw.raise_on_timeouts()
    xpbd_reference_check(sbt, device, superblocks=True)
    xpbd_reference_check(sbt, device, superblocks=False)
    xpbd_collider_check(sbt, device)
    c_ms, c_eng = coloured_checks(sbt, device)
    print(f"xpbd coloured SampleScene body (2 substeps, 6 iterations, box):"
          f" {c_ms:.3f} ms/step on {card}", flush=True)
    co_ms, co_graphs = coloured_override_ms(c_eng, 2)
    print(f"xpbd coloured SampleScene body, compliance changing every step "
          f"(diagnostic): {co_ms:.3f} ms/step, {co_graphs} graphs captured "
          f"on {card}", flush=True)
    sample_scene(sbt, device)
    jacobi_reference_check(sbt, device)

    # the scene paths, timed before any profiler runs
    tails = convergence_at_scale(sbt, topo, device)
    p_ms, p_plan, programs = partitioned_path(sbt, device)
    bt_ms, bt_eng = batch_test_path(sbt, device)
    bd_ms, bd_proj, bd_eng = batched_path(sbt, device)
    dynamic_path(sbt, device)
    sample_world_path(sbt, device)
    ksw.raise_on_timeouts()
    print(json.dumps({"scenes": {
        "convergence_tails": tails,
        "partitioned_mixed_dialect_ms_per_step": p_ms,
        "partitioned_host_plan_s": p_plan,
        "batch_test_merged_ms_per_step": bt_ms,
        "batched_128x_jacobi_ms_per_step": bd_ms,
        "batched_128x_jacobi_proj_per_sec": bd_proj, "card": card}}),
        flush=True)
    # contact and the mesh pipeline, timed before any profiler runs
    contact = contact_path(sbt, device)
    contact["mesh_pipeline"] = mesh_pipeline_path(sbt, device)
    contact["card"] = card
    print(json.dumps({"contact": contact}), flush=True)
    # serving, the CLI and the render layer, timed before any profiler runs
    t0 = time.perf_counter()
    serving = serving_path(sbt, topo, device, x_ms)
    serving.update(cli_and_render_path(sbt, topo, device,
                                       x_eng.positions()))
    serving["seconds"] = time.perf_counter() - t0
    serving["card"] = card
    print(json.dumps({"serving": serving}), flush=True)
    # differentiable simulation, before any profiler runs
    t0 = time.perf_counter()
    grads = {"xpbd": diff_xpbd_path(sbt, topo, device),
             "jacobi": diff_jacobi_path(sbt, topo, device),
             "collide_function": collide_function_check(sbt, topo, device)}
    refusal_check(sbt, (("xpbd north star", x_eng),
                        ("jacobi tet_cube(47)", j_eng),
                        ("xpbd legacy 128-wide", l_eng)))
    grads["card_vs_cpu"] = diff_card_vs_cpu(sbt, device)
    grads["seconds"] = time.perf_counter() - t0
    grads["card"] = card
    print(json.dumps({"diff": grads}), flush=True)
    # the kernel-sharded steps, timed before any profiler runs
    sh_counts, sharded = sharded_path(sbt, topo, device, card)
    print(json.dumps({"sharded": sharded}), flush=True)
    # the vertex-sharded, data- and constraint-parallel modes, before any
    # profiler runs
    _, modes = modes_path(sbt, topo, device, card)
    print(json.dumps({"modes": modes}), flush=True)
    # the entry hooks and the examples, before any profiler runs
    print(json.dumps({"hooks": hooks_path(device, card)}), flush=True)
    # the bf16 particle table, before any profiler runs
    t0 = time.perf_counter()
    m_rows, m_calls = compare_bf16_kernels(sbt, ksw, topo, device)
    m_counts, mc_counts, m_ms = bf16_main_path(sbt, topo, device, x_ms)
    print(json.dumps({"bf16": {
        "north_star_ms_per_step": m_ms, "f32_ms_per_step": x_ms,
        "max_abs_err_vs_plain": {k: r[0] for k, r in m_rows.items()},
        "seconds": time.perf_counter() - t0, "card": card}}), flush=True)

    kres = compare_sweep_kernels(sbt, ksw, topo, device)
    kres.update(compare_legacy_kernels(sbt, ksw, topo, device))
    kres.update(time_bf16_kernels(m_rows, m_calls))
    for name in ("w_fill", "edge_sweep", "tet_sweep", "legacy_edge_sweep",
                 "legacy_tet_sweep"):
        report(name, kres[name])
    kres.update(compare_jacobi_kernels(sbt, topo, device))
    for label, eng, steps, ms in (("xpbd north star", x_eng, 4, x_ms),
                                  ("jacobi tet_cube(47)", j_eng, 20, j_ms),
                                  ("jacobi tet_ball(6)", b_eng, 20, b_ms),
                                  ("xpbd legacy 128-wide", l_eng, 2, l_ms),
                                  ("xpbd coloured SampleScene", c_eng, 1,
                                   c_ms),
                                  *((label, e, 8, ms)
                                    for label, e, ms in programs),
                                  ("BatchTest merged", bt_eng, 64, bt_ms),
                                  ("batched_128x_jacobi", bd_eng, 2,
                                   bd_ms)):
        t0 = time.perf_counter()
        prof = profile_window(eng, steps, ms)
        print(json.dumps({"profile": label, **prof}), flush=True)
        print(f"profile of {label}: {time.perf_counter() - t0:.2f} s",
              flush=True)
        # the profiler names the kernels inside the graph replays
        for kern in ("tile_pass_kernel<2, false, false>",
                     "tile_pass_kernel<4, true, false>"):
            if eng is j_eng and kern not in prof["device"]:
                raise AssertionError(f"the jacobi profile names no {kern}")
    diff_profile(sbt, topo, device, grads)
    print(json.dumps({"profile_module": profile_module_path(
        sbt, topo, device, x_eng), "card": card}), flush=True)

    ksw.raise_on_timeouts()
    src = "softbodysim_torch/kernels/csrc/"
    rows = (
        ("w_fill", "sweep.cu", "softbodysim_tpu/kernels/sweep.py:1118",
         x_counts),
        ("edge_sweep", "sweep.cu", "softbodysim_tpu/kernels/sweep.py:1169",
         x_counts),
        ("tet_sweep", "sweep.cu", "softbodysim_tpu/kernels/sweep.py:1267",
         x_counts),
        ("jacobi_edge_pass", "jacobi.cu",
         "softbodysim_tpu/kernels/jacobi.py:71", j_counts),
        ("jacobi_tet_pass", "jacobi.cu",
         "softbodysim_tpu/kernels/jacobi.py:158", v_counts),
        # the passes with the collide stage (collide.py:136) fused
        ("jacobi_edge_pass_collide", "jacobi.cu",
         "softbodysim_tpu/kernels/collide.py:136", v_counts),
        ("jacobi_tet_pass_collide", "jacobi.cu",
         "softbodysim_tpu/kernels/collide.py:136", j_counts),
        # the stand-alone stage: the xpbd paths, jacobi gather / segment
        ("collide", "collide.cu", "softbodysim_tpu/kernels/collide.py:136",
         l_counts),
        ("legacy_edge_sweep", "sweep.cu",
         "softbodysim_tpu/kernels/sweep.py:825", l_counts),
        ("legacy_tet_sweep", "sweep.cu",
         "softbodysim_tpu/kernels/sweep.py:894", l_counts),
        # the passes' accumulate-only mode (make_jacobi_pass apply=False)
        ("jacobi_edge_accumulate", "jacobi.cu",
         "softbodysim_tpu/kernels/jacobi.py:71", sh_counts),
        ("jacobi_tet_accumulate", "jacobi.cu",
         "softbodysim_tpu/kernels/jacobi.py:158", sh_counts),
        # the bf16 particle table (make_sweep x_dtype=bfloat16)
        ("w_fill_bf16", "sweep.cu",
         "softbodysim_tpu/kernels/sweep.py:1118 (x_dtype=bfloat16)",
         m_counts),
        ("edge_sweep_bf16", "sweep.cu",
         "softbodysim_tpu/kernels/sweep.py:1169 (x_dtype=bfloat16)",
         m_counts),
        ("tet_sweep_bf16", "sweep.cu",
         "softbodysim_tpu/kernels/sweep.py:1267 (x_dtype=bfloat16)",
         m_counts),
        # the xpbd collide stage on the bf16 table (xpbd_pallas.py:652)
        ("collide_bf16", "collide.cu",
         "softbodysim_tpu/kernels/collide.py:136 (bf16 table)", mc_counts))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + cu,
         "replaces": replaces, "launches": counts[name], **kres[name]}
        for name, cu, replaces, counts in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
