"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero exit:

1. Require a CUDA device; print the card's name and power limit.
2. Build the CUDA sweep kernels from softbodysim_torch/kernels/csrc/sweep.cu
   (nvcc) and print the build time and each kernel's resources.
3. At north-star plan shapes (tet_cube(47): V = 110,592, E = 642,960,
   T = 519,115), compare each kernel with its plain PyTorch version on the
   card from one predicted, perturbed state, and time both.
4. Drive the main path: Engine(tet_cube(47), xpbd, 8 substeps,
   1 iteration, device="cuda") with xpbd_backend="auto" -> the sweep
   backend; run(32) then step(); check the positions and that every
   kernel was launched; then time a warm window.
5. Reference check on a small input: the same Engine on the card against
   the NumPy block-synchronous oracle (tests/oracle.py), 10 steps.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DT = 1.0 / 60.0
NORTH_STAR = dict(nx=47, ny=47, nz=47, size=1.0, center=(0.0, 2.0, 0.0))
SEED = 0

# Tolerances, kernel vs plain PyTorch version on the same inputs:
# - w_fill: the same two IEEE products and one sum per value (no FMA on
#   either side): 1 ulp of the largest value.
# - sweeps: the kernel sums each vertex's corrections in the plan's CSR
#   order, the plain version with index_add_ (atomics, run-to-run order);
#   fp32 reassociation moves a position by a few ulp (~2.4e-7 m at |x| ~ 2 m)
#   per block touching it, and later blocks read those positions.  Positions
#   within 1e-4 m (~0.5% of an edge's rest length 0.0213 m); lambdas
#   within 1e-3 of the largest |lambda| of the sweep.
X_TOL = 1e-4
LAM_REL_TOL = 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), after
    one warm-up call."""
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


def compare_kernels(sbt, ksw, topo, device) -> dict:
    """Phase 3: each kernel against its plain version, same inputs."""
    from softbodysim_torch.solver.xpbd_sweep import SweepStep

    params = sbt.SolverParams(dialect="xpbd", substeps=8, iterations=1)
    t0 = time.perf_counter()
    step = SweepStep(topo, params, device=device)
    print(f"host plans: {time.perf_counter() - t0:.2f} s "
          f"(edge blocks {step.gpu_plans['edges'].num_blocks}, "
          f"tet blocks {step.gpu_plans['tets'].num_blocks})", flush=True)
    ep, tp = step.device_plans["edges"], step.device_plans["tets"]
    carry = step.pack_state(sbt.init_state(topo, device=device))
    xw = carry.xw
    # a predicted, perturbed state: one substep of free fall plus noise
    sdt = np.float32(DT) / np.float32(8)
    rng = np.random.default_rng(SEED)
    noise = rng.normal(0.0, 1e-3, (xw.shape[0], 3)).astype(np.float32)
    free = (xw[:, 3:4] != 0).float()
    xw[:, 1] -= float(np.float32(9.81) * sdt * sdt) * free[:, 0]
    xw[:, :3] += torch.as_tensor(noise, device=device) * free
    alphas = {"edges": float(np.float32(params.edge_compliance)
                             / (sdt * sdt)),
              "tets": 0.0}
    ks = step.block_scheme["local_iters"]
    res = {}

    # w_fill (both families)
    err, ms, plain_ms = 0.0, 0.0, 0.0
    for plan in (ep, tp):
        wk = ksw.w_fill(plan, xw)
        wp = ksw.w_fill_plain(plan, xw)
        torch.cuda.synchronize()
        e = (wk - wp).abs().max().item()
        bound = float(np.finfo(np.float32).eps) * wp.abs().max().item()
        if not e <= bound:
            raise AssertionError(f"w_fill disagrees: {e} > {bound}")
        err = max(err, e)
        ms += cuda_ms(lambda: ksw.w_fill(plan, xw), 20)
        plain_ms += cuda_ms(lambda: ksw.w_fill_plain(plan, xw), 20)
    res["w_fill"] = (err, ms, plain_ms)
    w_e = ksw.w_fill_plain(ep, xw)
    w_t = ksw.w_fill_plain(tp, xw)

    for name, plan, wtab, k, fn, plain in (
            ("edge_sweep", ep, w_e, ks[0], ksw.edge_sweep,
             ksw.edge_sweep_plain),
            ("tet_sweep", tp, w_t, ks[1], ksw.tet_sweep,
             ksw.tet_sweep_plain)):
        fam = "edges" if plan is ep else "tets"
        lam0 = torch.zeros(plan.num_blocks * 1024, device=device)
        xa, la = xw.clone(), lam0.clone()
        xb, lb = xw.clone(), lam0.clone()
        fn(plan, xa, la, wtab, alphas[fam], k)
        plain(plan, xb, lb, wtab, alphas[fam], k)
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
        ms = cuda_ms(lambda: fn(plan, xa, la, wtab, alphas[fam], k), 10)
        plain_ms = cuda_ms(
            lambda: plain(plan, xb, lb, wtab, alphas[fam], k), 2)
        res[name] = (max(ex, el), ms, plain_ms)
    return res


def main_path(sbt, ksw, topo, device) -> tuple:
    """Phase 4: the Engine on the card; returns (launch counts, ms/step)."""
    params = sbt.SolverParams(dialect="xpbd", substeps=8, iterations=1)
    ksw.reset_launch_counts()
    t0 = time.perf_counter()
    eng = sbt.Engine(topo, params, device=device)
    if eng.backend != "sweep":
        raise AssertionError(f"backend {eng.backend!r}, expected 'sweep'")
    eng.run(32, DT)
    eng.step(DT)
    eng.block()
    counts = ksw.launch_counts()
    pos = eng.positions()
    print(f"main path: backend={eng.backend}, 33 steps in "
          f"{time.perf_counter() - t0:.2f} s (incl. set-up), launches "
          f"{counts}", flush=True)
    if pos.shape != (topo.num_particles, 3):
        raise AssertionError(f"positions shape {pos.shape}")
    if not np.isfinite(pos).all():
        raise AssertionError("non-finite positions after 33 steps")
    if not pos[:, 1].min() >= -1e-4:
        raise AssertionError(f"min y {pos[:, 1].min()} below the ground")
    if not all(n > 0 for n in counts.values()):
        raise AssertionError(f"a kernel was not launched: {counts}")
    drop = float(topo.vertices[:, 1].mean() - pos[:, 1].mean())
    print(f"positions finite, min y {pos[:, 1].min():.6f}, mean drop "
          f"{drop:.6f} m", flush=True)
    if not drop > 0.0:
        raise AssertionError("the body did not fall")

    n = 20
    t0 = time.perf_counter()
    eng.run(n, DT)
    eng.block()
    ms_step = (time.perf_counter() - t0) * 1e3 / n
    return counts, ms_step


def reference_check(sbt, device) -> float:
    """Phase 5: small scene on the card vs the NumPy block oracle."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracle import XpbdOracle

    topo = sbt.meshes.tet_cube(4, 4, 4, size=0.5, center=(0.0, 0.6, 0.0))
    params = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=4,
                              xpbd_backend="sweep")
    eng = sbt.Engine(topo, params, device=device)
    step = eng._raw_step

    def blocks(plan):
        rows = plan.perm.reshape(-1, 1024)
        scl = plan.scale.reshape(-1, 1024)
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
    print(f"reference check (tet_cube(4), 10 steps vs block oracle): max "
          f"abs err {err:.3e} (tol 1e-4)", flush=True)
    if not err <= 1e-4:
        raise AssertionError(f"port disagrees with the oracle ({err})")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
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
    print(f"kernel build: {time.perf_counter() - t0:.2f} s; nvcc says:",
          flush=True)
    for line in _build.build_log().splitlines():   # registers, smem, spills
        print("  " + line.strip(), flush=True)

    t0 = time.perf_counter()
    topo = sbt.meshes.tet_cube(**NORTH_STAR)
    print(f"north-star topology V={topo.num_particles} E={topo.num_edges} "
          f"T={topo.num_tets} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    kres = compare_kernels(sbt, ksw, topo, device)
    counts, ms_step = main_path(sbt, ksw, topo, device)
    print(f"north star (8 substeps, 1 iteration): {ms_step:.3f} ms/step, "
          f"{1e3 / ms_step:.2f} steps/s on {card}", flush=True)
    reference_check(sbt, device)

    src = "softbodysim_torch/kernels/csrc/sweep.cu"
    replaces = {"w_fill": "softbodysim_tpu/kernels/sweep.py:1118",
                "edge_sweep": "softbodysim_tpu/kernels/sweep.py:1169",
                "tet_sweep": "softbodysim_tpu/kernels/sweep.py:1267"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": replaces[name], "launches": counts[name],
         "max_abs_err": kres[name][0], "ms": kres[name][1],
         "plain_ms": kres[name][2]}
        for name in ("w_fill", "edge_sweep", "tet_sweep")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
