"""How far the bf16 particle table's trajectories spread through ground
contact, on the CPU.

    python tools/bf16_contact_spread.py [N] [STEPS] [--jax]

tet_cube(N) (size 1 m, centre 0.7 m; default N = 8) falls onto the ground
on the port's sweep step at 8 substeps x 1 iteration (the kernels' plain
versions, ``device="cpu"``).  Every 5 of STEPS (default 30) steps it
prints the largest coordinate distance between an f32 run and one
started one f32 ulp off in x, the same for two bf16 runs
(``xpbd_x_dtype="bfloat16"``), between bf16 and f32, and the mean
heights.  With ``--jax`` it also steps the JAX package's bf16 Pallas step
(interpret mode) from the same start and prints its distance from the
port's bf16 run and its mean height: the reference for the mode itself.
Host-clock CPU runs; no device metric.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import softbodysim_torch as sbt  # noqa: E402

DT = 1.0 / 60.0


def _engine(topo, params, dtype, ulp):
    eng = sbt.Engine(topo, params.replace(xpbd_x_dtype=dtype), device="cpu")
    if ulp:
        s = eng.state
        x = s.x.clone()
        x[:, 0] = torch.nextafter(x[:, 0], torch.full_like(x[:, 0], 10.0))
        eng.state = dataclasses.replace(s, x=x, x_star=x)
    return eng


def _jax_step(n):
    """The JAX bf16 step's positions after each call, from rest."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from softbodysim_tpu import SolverParams
    from softbodysim_tpu.core import meshes
    from softbodysim_tpu.core.state import init_state
    from softbodysim_tpu.solver.xpbd_pallas import make_xpbd_pallas_step

    topo = meshes.tet_cube(n, n, n, size=1.0, center=(0.0, 0.7, 0.0))
    step = make_xpbd_pallas_step(topo, SolverParams(
        dialect="xpbd", substeps=8, iterations=1, xpbd_x_dtype="bfloat16"),
        interpret=True)
    state = init_state(topo)
    while True:
        state = step(state, DT)
        yield np.asarray(state.x)


def main(argv) -> int:
    use_jax = "--jax" in argv
    args = [a for a in argv[1:] if a != "--jax"]
    n = int(args[0]) if args else 8
    steps = int(args[1]) if len(args) > 1 else 30
    topo = sbt.meshes.tet_cube(n, n, n, size=1.0, center=(0.0, 0.7, 0.0))
    params = sbt.SolverParams(dialect="xpbd", substeps=8, iterations=1,
                              xpbd_backend="sweep")
    runs = {(d, u): _engine(topo, params, d, u)
            for d in ("float32", "bfloat16") for u in (False, True)}
    ref = _jax_step(n) if use_jax else None
    for k in range(1, steps + 1):
        for eng in runs.values():
            eng.step(DT)
        j = next(ref) if ref is not None else None
        if k % 5 and k != steps:
            continue
        x = {key: eng.positions() for key, eng in runs.items()}
        f, b = x[("float32", False)], x[("bfloat16", False)]
        row = {"step": k,
               "f32_vs_f32_ulp": float(np.abs(f - x[("float32", True)])
                                       .max()),
               "bf16_vs_bf16_ulp": float(np.abs(b - x[("bfloat16", True)])
                                         .max()),
               "bf16_vs_f32": float(np.abs(b - f).max()),
               "mean_y_f32": float(f[:, 1].mean()),
               "mean_y_bf16": float(b[:, 1].mean())}
        if j is not None:
            row["bf16_vs_jax_bf16"] = float(np.abs(b - j).max())
            row["mean_y_jax_bf16"] = float(j[:, 1].mean())
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
