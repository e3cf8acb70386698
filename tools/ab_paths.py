"""Time the port's step paths of two checkouts in turns on one NVIDIA GPU.

    python3 tools/ab_paths.py OTHER_CHECKOUT [ROUNDS]

Runs this checkout ("change") and OTHER_CHECKOUT ("parent", e.g. a
``git archive`` of the parent commit unpacked under ``_ab/``) in the order
parent, change, change, parent, ROUNDS times (default 1), each in a fresh
process that imports that checkout's ``softbodysim_torch``.  Each process
times, with contact off, the paths ``chip_smoke.py`` times that the
contact stages pass through: the xpbd north star on the sweep kernels
(tet_cube(47), 8 x 1; 20-step windows), the jacobi dialect on the same
cube on the pass kernels (2 x 6, floor box; 20-step windows), the jacobi
'gather' step on tet_ball(2, 0.3) over the floor box (20-step windows),
the jacobi 'segment' step on the cube (10-step windows) and on the ball
(20-step windows),
the coloured xpbd step on the same ball (2-step windows) and the batched
jacobi step (tet_cube(10) x 128, 'gather'; 10-step windows): the median
of three windows after warm steps, host clock ending in a synchronize.
Prints one JSON line per process, beside the card's name and power
limit, and the per-path medians over each side's runs.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 1.0 / 60.0
JACOBI = dict(dialect="jacobi", substeps=2, iterations=6,
              edge_stiffness=0.9, volume_stiffness=0.98, sor_omega=1.4,
              particle_radius=0.02, gravity=(0.0, -10.0, 0.0))


def _window_ms(step, sync, steps: int) -> float:
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(steps)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3 / steps)
    return sorted(ms)[1]


def measure(dev="cuda") -> dict:
    """The paths' ms/step in this process (its sys.path names the tree)."""
    import torch

    import softbodysim_torch as sbt
    from softbodysim_torch.parallel import BatchedEngine

    dev = torch.device(dev)
    box = sbt.Colliders.build(
        [sbt.Colliders.box((0.0, 0.1, 0.0), (1.5, 0.1, 1.5))], device=dev)
    cube = sbt.meshes.tet_cube(47, 47, 47, size=1.0, center=(0.0, 2.0, 0.0))
    ball = sbt.meshes.tet_ball(2, 0.3, center=(0.0, 1.0, 0.0))
    engines = {
        "xpbd_north_star": (sbt.Engine(cube, sbt.SolverParams(
            substeps=8, iterations=1), device=dev), 20, 32),
        "jacobi_tet_cube47_pass": (sbt.Engine(
            cube, sbt.SolverParams(**JACOBI), colliders=box, device=dev),
            20, 32),
        "jacobi_ball_gather": (sbt.Engine(
            ball, sbt.SolverParams(**JACOBI), colliders=box, device=dev),
            20, 32),
        "jacobi_tet_cube47_segment": (sbt.Engine(
            cube, sbt.SolverParams(**JACOBI, jacobi_backend="segment"),
            colliders=box, device=dev), 10, 8),
        "jacobi_ball_segment": (sbt.Engine(
            ball, sbt.SolverParams(**JACOBI, jacobi_backend="segment"),
            colliders=box, device=dev), 20, 32),
        "xpbd_ball_coloured": (sbt.Engine(ball, sbt.SolverParams(
            substeps=2, iterations=6), colliders=box, device=dev), 2, 4),
    }
    out = {}
    for name, (eng, steps, warm) in engines.items():
        eng.run(warm, DT).block()
        out[name] = _window_ms(lambda n, e=eng: e.run(n, DT),
                               lambda e=eng: e.block(), steps)
        out[name + "_backend"] = eng.backend
    batch = BatchedEngine(sbt.meshes.tet_cube(10, 10, 10, 0.8, (0, 1, 0)),
                          sbt.SolverParams(**{**JACOBI,
                                              "jacobi_backend": "gather"}),
                          128, device=dev)
    for _ in range(4):
        batch.step(DT)

    def run_batch(n):
        for _ in range(n):
            batch.step(DT)

    out["batched_128x_jacobi"] = _window_ms(run_batch, batch.block, 10)
    return out


def main(argv) -> int:
    if len(argv) >= 2 and argv[1] == "--measure":
        sys.path.insert(0, argv[2])
        print(json.dumps(measure()), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    card = chip_smoke.card_line()
    print(card, flush=True)
    other = os.path.abspath(argv[1])
    rounds = int(argv[2]) if len(argv) > 2 else 1
    runs = {"parent": [], "change": []}
    for _ in range(rounds):
        for side in ("parent", "change", "change", "parent"):
            tree = other if side == "parent" else ROOT
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--measure",
                 tree], cwd=tree, capture_output=True, text=True,
                timeout=900)
            if res.returncode != 0:
                print(res.stdout, res.stderr, file=sys.stderr)
                raise RuntimeError(f"{side} run failed")
            row = json.loads(res.stdout.strip().splitlines()[-1])
            runs[side].append(row)
            print(json.dumps({"side": side, **row, "card": card}),
                  flush=True)
    keys = [k for k in runs["change"][0] if not k.endswith("_backend")]
    print(json.dumps({"median_ms_per_step": {
        side: {k: statistics.median(r[k] for r in rows) for k in keys}
        for side, rows in runs.items()},
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
