"""Checkpoint / resume: run, save mid-flight (the accumulated XPBD lambdas
too), resume in a fresh Engine, and compare with the uninterrupted run.

    python -m softbodysim_torch.examples.checkpoint_resume [--steps 100] \
        [--device cuda]
"""

import argparse
import os
import tempfile

import numpy as np

import softbodysim_torch as sbt
from softbodysim_torch.io import load_state, params_from_metadata, save_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100,
                    help="the uninterrupted run's steps; the checkpoint is "
                         "taken half way")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    half = args.steps // 2

    topo = sbt.meshes.tet_ball(1, 0.3, (0.0, 1.0, 0.0))
    params = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=6)

    ref = sbt.Engine(topo, params, device=args.device)
    for _ in range(2 * half):
        ref.step(1 / 60)

    eng = sbt.Engine(topo, params, device=args.device)
    for _ in range(half):
        eng.step(1 / 60)

    path = os.path.join(tempfile.gettempdir(), "softbody_ckpt.npz")
    save_state(path, eng.state, params=params, metadata={"step": half})
    print("saved", path)

    resumed = sbt.Engine(topo, params, device=args.device)
    resumed.state, meta = load_state(path, device=args.device)
    print("resumed at step", meta["step"],
          "with params", params_from_metadata(meta).dialect)
    for _ in range(half):
        resumed.step(1 / 60)

    diff = float(np.abs(ref.positions() - resumed.positions()).max())
    print(f"max position diff vs uninterrupted run: {diff:.3e} "
          f"({'bit-exact' if diff == 0 else 'NOT exact'})")
    return diff


if __name__ == "__main__":
    main()
