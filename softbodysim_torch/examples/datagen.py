"""Batched datagen: 4096 scenes with randomized stiffness stepped as one
(BASELINE config #5) -- RL-rollout style trajectory generation.

    python -m softbodysim_torch.examples.datagen --batch 4096 --steps 60 \
        --out /tmp/roll.npz [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

import softbodysim_torch as sbt
from softbodysim_torch.parallel import BatchedEngine, sample_stiffness


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--subdiv", type=int, default=1)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    topo = sbt.meshes.tet_ball(args.subdiv, 0.3, (0.0, 0.8, 0.0))
    params = sbt.SolverParams(dialect="jacobi", substeps=2, iterations=6,
                              gravity=(0, -10.0, 0))

    gen = torch.Generator().manual_seed(0)
    ks = sample_stiffness(gen, args.batch, 0.3, 1.0, device=args.device)
    kv = sample_stiffness(gen, args.batch, 0.8, 1.0, device=args.device)

    eng = BatchedEngine(topo, params, batch=args.batch,
                        randomized_stiffness=True, key=gen, pos_jitter=0.01,
                        device=args.device)

    frames = []
    eng.step(1 / 60, ks, kv)  # warm-up: the first step builds its tables
    eng.block()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.step(1 / 60, ks, kv)
        if args.out:
            frames.append(eng.positions())
    eng.block()
    dt = time.perf_counter() - t0

    cons = topo.num_edges + topo.num_tets
    rate = args.batch * cons * 12 * args.steps / dt
    scene_steps = args.batch * args.steps / dt
    print(f"{args.batch} scenes x {args.steps} steps in {dt:.2f}s "
          f"({scene_steps:.0f} scene-steps/s, "
          f"{rate:.3g} constraint projections/s)")

    if args.out:
        np.savez_compressed(args.out,
                            positions=np.stack(frames, 1),
                            edge_stiffness=ks.cpu().numpy(),
                            volume_stiffness=kv.cpu().numpy())
        print("wrote", args.out)
    return {"seconds": dt, "scene_steps_per_s": scene_steps,
            "projections_per_s": rate, "positions": eng.positions()}


if __name__ == "__main__":
    main()
