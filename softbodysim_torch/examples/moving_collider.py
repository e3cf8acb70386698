"""Kinematic collider: a capsule sweeps through a row of soft balls.

The collider's pose is updated every step with no rebuild (the per-step
snapshot semantics of the reference manager); at the end no particle lies
inside the capsule.

    python -m softbodysim_torch.examples.moving_collider --steps 240 \
        --out /tmp/sweep [--device cuda]
"""

import argparse

import numpy as np

import softbodysim_torch as sbt
from softbodysim_torch.io import ObjSequenceWriter

RADIUS, HALF_HEIGHT, Y = 0.25, 0.4, 0.3


def inside_capsule(pos: np.ndarray, cx: float) -> int:
    """Particles closer than the radius to the upright capsule's axis
    segment at x = cx."""
    seg_y = np.clip(pos[:, 1], Y - HALF_HEIGHT, Y + HALF_HEIGHT)
    d = np.sqrt((pos[:, 0] - cx) ** 2 + (pos[:, 1] - seg_y) ** 2
                + pos[:, 2] ** 2)
    return int((d < RADIUS).sum())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    world = sbt.World(fixed_dt=1 / 60, device=args.device)
    cid = world.add_collider(sbt.Colliders.capsule((-2.0, Y, 0.0),
                                                   RADIUS, HALF_HEIGHT))
    for i in range(4):
        world.register(sbt.Body(
            sbt.meshes.tet_ball(1, 0.18, (0.35 * i - 0.5, 0.2, 0.0)),
            sbt.SolverParams(dialect="jacobi", substeps=2, iterations=6,
                             gravity=(0, -10.0, 0), particle_radius=0.02),
            name=f"ball{i}"))

    writers = {}
    if args.out:
        for b in world.bodies:
            writers[b.name] = ObjSequenceWriter(
                f"{args.out}/{b.name}", triangles=b.topology.surface_tris)

    cx = -2.0
    for s in range(args.steps):
        cx = -2.0 + 4.0 * s / args.steps
        world.update_collider(
            cid, sbt.Colliders.capsule((cx, Y, 0.0), RADIUS, HALF_HEIGHT))
        world.step()
        if args.out and s % 4 == 0:
            for b in world.bodies:
                writers[b.name].append(b.positions())

    out = world.positions()
    for name, pos in out.items():
        c = pos.mean(axis=0)
        print(f"{name}: center=({c[0]:+.3f}, {c[1]:+.3f}, {c[2]:+.3f})")
    inside = sum(inside_capsule(p, cx) for p in out.values())
    print(f"particles inside the capsule at x={cx:+.3f}: {inside}")
    assert inside == 0
    return out


if __name__ == "__main__":
    main()
