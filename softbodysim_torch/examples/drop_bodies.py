"""Multi-body drop scene -- the SampleScene/ExtremeTest analog.

Drops a mix of balls and cubes onto a box collider and the ground, and
exports an OBJ sequence with normals for viewing.

    python -m softbodysim_torch.examples.drop_bodies --bodies 6 \
        --steps 120 --out /tmp/drop [--device cuda]
"""

import argparse

import numpy as np

import softbodysim_torch as sbt
from softbodysim_torch.io import ObjSequenceWriter
from softbodysim_torch.render import make_normals_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bodies", type=int, default=4)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    world = sbt.World(fixed_dt=1 / 60, device=args.device)
    world.add_collider(sbt.Colliders.box((0.0, 0.15, 0.0), (0.4, 0.15, 0.4)))

    rng = np.random.default_rng(0)
    for i in range(args.bodies):
        x = float(rng.uniform(-0.5, 0.5))
        z = float(rng.uniform(-0.5, 0.5))
        y = 1.0 + 0.4 * i
        if i % 2 == 0:
            topo = sbt.meshes.tet_ball(1, 0.2, (x, y, z))
        else:
            topo = sbt.meshes.tet_cube(2, 2, 2, 0.3, (x, y, z))
        world.register(sbt.Body(
            topo,
            sbt.SolverParams(dialect="jacobi", substeps=2, iterations=6,
                             gravity=(0, -10.0, 0)),
            name=f"body{i}"))

    writers = {}
    normals = {}
    if args.out:
        for b in world.bodies:
            writers[b.name] = ObjSequenceWriter(
                f"{args.out}/{b.name}", triangles=b.topology.surface_tris)
            normals[b.name] = make_normals_fn(b.topology, device=args.device)

    for s in range(args.steps):
        world.step()
        if args.out and s % 4 == 0:
            for b in world.bodies:
                pos = b.engine.positions_device()
                writers[b.name].append(pos.cpu().numpy(),
                                       normals[b.name](pos).cpu().numpy())

    print(world.stats.report())
    out = world.positions()
    for name, pos in out.items():
        print(f"{name}: min_y={pos[:, 1].min():.4f}")
    return out


if __name__ == "__main__":
    main()
