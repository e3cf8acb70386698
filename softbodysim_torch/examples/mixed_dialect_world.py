"""Mixed-DIALECT world via partitioned execution: jacobi and xpbd bodies
in one scene, run as the fewest merged programs.

The reference's manager steps every body separately
(SoftBodyManager.cs:217-233); a world mixing the in-engine Jacobi+SOR
dialect with the C++ server's XPBD dialect cannot merge into one sim
mesh (the solvers differ).  ``Scene.build_partitioned`` groups bodies by
merge-compatibility, so this world becomes exactly TWO merged programs.

    python -m softbodysim_torch.examples.mixed_dialect_world [--steps 120] \
        [--device cuda]
"""

import argparse

import numpy as np

from softbodysim_torch import Colliders, Scene, SolverParams
from softbodysim_torch.core import meshes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    jac = SolverParams(dialect="jacobi", substeps=2, iterations=6,
                       edge_stiffness=0.9, volume_stiffness=0.98,
                       sor_omega=1.4, gravity=(0.0, -10.0, 0.0))
    xp = SolverParams(dialect="xpbd", substeps=2, iterations=6,
                      gravity=(0.0, -10.0, 0.0))

    bodies = []
    for i in range(3):                     # three unique jacobi bodies
        t = meshes.tet_cube(4 + i, 4, 4, size=0.5,
                            center=(i * 1.2 - 1.2, 1.0, -0.8))
        # per-body stiffness still merges (per-constraint tables)
        p = jac.replace(edge_stiffness=0.5 + 0.2 * i)
        bodies.append((f"jacobi{i}", t, p, {}))
    for i in range(3):                     # three unique xpbd bodies
        t = meshes.tet_cube(4, 4 + i, 4, size=0.5,
                            center=(i * 1.2 - 1.2, 1.0, 0.8))
        bodies.append((f"xpbd{i}", t, xp, {}))

    scene = Scene(name="mixed_dialect", colliders=[
        Colliders.sphere((0.0, 0.25, 0.0), 0.3)], bodies=bodies)
    world = scene.build_partitioned(backend="gather", device=args.device)
    print(f"{len(bodies)} bodies -> {world.num_programs} programs")

    world.run(args.steps, 1.0 / 60.0)
    out = world.positions()
    for name, pos in out.items():
        print(f"  {name}: min_y={pos[:, 1].min():.3f} "
              f"finite={np.isfinite(pos).all()}")
    return world.num_programs, out


if __name__ == "__main__":
    main()
