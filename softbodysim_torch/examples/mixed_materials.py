"""Mixed-material merged scene: bodies with different stiffness in ONE
sim mesh stepped by the Jacobi pass kernels.

The reference sets material tunables per SoftBodySolver component
(SoftBodySolver.cs inspector fields); here each body's stiffness merges
into per-constraint tables (``edge_k`` / ``tet_k``), so the whole scene
still runs as a single merged program.

    python -m softbodysim_torch.examples.mixed_materials [--steps 120] \
        [--device cuda]
"""

import argparse

import numpy as np

from softbodysim_torch import SolverParams
from softbodysim_torch.api.scenes import Scene
from softbodysim_torch.core import meshes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # three balls of increasing softness, dropped side by side
    stiffnesses = [0.95, 0.5, 0.15]
    bodies = []
    for i, k in enumerate(stiffnesses):
        topo = meshes.tet_ball(2, 0.3, (i * 0.9 - 0.9, 1.0, 0.0))
        params = SolverParams(
            dialect="jacobi", substeps=2, iterations=6,
            edge_stiffness=k, volume_stiffness=min(1.0, k + 0.05),
            sor_omega=1.4, particle_radius=0.02,
            gravity=(0.0, -10.0, 0.0))
        bodies.append((f"ball_k{k}", topo, params, {}))

    scene = Scene(name="mixed_materials", bodies=bodies, colliders=[])
    # the pass kernels on the card, their plain versions on the CPU
    eng, voffs = scene.build_merged(device=args.device)
    eng.run(args.steps, 1.0 / 60.0)
    pos = eng.positions()

    print(f"After {args.steps / 60:.1f} s of settling (softer balls squash "
          "flatter):")
    shapes = {}
    for i, (name, topo, _, _) in enumerate(bodies):
        p = pos[voffs[i]:voffs[i + 1]]
        h = p[:, 1].max() - p[:, 1].min()
        w = p[:, 0].max() - p[:, 0].min()
        shapes[name] = (h, w)
        print(f"  {name:12s} height {h:.3f} width {w:.3f} "
              f"aspect {h / w:.2f}")
    assert np.isfinite(pos).all()
    return shapes


if __name__ == "__main__":
    main()
