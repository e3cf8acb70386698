"""Differentiable simulation: recover a material parameter by gradient.

Scenario: a soft cube is pinned by its top layer and sags under gravity.
Its trajectory is recorded at an unknown edge compliance; the compliance
is then recovered from a 10x-wrong initial guess by minimising the
trajectory's mean squared error with Adam in log space (``diff.fit`` on
``torch.autograd``).

    python -m softbodysim_torch.examples.fit_materials [--steps 80] \
        [--device cuda]
"""

import argparse

import numpy as np
import torch

import softbodysim_torch as sbt
from softbodysim_torch import diff

TRUE_COMPLIANCE = 3e-4
DT, NSTEPS = 1 / 60, 12


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80,
                    help="Adam steps (the run converges in the default 80)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    topo = sbt.meshes.tet_cube(3, 3, 3, size=0.4)
    top = np.where(
        topo.vertices[:, 1] >= topo.vertices[:, 1].max() - 1e-6)[0]
    params = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=4,
                              ground_enabled=False,
                              edge_compliance=TRUE_COMPLIANCE)
    state0 = sbt.init_state(topo, pinned=top, device=args.device)

    # "observe" a trajectory at the true (hidden) compliance
    rollout = diff.make_rollout(topo, params, dt=DT, nsteps=NSTEPS,
                                device=args.device)
    with torch.no_grad():
        target = rollout(state0)
    print(f"observed {NSTEPS} steps of a V={topo.num_particles} cube "
          f"at hidden compliance {TRUE_COMPLIANCE:.1e}")

    res = diff.fit(topo, params, target, dt=DT,
                   fit_params=("edge_compliance",),
                   init={"edge_compliance": TRUE_COMPLIANCE * 10},
                   state0=state0, steps=args.steps, learning_rate=0.25,
                   device=args.device)

    print(f"loss {res.losses[0]:.3e} -> {res.losses[-1]:.3e} "
          f"in {len(res.losses) - 1} adam steps")
    fitted = res.params["edge_compliance"]
    print(f"fitted compliance {fitted:.4e}  "
          f"(true {TRUE_COMPLIANCE:.4e}, error "
          f"{100 * abs(fitted - TRUE_COMPLIANCE) / TRUE_COMPLIANCE:.1f}%)")
    # the fit moves toward the target: the loss falls and the compliance
    # comes closer to the true one than the initial guess
    assert res.losses[-1] < res.losses[0]
    assert abs(np.log(fitted / TRUE_COMPLIANCE)) < np.log(10.0)
    if args.steps >= 80:
        assert res.converged
    return res


if __name__ == "__main__":
    main()
