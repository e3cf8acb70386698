"""The Jacobi pass kernels at several tile sizes, at north-star shapes, on
one NVIDIA GPU.

    python3 tools/jacobi_tile_sizes.py [cap ...]     (default 128 256 512)

``cap`` is the most vertices a tile owns (``kernels/jacobi_plan.py``;
the port uses ``TILE_CAP``).  For each cap and family it builds the tile
plan of tet_cube(47), checks one pass from a predicted, perturbed state
against the plain version (1e-5 m, counts equal), and prints the plan
(tiles, the largest tile, its shared memory, the constraints listed), the
CTAs per SM, and the kernel's device time per call (torch.profiler over
20 launches, ``softbodysim_torch.perf.profile.kernel_ms``), one JSON line
each, beside the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import softbodysim_torch as sbt  # noqa: E402
from softbodysim_torch.kernels import jacobi as kj  # noqa: E402
from softbodysim_torch.kernels import jacobi_plan  # noqa: E402
from softbodysim_torch.perf.profile import kernel_ms  # noqa: E402


def main(caps) -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    topo = sbt.meshes.tet_cube(**chip_smoke.NORTH_STAR)
    V = topo.num_particles
    params = sbt.SolverParams(**chip_smoke.JACOBI)
    state = sbt.init_state(topo, inv_mass_mode="density", device=device)
    sdt = np.float32(chip_smoke.DT) / np.float32(params.substeps)
    noise = np.random.default_rng(chip_smoke.SEED + 1).normal(
        0.0, 1e-3, (V, 3)).astype(np.float32)
    x = state.x.clone()
    x[:, 1] -= float(np.float32(10.0) * sdt * sdt)
    x += torch.as_tensor(noise, device=device)
    xin = torch.cat([x, state.inv_mass[:, None]], 1).contiguous()
    om = float(np.float32(params.sor_omega))
    for cap in caps:
        for name, cls, fn, plain, cons, rest, k in (
                ("jacobi_edge_pass", kj.EdgePassPlan, kj.jacobi_edge_pass,
                 kj.jacobi_edge_pass_plain, topo.edges, topo.edge_rest,
                 params.edge_stiffness),
                ("jacobi_tet_pass", kj.TetPassPlan, kj.jacobi_tet_pass,
                 kj.jacobi_tet_pass_plain, topo.tets, topo.tet_rest_vol,
                 params.volume_stiffness)):
            rest = np.asarray(rest, np.float32)
            t0 = time.perf_counter()
            tp = jacobi_plan.tile_plan(V, cons, topo.vertices, cap)
            plan = cls(V, torch.as_tensor(cons, device=device).int(),
                       torch.as_tensor(rest, device=device), None,
                       kj.device_tiles(tp, rest, None, device))
            built = time.perf_counter() - t0
            k = float(np.float32(k))
            # k and omega on the device, as the pass step gives them
            kd, omd = (torch.tensor(v, device=device) for v in (k, om))
            xa, xb = torch.empty_like(xin), torch.empty_like(xin)
            ca = torch.zeros(V, dtype=torch.int32, device=device)
            cb = torch.zeros_like(ca)
            fn(plan, xin, xa, kd, omd, ca)
            plain(plan, xin, xb, k, om, cb)
            torch.cuda.synchronize()
            err = (xa - xb).abs().max().item()
            if not (err <= chip_smoke.PASS_TOL and torch.equal(ca, cb)):
                raise AssertionError(f"{name} at cap {cap}: {err}")
            ms = kernel_ms(lambda: fn(plan, xin, xa, kd, omd), 20)
            tl = plan.tiles
            print(json.dumps({
                "cap": cap, "kernel": name, "ms": ms, "max_abs_err": err,
                "ctas_per_sm": kj.ctas_per_sm(plan), "plan_s": built,
                "plan": jacobi_plan.describe(tl, tl.rest.shape[0],
                                             len(cons))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]] or [128, 256, 512]))
