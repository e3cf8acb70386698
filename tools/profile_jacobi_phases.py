"""Per-CTA phase profile of the CUDA Jacobi pass kernels at north-star
shapes, on one NVIDIA GPU.

    python3 tools/profile_jacobi_phases.py

Builds an instrumented copy of ``softbodysim_torch/kernels/csrc/
jacobi.cu`` into ``softbodysim_torch/_build/profile_jacobi/``: thread 0 of
every CTA reads ``clock64`` at each phase boundary of its tile and
``%globaltimer`` at the CTA's start and end, and stores them in the CTA's
own row of a table (no atomics).  Then runs each pass on the north-star
tile plans (tet_cube(47)) from a predicted, perturbed state and prints
per pass its time per call (CUDA events over 20 back-to-back launches),
the mean cycles per CTA of each phase as thread 0 sees them (in the last
launch), and the CTAs' lifetimes beside the span of the launch's CTAs.
The passes: edges, tets, and tets with the collide stage fused (the
floor box and the ground plane, the body moved onto them, as the jacobi
main path runs it).

  stage   the tile's header, the rows of the snapshot (and the collider
          table) into shared memory, and the barrier
  visit   the listed constraints into their slots, and the barrier
  apply   thread 0's owned vertices: their sums, the apply (and the
          collide stage), the stores; and its heavy runs' partials

The instrumentation takes registers and a few stores per CTA: times run a
little above the plain build's (chip_smoke.py times that one).
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import instrumented_build as ib  # noqa: E402
import softbodysim_torch as sbt  # noqa: E402
from softbodysim_torch.kernels import collide as kc  # noqa: E402
from softbodysim_torch.kernels import jacobi as kj  # noqa: E402

PHASES = ("stage", "visit", "apply")
MAX_CTAS = 4096
FIELDS = 5              # the three phases' cycles, start and end time (ns)
# (anchor in jacobi.cu, the code placed after it)
STAMPS = (
    ("  extern __shared__ float4 smem[];\n",
     "  long long last_ = clock64(), acc_[3] = {0, 0, 0};\n"
     "  const unsigned long long t0_ = threadIdx.x == 0 ? gtime() : 0;\n"),
    ("    srows[r] = xin[rows[r0 + r]];\n  __syncthreads();\n", "PHASE(0)\n"),
    ("      tet_visit(srows, slots, v0, v1, rs, kk);\n    }\n  }\n"
     "  __syncthreads();\n", "PHASE(1)\n"),
    ("hv.part_end[p0 + j]);\n    }\n  }\n",
     "PHASE(2)\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0 && blockIdx.x < MAX_CTAS_) {\n"
     "    unsigned long long* f =\n"
     "        g_cta[kArity / 2 - 1 + (kCollide ? 2 : 0)][blockIdx.x];\n"
     "    for (int i = 0; i < 3; ++i) f[i] = acc_[i];\n"
     "    f[3] = t0_;\n"
     "    f[4] = gtime();\n"
     "  }\n"),
)


def instrumented_source() -> str:
    src = ib.source("jacobi.cu")
    for anchor, code in STAMPS:
        src = ib.insert(src, anchor, code, "jacobi.cu")
    src = ib.insert(src, "namespace {\n", (
        f"constexpr int MAX_CTAS_ = {MAX_CTAS};\n"
        f"__device__ unsigned long long g_cta[4][{MAX_CTAS}][{FIELDS}];\n"
        "__device__ __forceinline__ unsigned long long gtime() {\n"
        "  unsigned long long t;\n"
        '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
        "  return t;\n}\n"
        "#define PHASE(i) if (threadIdx.x == 0) { const long long c_ = "
        "clock64(); acc_[i] += c_ - last_; last_ = c_; }\n"), "jacobi.cu")
    return ib.insert(src, 'extern "C" {\n', (
        "int sbs_phase_take(unsigned long long* out) {\n"
        "  cudaMemcpyFromSymbol(out, g_cta, sizeof(g_cta));\n"
        "  return (int)cudaDeviceSynchronize();\n}\n"), "jacobi.cu")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    lib = ib.build("jacobi.cu", instrumented_source(), "profile_jacobi")
    topo = sbt.meshes.tet_cube(47, 47, 47, size=1.0, center=(0.0, 2.0, 0.0))
    V = topo.num_particles
    state = sbt.init_state(topo, inv_mass_mode="density", device=dev)
    noise = np.random.default_rng(1).normal(0.0, 1e-3, (V, 3))
    x = state.x + torch.as_tensor(noise.astype(np.float32), device=dev)
    xin = torch.cat([x, state.inv_mass[:, None]], 1).contiguous()
    xout = torch.empty_like(xin)
    # k and omega on the device, as the pass step gives them
    k, om = (torch.tensor(v, device=dev) for v in (0.9, 1.4))
    params = sbt.SolverParams(dialect="jacobi", particle_radius=0.02)
    packed = kc.pack_colliders(sbt.Colliders.build(
        [sbt.Colliders.box((0.0, 0.1, 0.0), (1.5, 0.1, 1.5))], device=dev))
    ground = kc.make_ground(params)
    xin[:, 1] -= 1.75                   # the body's bottom into the box

    def tet_collide(plan, xin, xout, k, om):
        kj.jacobi_tet_pass_collide(plan, xin, xout, k, om, packed, ground)

    take = np.zeros((4, MAX_CTAS, FIELDS), np.uint64)
    for slot, (make, fn, cons, rest) in (
            (0, (kj.edge_pass_plan, kj.jacobi_edge_pass, topo.edges,
                 topo.edge_rest)),
            (1, (kj.tet_pass_plan, kj.jacobi_tet_pass, topo.tets,
                 topo.tet_rest_vol)),
            (3, (kj.tet_pass_plan, tet_collide, topo.tets,
                 topo.tet_rest_vol))):
        plan = make(V, cons, rest, device=dev, vertices=topo.vertices)
        n = plan.tiles.num_tiles
        if n > MAX_CTAS:
            raise ValueError(f"{n} tiles: more than {MAX_CTAS} CTAs")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn(plan, xin, xout, k, om)
        start.record()
        for _ in range(20):
            fn(plan, xin, xout, k, om)
        end.record()
        torch.cuda.synchronize()
        lib.sbs_phase_take(take.ctypes.data)      # the last launch's CTAs
        f = take[slot, :n].astype(np.float64)
        life = (f[:, 4] - f[:, 3]) / 1e3
        name = ("jacobi_tet_pass_collide (floor box, ground)"
                if fn is tet_collide else fn.__name__)
        print(f"{name}: {start.elapsed_time(end) / 20:.4f} ms per "
              f"call ({n} tiles, {kj.ctas_per_sm(plan)} CTAs per SM); "
              "mean cycles per CTA: "
              + ", ".join(f"{p} {c:.0f}" for p, c in
                          zip(PHASES, f[:, :3].mean(0)))
              + f"; CTA lifetime mean {life.mean():.2f} us, max "
              f"{life.max():.2f} us; the launch's CTAs span "
              f"{(f[:, 4].max() - f[:, 3].min()) / 1e3:.2f} us",
              flush=True)
    print(ib.card_clocks())
    return 0


if __name__ == "__main__":
    sys.exit(main())
