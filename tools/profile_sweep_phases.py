"""Per-block phase profile of the CUDA sweep kernels at north-star shapes,
on one NVIDIA GPU.

    python3 tools/profile_sweep_phases.py

Builds an instrumented copy of ``softbodysim_torch/kernels/csrc/sweep.cu``
into ``softbodysim_torch/_build/profile/``: thread 0 of every CTA reads
``clock64`` at each phase boundary of a block and the totals are summed
over the CTAs.  Then runs each of the four sweeps on the north-star plans
(tet_cube(47), the xpbd step's default schemes) at the card's Q and at
Q = 1, and prints per sweep its time per call (CUDA events over 20
back-to-back launches) and the mean cycles per block of each phase, as
thread 0 sees them:

  stage next  the stager's bulk copies of the next block (another thread)
  stage wait  the wait for this block's staged tables
  waits       polling predecessors on other queues, and its barrier
  rows        loading the block's rows from xw, and the barrier
  visit       the lanes' constraint solves, and the barrier
  apply       the rows' sums and the stores to xw, and the barrier
  tail        the lambda store and the release

With Q > 1 most CTAs idle in "waits" most of the time, so the per-block
means there are not a block's cost; Q = 1 gives the chain of one block.
The instrumentation takes registers: times run a little above the plain
build's (chip_smoke.py times that one).
"""

from __future__ import annotations

import ctypes
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import instrumented_build as ib  # noqa: E402
import softbodysim_torch as sbt  # noqa: E402
from softbodysim_torch.kernels import sweep as ksw  # noqa: E402
from softbodysim_torch.solver.xpbd_sweep import SweepStep  # noqa: E402

PHASES = ("stage next", "stage wait", "waits", "rows", "visit", "apply",
          "tail")
# (anchor in sweep.cu, the stamp, placed after the anchor?)
STAMPS = (
    ("  for (int k = 0; k < n; ++k) {\n    const int s = k % ns;\n", 0, True),
    ("    const unsigned char* st = smem + L.stages + s * L.stage;\n", 1,
     False),
    ("    const int* rec = reinterpret_cast<const int*>(st + L.rec);\n", 2,
     False),
    ("    // the stage is refilled once the stager passes", 3, False),
    ("    lane.load(st, L, a, t);\n    __syncthreads();\n", 4, True),
    ("      lane.visit(rows, corr, t);\n      __syncthreads();\n", 5, True),
    ("          rows[u] = Row::round(x);\n      }\n      __syncthreads();\n",
     6, True),
    ("    if (release && t == kStager) st_release(a.flags + b, a.epoch);\n",
     7, True),
)


def instrumented_source() -> str:
    src = ib.source("sweep.cu")
    for anchor, i, after in STAMPS:
        src = ib.insert(src, anchor, f"PHASE({i})\n", "sweep.cu",
                        before=not after)
    src = ib.insert(src, "namespace {\n", (
        "__device__ unsigned long long g_phase[9];\n"
        "#define PHASE(i) if (t == 0) { const long long c_ = clock64(); "
        "acc_[i] += c_ - last_; last_ = c_; }\n"), "sweep.cu")
    loop = "  for (int k = 0; k < n; ++k) {\n"
    src = src.replace(loop, "  long long acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0};"
                      "\n  long long last_ = clock64();\n" + loop, 1)
    end = STAMPS[-1][0] + "PHASE(7)\n  }\n"
    src = ib.insert(src, end, (
        "  if (t == 0) {\n    for (int i = 0; i < 8; ++i)\n"
        "      atomicAdd(&g_phase[i], (unsigned long long)acc_[i]);\n"
        "    atomicAdd(&g_phase[8], (unsigned long long)n);\n  }\n"),
        "sweep.cu")
    return ib.insert(src, 'extern "C" {\n', (
        "int sbs_phase_take(unsigned long long* out) {\n"
        "  unsigned long long zero[9] = {0};\n"
        "  cudaMemcpyFromSymbol(out, g_phase, sizeof(zero));\n"
        "  cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));\n"
        "  return (int)cudaDeviceSynchronize();\n}\n"), "sweep.cu")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    lib = ib.build("sweep.cu", instrumented_source(), "profile")
    topo = sbt.meshes.tet_cube(47, 47, 47, size=1.0, center=(0.0, 2.0, 0.0))
    params = sbt.SolverParams(dialect="xpbd", substeps=8, iterations=1)
    rng = np.random.default_rng(0)
    for superblocks in (True, False):
        t0 = time.perf_counter()
        step = SweepStep(topo, params, device="cpu", superblocks=superblocks)
        print(f"plans ({'super' if superblocks else 'legacy'}): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        xw = step.pack_state(sbt.init_state(topo, device="cpu")).xw.to(dev)
        free = (xw[:, 3:4] != 0).float()
        xw[:, :3] += torch.as_tensor(rng.normal(
            0.0, 1e-3, (xw.shape[0], 3)).astype(np.float32), device=dev) * free
        for fam, k in (("edges", step.block_scheme["local_iters"][0]),
                       ("tets", step.block_scheme["local_iters"][1])):
            g = step.gpu_plans[fam]
            for queues in (None, 1):
                plan = ksw.to_device(g, dev, queues=queues)
                if superblocks:
                    wt = ksw.w_fill(plan, xw)
                    fn = ksw.edge_sweep if fam == "edges" else ksw.tet_sweep

                    def run(x, lam):
                        fn(plan, x, lam, wt, 1e-2, k)
                else:
                    fn = (ksw.legacy_edge_sweep if fam == "edges"
                          else ksw.legacy_tet_sweep)

                    def run(x, lam):
                        fn(plan, x, lam, 1e-2)
                x = xw.clone()
                lam = torch.zeros(g.num_blocks * g.width, device=dev)
                cyc = (ctypes.c_ulonglong * 9)()
                run(x, lam)
                lib.sbs_phase_take(cyc)
                for _ in range(5):
                    run(x, lam)
                lib.sbs_phase_take(cyc)
                ksw.raise_on_timeouts()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    run(x, lam)
                end.record()
                torch.cuda.synchronize()
                per = [cyc[i] / cyc[8] for i in range(8)]
                st = plan.staged
                print(f"{fn.__name__} Q={st.capacity} CTAs={st.queues}: "
                      f"{start.elapsed_time(end) / 20:.4f} ms; cycles per "
                      "block: " + ", ".join(
                          f"{n} {c:.0f}" for n, c in zip(PHASES, per[1:]))
                      + f"; all {sum(per):.0f}", flush=True)
    print(ib.card_clocks())
    return 0


if __name__ == "__main__":
    sys.exit(main())
