// Fused collide stage for Hopper (sm_90a): ground plane, then every
// primitive collider in registration order.
//
// Replaces softbodysim_tpu/kernels/collide.py::_collide_kernel (:136,
// pallas_call :220) on the paths that run the stage on its own: the xpbd
// sweep, legacy and coloured steps and the jacobi gather and segment
// backends.  The jacobi pass backend runs the same stage inside its last
// pass of each iteration (jacobi.cu, tile_pass_kernel<arity, true>).  The
// per-particle arithmetic, shared with that pass, is collide_math.cuh.
// Instantiated on both particle tables of the xpbd sweep step (rows.cuh):
// on the bf16 table (SolverParams.xpbd_x_dtype="bfloat16") a row is read
// upcast, pushed out in f32 and rounded once on the store, as the JAX
// step pushes out an f32 upcast and rounds it back
// (softbodysim_tpu/solver/xpbd_pallas.py:652-658).
//
// Design.  One thread per particle reads its (x, y, z, w) row of the (V, 4)
// table once, applies the ground plane and the K colliders (table staged
// in shared memory) in registers and writes the row once, in place, only
// for free particles.
// What bounds it: bytes, V x 16 B read and V x 12 B written (~3 MB, about
// 1 us at 3.35 TB/s at 110k particles; the bf16 table: V x 8 B each way);
// at that size launch latency sets its time.  The per-particle work is a
// few hundred flops for K <= 16.
//
// Build with --fmad=false: the products and sums round as in the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "collide_math.cuh"
#include "rows.cuh"

namespace {

constexpr int kThreads = 256;

template <class Row>
__global__ void __launch_bounds__(kThreads)
collide_kernel(typename Row::T* __restrict__ xw, int nv,
               const float* __restrict__ cols, int ncols, Ground g) {
  extern __shared__ float tab[];           // [ncols][12]
  for (int q = threadIdx.x; q < ncols * 12; q += blockDim.x) tab[q] = cols[q];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nv) return;
  const float4 x = Row::load(xw, i);
  if (x.w == 0.f) return;                  // pinned: untouched
  Row::store(xw, i, collide_row(x, g, tab, ncols));
}

}  // namespace

// Plain C entry point (bound with ctypes): launches on the given stream,
// does not synchronise, returns cudaGetLastError().  bf16: 0 the f32
// table, 1 the bf16 table.
extern "C" int sbs_collide(void* xw, int nv, const float* cols, int ncols,
                           int ground_on, float gpx, float gpy, float gpz,
                           float gnx, float gny, float gnz, float r,
                           int bf16, void* stream) {
  if (nv > 0) {
    const size_t smem = (size_t)ncols * 12 * sizeof(float);
    const Ground g = {ground_on, gpx, gpy, gpz, gnx, gny, gnz, r};
    const int blocks = (nv + kThreads - 1) / kThreads;
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16)
      collide_kernel<RowBF16><<<blocks, kThreads, smem, st>>>(
          (RowBF16::T*)xw, nv, cols, ncols, g);
    else
      collide_kernel<RowF32><<<blocks, kThreads, smem, st>>>(
          (RowF32::T*)xw, nv, cols, ncols, g);
  }
  return (int)cudaGetLastError();
}
