// Jacobi-dialect constraint passes for Hopper (sm_90a): one gather+apply
// stage per constraint family, reading one frozen snapshot.
//
// Replaces the TPU kernels of softbodysim_tpu/kernels/jacobi.py:
//   edge_pass_kernel            <- _edge_pass_kernel (:71, pallas_call
//                                  :360; with _scatter_acc4 :44 and
//                                  _apply_epilogue :58)
//   tet_grad_kernel + tet_gather_apply_kernel
//                               <- _tet_pass_kernel  (:158, pallas_call :360)
//
// Semantics (the reference's K_EdgeGather / K_VolumeGather -> K_ApplyDelta,
// and the JAX package's solver/jacobi.py segment formulation): every
// constraint reads the positions of the snapshot xin; per particle the
// contributions are summed into (delta, count) and applied as
// x_out = x_in + (omega / count) * delta for free particles with count > 0,
// else x_out = x_in.  lambda is spelled -k * (C / w), as the XLA paths and
// tests/oracle.py spell it.
//
// Design.  Pure Jacobi reads one snapshot, so there is no block order to
// keep (unlike the XPBD sweeps): the passes run over all SMs at once and
// write a second table (double buffering; the step swaps the two), never
// the one they read.  Tables are in public vertex order: xw (V, 4) f32 rows
// x, y, z, inverse mass, so a gather is one 16-byte load.
//   Edge pass: one thread per vertex walks its CSR row of incident edges
//   (other endpoint, edge index; core/adjacency.build_edge_adjacency order),
//   recomputes each edge's lambda from the snapshot and sums its own
//   contribution n * (lambda * w_i): each edge is computed twice, once from
//   each end, and nothing is written but the vertex's row -- no atomics, a
//   fixed sum order.
//   Tet pass, two kernels: (a) one thread per tet computes its role
//   gradients and lambda once and writes, role-major, one float4 per
//   corner: g_r * (lambda * w_r) and a count flag (tet valid and w_r != 0);
//   (b) one thread per vertex sums its CSR row of those slots
//   (build_tet_adjacency order) and applies.  Two kernels because a tet
//   costs ~150 flops and has four corners: recomputing it per corner would
//   quadruple the arithmetic, while the role-major table costs 4T x 16 B
//   written and read once.
// What bounds them: bytes.  Edge pass at 110,592 vertices / 642,960 edges:
// snapshot 1.77 MB + CSR 10.73 MB + rest 2.57 MB read, 1.77 MB written:
// 16.8 MB, 5.0 us at 3.35 TB/s.  Tet pass at 519,115 tets: tets 8.31 MB +
// rest 2.08 MB + snapshot 1.77 MB + CSR 8.75 MB read, 1.77 MB written:
// 22.7 MB, 6.8 us; beside it the design's own 4T x 16 B table, 33.2 MB
// written and read again (19.8 us more).  The snapshot stays in the 50 MB
// L2, so the random neighbour gathers hit L2.
//
// Build with --fmad=false: the products and sums round as in the plain
// PyTorch versions (no contraction into FMA).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// x_out = x_in + (omega / cnt) * s for free rows with cnt > 0.
__device__ __forceinline__ float4 apply_delta(float4 xi, float sx, float sy,
                                              float sz, int cnt,
                                              float omega) {
  float4 out = xi;
  if (cnt > 0 && xi.w != 0.f) {
    const float sc = omega / (float)cnt;
    out.x = xi.x + sc * sx;
    out.y = xi.y + sc * sy;
    out.z = xi.z + sc * sz;
  }
  return out;
}

// Per vertex i, over its incident edges (j, e):
//   w = w_i + w_j, d = x_i - x_j, valid: w != 0 and |d|^2 >= 1e-18;
//   lambda = -k_e * ((|d| - rest_e) / w), k_e = k * ktab[e] when a table
//   is given; contribution (d / |d|) * (lambda * w_i); count += valid.
__global__ void __launch_bounds__(kThreads)
edge_pass_kernel(const float4* __restrict__ xin, float4* __restrict__ xout,
                 const int* __restrict__ row, const int2* __restrict__ ent,
                 const float* __restrict__ rest,
                 const float* __restrict__ ktab, int nv, float k,
                 float omega, int* __restrict__ cnt_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nv) return;
  const float4 xi = xin[i];
  float sx = 0.f, sy = 0.f, sz = 0.f;
  int cnt = 0;
  const int q1 = row[i + 1];
  for (int q = row[i]; q < q1; ++q) {
    const int2 je = ent[q];
    const float4 xj = xin[je.x];
    const float w = xi.w + xj.w;
    const float dx = xi.x - xj.x, dy = xi.y - xj.y, dz = xi.z - xj.z;
    const float len2 = dx * dx + dy * dy + dz * dz;
    if (w != 0.f && len2 >= 1e-18f) {
      const float len = sqrtf(fmaxf(len2, 1e-30f));
      const float c = len - rest[je.y];
      const float kk = ktab != nullptr ? ktab[je.y] * k : k;
      const float lam = -kk * (c / w);
      const float s = lam * xi.w;
      sx = sx + (dx / len) * s;
      sy = sy + (dy / len) * s;
      sz = sz + (dz / len) * s;
      ++cnt;
    }
  }
  xout[i] = apply_delta(xi, sx, sy, sz, cnt, omega);
  if (cnt_out != nullptr) cnt_out[i] = cnt;
}

__device__ __forceinline__ void cross3(float ax, float ay, float az,
                                       float bx, float by, float bz,
                                       float& ox, float& oy, float& oz) {
  ox = ay * bz - az * by;
  oy = az * bx - ax * bz;
  oz = ax * by - ay * bx;
}

// Phase (a), one thread per tet t = (a, b, c, d):
//   g_a = ((p_d - p_b) x (p_c - p_b)) / 6, g_b = ((p_c - p_a) x (p_d - p_a))/6,
//   g_c = ((p_d - p_a) x (p_b - p_a)) / 6, g_d = ((p_b - p_a) x (p_c - p_a))/6;
//   wsum = sum_r w_r |g_r|^2, valid: sum_r w_r != 0 and wsum >= 1e-20;
//   vol = ((p_b - p_a) x (p_c - p_a)) . (p_d - p_a) / 6;
//   lambda = -k_t * ((vol - rest_t) / wsum);
//   glam[r * T + t] = (g_r * (lambda * w_r), valid && w_r != 0).
__global__ void __launch_bounds__(kThreads)
tet_grad_kernel(const float4* __restrict__ xin, const int4* __restrict__ tets,
                const float* __restrict__ rest,
                const float* __restrict__ ktab, int nt, float k,
                float4* __restrict__ glam) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nt) return;
  const int4 v = tets[t];
  const float4 A = xin[v.x], B = xin[v.y], C = xin[v.z], D = xin[v.w];
  float g[4][3];
  cross3(D.x - B.x, D.y - B.y, D.z - B.z, C.x - B.x, C.y - B.y, C.z - B.z,
         g[0][0], g[0][1], g[0][2]);
  cross3(C.x - A.x, C.y - A.y, C.z - A.z, D.x - A.x, D.y - A.y, D.z - A.z,
         g[1][0], g[1][1], g[1][2]);
  cross3(D.x - A.x, D.y - A.y, D.z - A.z, B.x - A.x, B.y - A.y, B.z - A.z,
         g[2][0], g[2][1], g[2][2]);
  float crx, cry, crz;        // (p_b - p_a) x (p_c - p_a), before the / 6
  cross3(B.x - A.x, B.y - A.y, B.z - A.z, C.x - A.x, C.y - A.y, C.z - A.z,
         crx, cry, crz);
  g[3][0] = crx;
  g[3][1] = cry;
  g[3][2] = crz;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    g[r][0] = g[r][0] / 6.f;
    g[r][1] = g[r][1] / 6.f;
    g[r][2] = g[r][2] / 6.f;
  }
  const float w[4] = {A.w, B.w, C.w, D.w};
  float wsum = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float n2 = g[r][0] * g[r][0] + g[r][1] * g[r][1] +
                     g[r][2] * g[r][2];
    wsum = r == 0 ? w[0] * n2 : wsum + w[r] * n2;
  }
  const bool valid = (((w[0] + w[1]) + w[2]) + w[3]) != 0.f &&
                     wsum >= 1e-20f;
  float lam = 0.f;
  if (valid) {
    const float vol = (crx * (D.x - A.x) + cry * (D.y - A.y) +
                       crz * (D.z - A.z)) / 6.f;
    const float kk = ktab != nullptr ? ktab[t] * k : k;
    lam = -kk * ((vol - rest[t]) / wsum);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float s = lam * w[r];
    glam[(size_t)r * nt + t] =
        make_float4(g[r][0] * s, g[r][1] * s, g[r][2] * s,
                    (valid && w[r] != 0.f) ? 1.f : 0.f);
  }
}

// Phase (b), one thread per vertex: sum the vertex's slots of the phase-(a)
// table, count the flagged ones, apply.
__global__ void __launch_bounds__(kThreads)
tet_gather_apply_kernel(const float4* __restrict__ xin,
                        float4* __restrict__ xout,
                        const float4* __restrict__ glam,
                        const int* __restrict__ row,
                        const int* __restrict__ slot, int nv, float omega,
                        int* __restrict__ cnt_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nv) return;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  int cnt = 0;
  const int q1 = row[i + 1];
  for (int q = row[i]; q < q1; ++q) {
    const float4 gl = glam[slot[q]];
    sx = sx + gl.x;
    sy = sy + gl.y;
    sz = sz + gl.z;
    cnt += gl.w != 0.f ? 1 : 0;
  }
  xout[i] = apply_delta(xin[i], sx, sy, sz, cnt, omega);
  if (cnt_out != nullptr) cnt_out[i] = cnt;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError() so that a
// refused launch is reported to the caller.
extern "C" {

int sbs_jacobi_edge_pass(const void* xin, void* xout, const int* row,
                         const void* ent, const float* rest,
                         const float* ktab, int nv, float k, float omega,
                         int* cnt_out, void* stream) {
  if (nv > 0) {
    edge_pass_kernel<<<blocks_for(nv), kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)xin, (float4*)xout, row, (const int2*)ent, rest, ktab,
        nv, k, omega, cnt_out);
  }
  return (int)cudaGetLastError();
}

int sbs_jacobi_tet_pass(const void* xin, void* xout, const int* tets,
                        const float* rest, const float* ktab, void* glam,
                        const int* row, const int* slot, int nv, int nt,
                        float k, float omega, int* cnt_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nt > 0) {
    tet_grad_kernel<<<blocks_for(nt), kThreads, 0, s>>>(
        (const float4*)xin, (const int4*)tets, rest, ktab, nt, k,
        (float4*)glam);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (nv > 0) {
    tet_gather_apply_kernel<<<blocks_for(nv), kThreads, 0, s>>>(
        (const float4*)xin, (float4*)xout, (const float4*)glam, row, slot, nv,
        omega, cnt_out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
