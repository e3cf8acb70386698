// Block-synchronous XPBD constraint sweeps for Hopper (sm_90a).
//
// Replaces the TPU kernels of softbodysim_tpu/kernels/sweep.py:
//   w_fill_kernel                      <- _w_fill_kernel     (sweep.py:1118)
//   edge_sweep_kernel<1024, false>     <- _edge_kernel_super (sweep.py:1169,
//                                         with _gather_xyz :1083 and
//                                         _scatter_super :1151)
//   tet_sweep_kernel<1024, false>      <- _tet_kernel_super  (sweep.py:1267)
//   edge_sweep_kernel<128, true>       <- _edge_kernel (sweep.py:825, with
//                                         _gather_role :805 and
//                                         _scatter_slot :818)
//   tet_sweep_kernel<128, true>        <- _tet_kernel  (sweep.py:894)
//
// Semantics (the JAX package's, replayed by tests/oracle.py::step_blocks):
// constraints are packed into blocks -- super-blocks of 1024, or the legacy
// SweepPlan blocks of 128 (superblocks=False); inside a block every
// constraint reads the positions from before the block and the corrections
// of all its constraints are summed (Jacobi); blocks run one after another
// in plan order (Gauss-Seidel).
//
// The legacy instantiations (kLegacy) take only what the JAX legacy kernels
// take: the scale scheme (dlambda times the lane's 1/m, m the largest
// within-block multiplicity of its vertices), one visit per block, and the
// inverse masses read from the table's w column (no streamed w table).
// They round as those kernels do: the edge normal is d / |d| (sweep.py:856)
// and the volume dot(cross(pb - pa, pc - pa), pd - pa) times the f32 sixth
// (:924); the super-block kernels multiply by 1/|d| and take the volume as
// g_d . (pd - pa) with g_d already scaled.
//
// Design.  The particle table xw is (Vpad, 4) f32 -- x, y, z, inverse mass
// -- so a corner gather is one 16-byte load; at the north-star size it is
// 1.7 MB and stays in L2.  One persistent CTA of kBlock threads walks the
// family's blocks in order, one thread per constraint lane:
//   1. gather the corners, compute dlambda, update lambda (kept in a
//      register across the K in-block revisits), write the per-role
//      corrections to shared memory;
//   2. __syncthreads() -- no thread may write xw before every thread has
//      gathered (pre-block reads);
//   3. walk the block's vertex CSR (built on the host, each vertex once,
//      its (lane, role) entries in ascending order) and add each vertex's
//      summed correction into xw -- no atomics, the same sum order every
//      run;
//   4. __syncthreads(), then the next block.
// What bounds it: latency, not bytes or FLOPs.  One SM runs the whole sweep
// and each block is a chain of dependent L2 loads (plan -> xw gather, CSR ->
// shared -> xw update); at the north star an iteration is 1,328 such block
// steps on super-blocks and about 12k (5,560 edge, 6,776 tet) on the legacy
// blocks.  This is deliberate for the exact block order; a block-colour
// schedule that runs independent blocks on many SMs is later work.
//
// Build with --fmad=false: the products and sums are rounded as in the
// plain PyTorch versions and the JAX kernels (no contraction into FMA).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSuper = 1024;     // constraints per super-block == CTA size
constexpr int kLegacyWidth = 128;  // constraints per legacy block == CTA size

// per-role corrections of one tet block, dynamic shared memory (opt-in
// above 48 KB)
template <int kBlock>
constexpr int tet_smem() { return 4 * 3 * kBlock * (int)sizeof(float); }

// One thread per output value.  Edges (arity 2): wsum[p] = c0*w0 + c1*w1.
// Tets (arity 4): w[p, r] = c_r * w_r.  Pad lanes (vertex -1) get w = 0.
// The counts are the within-block multiplicities under the split scheme
// (mass splitting) and ones under the scale scheme.
__global__ void w_fill_kernel(const int* __restrict__ verts,
                              const float* __restrict__ cnt,
                              const float4* __restrict__ xw,
                              float* __restrict__ wout, int n, int arity) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (arity == 2) {
    if (i >= n) return;
    const int v0 = verts[2 * i], v1 = verts[2 * i + 1];
    const float w0 = v0 >= 0 ? xw[v0].w : 0.f;
    const float w1 = v1 >= 0 ? xw[v1].w : 0.f;
    wout[i] = w0 * cnt[2 * i] + w1 * cnt[2 * i + 1];
  } else {
    if (i >= n * arity) return;
    const int v = verts[i];
    const float w = v >= 0 ? xw[v].w : 0.f;
    wout[i] = w * cnt[i];
  }
}

// XPBD distance sweep.  Per live lane: C = |d| - rest,
// dlambda = (-C - a*lambda) / (wsum + a) (wsum streamed from w_fill, or
// w0 + w1 off the table when kLegacy; guards wsum != 0 and |d| >= 1e-12),
// times the lane's scale; lambda += dlambda.  Corrections: +n*dlambda*w to
// role 0, -n*dlambda*w to role 1, w the plain inverse mass of the target
// vertex.
template <int kBlock, bool kLegacy>
__global__ void __launch_bounds__(kBlock, 1)
edge_sweep_kernel(float4* xw, float* lam, const int2* __restrict__ verts,
                  const float* __restrict__ rest,
                  const float* __restrict__ scale,
                  const float* __restrict__ atab,
                  const float* __restrict__ wsum,
                  const int* __restrict__ blk_vptr,
                  const int* __restrict__ cvert,
                  const int* __restrict__ cptr,
                  const int* __restrict__ centry, int nblocks, float alpha,
                  int local_iters) {
  __shared__ float corr[3 * kBlock];
  const int t = threadIdx.x;
  for (int b = 0; b < nblocks; ++b) {
    const int p = b * kBlock + t;
    const int2 v = verts[p];
    const bool live = v.x >= 0;
    float l = 0.f, ws = 0.f, r = 0.f, sc = 0.f, al = alpha;
    if (live) {
      l = lam[p];
      if (!kLegacy) ws = wsum[p];
      r = rest[p];
      sc = scale[p];
      if (atab != nullptr) al = alpha * atab[p];
    }
    const int u0 = blk_vptr[b], u1 = blk_vptr[b + 1];
    for (int rep = 0; rep < local_iters; ++rep) {
      float cx = 0.f, cy = 0.f, cz = 0.f;
      if (live) {
        const float4 a0 = xw[v.x];
        const float4 a1 = xw[v.y];
        if (kLegacy) ws = a0.w + a1.w;
        const float dx = a0.x - a1.x, dy = a0.y - a1.y, dz = a0.z - a1.z;
        const float length = sqrtf(dx * dx + dy * dy + dz * dz);
        const bool valid = (ws != 0.f) && (length >= 1e-12f);
        const float c = length - r;
        const float denom = ws + al;
        float dlam = valid ? (-c - al * l) / (denom == 0.f ? 1.f : denom)
                           : 0.f;
        dlam = dlam * sc;
        l = l + dlam;
        const float nl = length < 1e-12f ? 1.f : length;
        if (kLegacy) {
          cx = (dx / nl) * dlam;
          cy = (dy / nl) * dlam;
          cz = (dz / nl) * dlam;
        } else {
          const float inv_len = 1.f / nl;
          cx = (dx * inv_len) * dlam;
          cy = (dy * inv_len) * dlam;
          cz = (dz * inv_len) * dlam;
        }
      }
      corr[t] = cx;
      corr[kBlock + t] = cy;
      corr[2 * kBlock + t] = cz;
      __syncthreads();
      for (int u = u0 + t; u < u1; u += kBlock) {
        const int vid = cvert[u];
        float4 x = xw[vid];
        float sx = 0.f, sy = 0.f, sz = 0.f;
        const int e1 = cptr[u + 1];
        for (int e = cptr[u]; e < e1; ++e) {
          const int ent = centry[e];
          const int lane = ent >> 2;
          const float f = (ent & 3) == 0 ? x.w : -x.w;
          sx = sx + corr[lane] * f;
          sy = sy + corr[kBlock + lane] * f;
          sz = sz + corr[2 * kBlock + lane] * f;
        }
        x.x = x.x + sx;
        x.y = x.y + sy;
        x.z = x.z + sz;
        xw[vid] = x;
      }
      __syncthreads();
    }
    if (live) lam[p] = l;
  }
}

__device__ __forceinline__ void cross3(float ax, float ay, float az,
                                       float bx, float by, float bz,
                                       float& ox, float& oy, float& oz) {
  ox = ay * bz - az * by;
  oy = az * bx - ax * bz;
  oz = ax * by - ay * bx;
}

// XPBD volume sweep.  g_r = cross/6, wsum = sum_r w_r |g_r|^2 with the
// streamed (count-inflated under split) w_r, or the table's w_r when
// kLegacy; guards sum w_r != 0 and wsum >= 1e-20; the same dlambda and
// lambda update as the edge sweep.  Corrections: g_r * dlambda * w_target
// under split (ms != 0, mass splitting applies the plain w of the target),
// else g_r * (w_r * dlambda).
template <int kBlock, bool kLegacy>
__global__ void __launch_bounds__(kBlock, 1)
tet_sweep_kernel(float4* xw, float* lam, const int4* __restrict__ verts,
                 const float* __restrict__ rest,
                 const float* __restrict__ scale,
                 const float* __restrict__ atab,
                 const float4* __restrict__ wtab,
                 const int* __restrict__ blk_vptr,
                 const int* __restrict__ cvert,
                 const int* __restrict__ cptr,
                 const int* __restrict__ centry, int nblocks, float alpha,
                 int local_iters, int ms) {
  extern __shared__ float corr[];   // [role][component][lane]
  const int t = threadIdx.x;
  const float sixth = (float)(1.0 / 6.0);
  const bool split = !kLegacy && ms;
  for (int b = 0; b < nblocks; ++b) {
    const int p = b * kBlock + t;
    const int4 v = verts[p];
    const bool live = v.x >= 0;
    float l = 0.f, r = 0.f, sc = 0.f, al = alpha;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      l = lam[p];
      r = rest[p];
      sc = scale[p];
      if (!kLegacy) w = wtab[p];
      if (atab != nullptr) al = alpha * atab[p];
    }
    const int u0 = blk_vptr[b], u1 = blk_vptr[b + 1];
    for (int rep = 0; rep < local_iters; ++rep) {
      float g[4][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f},
                       {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      if (live) {
        const float4 A = xw[v.x], B = xw[v.y], C = xw[v.z], D = xw[v.w];
        if (kLegacy) w = make_float4(A.w, B.w, C.w, D.w);
        cross3(D.x - B.x, D.y - B.y, D.z - B.z, C.x - B.x, C.y - B.y,
               C.z - B.z, g[0][0], g[0][1], g[0][2]);
        cross3(C.x - A.x, C.y - A.y, C.z - A.z, D.x - A.x, D.y - A.y,
               D.z - A.z, g[1][0], g[1][1], g[1][2]);
        cross3(D.x - A.x, D.y - A.y, D.z - A.z, B.x - A.x, B.y - A.y,
               B.z - A.z, g[2][0], g[2][1], g[2][2]);
        cross3(B.x - A.x, B.y - A.y, B.z - A.z, C.x - A.x, C.y - A.y,
               C.z - A.z, g[3][0], g[3][1], g[3][2]);
        float vol = 0.f;
        if (kLegacy)
          vol = (g[3][0] * (D.x - A.x) + g[3][1] * (D.y - A.y) +
                 g[3][2] * (D.z - A.z)) * sixth;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          g[k][0] = g[k][0] * sixth;
          g[k][1] = g[k][1] * sixth;
          g[k][2] = g[k][2] * sixth;
        }
        if (!kLegacy)
          vol = g[3][0] * (D.x - A.x) + g[3][1] * (D.y - A.y) +
                g[3][2] * (D.z - A.z);
        const float wsum =
            w.x * (g[0][0] * g[0][0] + g[0][1] * g[0][1] + g[0][2] * g[0][2]) +
            w.y * (g[1][0] * g[1][0] + g[1][1] * g[1][1] + g[1][2] * g[1][2]) +
            w.z * (g[2][0] * g[2][0] + g[2][1] * g[2][1] + g[2][2] * g[2][2]) +
            w.w * (g[3][0] * g[3][0] + g[3][1] * g[3][1] + g[3][2] * g[3][2]);
        const bool valid =
            ((w.x + w.y + w.z + w.w) != 0.f) && (wsum >= 1e-20f);
        const float cfn = vol - r;
        const float denom = wsum + al;
        float dlam = valid ? (-cfn - al * l) / (denom == 0.f ? 1.f : denom)
                           : 0.f;
        dlam = dlam * sc;
        l = l + dlam;
        if (split) {
          s[0] = s[1] = s[2] = s[3] = dlam;
        } else {
          s[0] = w.x * dlam;
          s[1] = w.y * dlam;
          s[2] = w.z * dlam;
          s[3] = w.w * dlam;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        corr[(k * 3 + 0) * kBlock + t] = g[k][0] * s[k];
        corr[(k * 3 + 1) * kBlock + t] = g[k][1] * s[k];
        corr[(k * 3 + 2) * kBlock + t] = g[k][2] * s[k];
      }
      __syncthreads();
      for (int u = u0 + t; u < u1; u += kBlock) {
        const int vid = cvert[u];
        float4 x = xw[vid];
        float sx = 0.f, sy = 0.f, sz = 0.f;
        const int e1 = cptr[u + 1];
        for (int e = cptr[u]; e < e1; ++e) {
          const int ent = centry[e];
          const int base = (ent & 3) * 3 * kBlock + (ent >> 2);
          float ax = corr[base];
          float ay = corr[base + kBlock];
          float az = corr[base + 2 * kBlock];
          if (split) {
            ax = ax * x.w;
            ay = ay * x.w;
            az = az * x.w;
          }
          sx = sx + ax;
          sy = sy + ay;
          sz = sz + az;
        }
        x.x = x.x + sx;
        x.y = x.y + sy;
        x.z = x.z + sz;
        xw[vid] = x;
      }
      __syncthreads();
    }
    if (live) lam[p] = l;
  }
}

template <int kBlock, bool kLegacy>
int launch_edge(void* xw, float* lam, const int* verts, const float* rest,
                const float* scale, const float* atab, const float* wsum,
                const int* blk_vptr, const int* cvert, const int* cptr,
                const int* centry, int nblocks, float alpha, int local_iters,
                void* stream) {
  if (nblocks > 0) {
    edge_sweep_kernel<kBlock, kLegacy>
        <<<1, kBlock, 0, (cudaStream_t)stream>>>(
            (float4*)xw, lam, (const int2*)verts, rest, scale, atab, wsum,
            blk_vptr, cvert, cptr, centry, nblocks, alpha, local_iters);
  }
  return (int)cudaGetLastError();
}

template <int kBlock, bool kLegacy>
int launch_tet(void* xw, float* lam, const int* verts, const float* rest,
               const float* scale, const float* atab, const float* wtab,
               const int* blk_vptr, const int* cvert, const int* cptr,
               const int* centry, int nblocks, float alpha, int local_iters,
               int ms, void* stream) {
  if (nblocks > 0) {
    auto kernel = tet_sweep_kernel<kBlock, kLegacy>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tet_smem<kBlock>());
    if (err != cudaSuccess) return (int)err;
    kernel<<<1, kBlock, tet_smem<kBlock>(), (cudaStream_t)stream>>>(
        (float4*)xw, lam, (const int4*)verts, rest, scale, atab,
        (const float4*)wtab, blk_vptr, cvert, cptr, centry, nblocks, alpha,
        local_iters, ms);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError() so that a
// refused launch is reported to the caller.
extern "C" {

int sbs_w_fill(const int* verts, const float* cnt, const void* xw,
               float* wout, int n, int arity, void* stream) {
  const int total = arity == 2 ? n : n * arity;
  if (total > 0) {
    const int threads = 256;
    w_fill_kernel<<<(total + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(
        verts, cnt, (const float4*)xw, wout, n, arity);
  }
  return (int)cudaGetLastError();
}

int sbs_edge_sweep(void* xw, float* lam, const int* verts, const float* rest,
                   const float* scale, const float* atab, const float* wsum,
                   const int* blk_vptr, const int* cvert, const int* cptr,
                   const int* centry, int nblocks, float alpha,
                   int local_iters, void* stream) {
  return launch_edge<kSuper, false>(xw, lam, verts, rest, scale, atab, wsum,
                                    blk_vptr, cvert, cptr, centry, nblocks,
                                    alpha, local_iters, stream);
}

int sbs_tet_sweep(void* xw, float* lam, const int* verts, const float* rest,
                  const float* scale, const float* atab, const float* wtab,
                  const int* blk_vptr, const int* cvert, const int* cptr,
                  const int* centry, int nblocks, float alpha,
                  int local_iters, int ms, void* stream) {
  return launch_tet<kSuper, false>(xw, lam, verts, rest, scale, atab, wtab,
                                   blk_vptr, cvert, cptr, centry, nblocks,
                                   alpha, local_iters, ms, stream);
}

int sbs_legacy_edge_sweep(void* xw, float* lam, const int* verts,
                          const float* rest, const float* scale,
                          const float* atab, const int* blk_vptr,
                          const int* cvert, const int* cptr,
                          const int* centry, int nblocks, float alpha,
                          void* stream) {
  return launch_edge<kLegacyWidth, true>(xw, lam, verts, rest, scale, atab,
                                    nullptr, blk_vptr, cvert, cptr, centry,
                                    nblocks, alpha, 1, stream);
}

int sbs_legacy_tet_sweep(void* xw, float* lam, const int* verts,
                         const float* rest, const float* scale,
                         const float* atab, const int* blk_vptr,
                         const int* cvert, const int* cptr, const int* centry,
                         int nblocks, float alpha, void* stream) {
  return launch_tet<kLegacyWidth, true>(xw, lam, verts, rest, scale, atab,
                                   nullptr, blk_vptr, cvert, cptr, centry,
                                   nblocks, alpha, 1, 0, stream);
}

}  // extern "C"
