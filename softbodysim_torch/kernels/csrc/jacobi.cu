// Jacobi-dialect constraint passes for Hopper (sm_90a): one gather+apply
// stage per constraint family, reading one frozen snapshot.
//
// Replaces the TPU kernels of softbodysim_tpu/kernels/jacobi.py:
//   tile_pass_kernel<2, *>  <- _edge_pass_kernel (:71, pallas_call :360;
//                              with _scatter_acc4 :44, _apply_epilogue :58)
//   tile_pass_kernel<4, *>  <- _tet_pass_kernel  (:158, pallas_call :360)
// and, in its <arity, true, false> variants run as the last pass of an
// iteration, softbodysim_tpu/kernels/collide.py::_collide_kernel (:136,
// pallas_call :220), which the JAX pass step calls once per iteration after
// both passes (softbodysim_tpu/solver/jacobi_pallas.py:187-203).  The
// <arity, false, true> variants are the same TPU kernels built with
// apply=False (make_jacobi_pass :421-461, FINAL = last and apply at :362):
// the accumulate-only mode of the kernel-sharded steps.
//
// Semantics (the reference's K_EdgeGather / K_VolumeGather -> K_ApplyDelta,
// and the JAX package's solver/jacobi.py segment formulation): every
// constraint reads the positions of the snapshot xin; per particle the
// contributions are summed into (delta, count) and applied as
// x_out = x_in + (omega / count) * delta for free particles with count > 0,
// else x_out = x_in.  The per-constraint arithmetic is the TPU kernels'
// (lambda = (-k * C) / w; the edge direction folded in as lambda / |d|; the
// tet gradients times the f32 sixth), so the kernels differ from the plain
// PyTorch versions (the segment formulation: -k * (C / w), d / |d|, a
// division by 6) by a few ulps, besides their order of summation.
//
// Design: owner computes, over spatial vertex tiles.  Pure Jacobi reads one
// snapshot, so there is no constraint order to keep (unlike the XPBD
// sweeps), only each vertex's summation order, which is fixed so that a
// pass gives the same bits on every launch (no atomics).  The host
// (kernels/jacobi_plan.py) cuts the vertices into spatial tiles of at most
// 256 owned vertices and lists, per tile, its referenced rows (owned, then
// the halo its constraints reach), every constraint with an owned corner
// (int16 local rows, and per corner the tile-local slot of its
// contribution or -1) and per owned vertex the end of its contiguous run
// of slots.  One CTA per tile, one launch per pass:
//   1. stage the tile's referenced rows of xin in shared memory;
//   2. compute each listed constraint once from shared memory and write its
//      owned corners' contributions (xyz, count flag) to their slots, also
//      in shared memory;
//   3. barrier; each owned vertex sums its run of slots in order, counts,
//      applies, and writes its row of xout (and its count).
// Nothing but xout (and cnt_out) goes to device memory.  The stiffness and
// the SOR factor are read from device memory at launch (a CUDA graph that
// captured the launch reads their current values on each replay).  The pass
// writes a second table (double buffering; the step swaps the two), never
// the one it reads.  Tables are in public vertex order: xw (V, 4) f32 rows
// x, y, z, inverse mass, so a row is one 16-byte load.
//
// Heavy vertices.  A vertex in more constraints than a tile's shared
// memory can hold as one run (the centre of a fan-tetrahedralised ball:
// 81,920 tets at tet_ball(6)) is owned by no tile.  Each of its
// contributions has its slot in one tile (the constraint's home), in one
// run per (tile, heavy vertex) after the owned runs; step 3 writes each
// such run's sum and count as a partial to a small device table.  Then
// every CTA fences and takes a ticket; the last one sums each heavy
// vertex's partials in tile order (L2 loads), applies, stores, and resets
// the ticket for the next launch (and for a graph's next replay).  Still
// no atomics on positions, and every sum in a fixed order.
//
// The accumulate-only mode (<arity, false, true>).  Where a pass would
// apply, it stores the row's sum and count instead, (sum x, sum y, sum z,
// count) as one float4, into a table of the rows of xin: the owned runs in
// step 3, the heavy vertices in the last CTA.  Every row of xin is owned by
// a tile or heavy, so every row of the table is written (a row in no
// constraint gets zeros).  The kernel-sharded Jacobi step
// (solver/jacobi_pass_sharded.py) runs it on a rank's own rows and the
// ghost copies of other ranks' rows, sends the ghost rows' sums home and
// applies there.  The same summation order as the apply mode, so the same
// bits on every launch.  It takes no collide stage (refused at build time:
// the stage runs after the apply, on the home rank).
//
// The fused collide stage (<arity, true, false>).  Each row of xout is written
// once, by one CTA, from registers; the collide stage is per row, so it
// runs there before the store: after apply_delta, each free row gets the
// ground plane and then the colliders in order (collide_math.cuh, the
// stand-alone collide kernel's code; the table staged in shared memory
// after the slots).  That saves the stand-alone kernel's read and write
// of the whole table and one launch per iteration.
//
// What bounds them.  The function moves, at 110,592 vertices / 642,960
// edges: snapshot 1.77 MB + edges 5.14 MB + rest 2.57 MB read, 1.77 MB
// written: 11.3 MB, 3.4 us at 3.35 TB/s; at 519,115 tets: snapshot 1.77 +
// tets 8.31 + rest 2.08 read, 1.77 written: 13.9 MB, 4.2 us.  This design
// reads instead its tile tables: a constraint touching several tiles is
// listed (and computed) in each (1.21x the edges, 1.46x the tets at 256
// owned vertices per tile), as an 8- or 16-byte record plus its rest, and
// the halo rows again per tile.  What holds it above those bounds is the
// SM's work per tile: per listed tet four 16-byte shared-memory gathers,
// ~150 flops and one 16-byte store per owned corner, then every slot read
// back in the sums (tools/profile_jacobi_phases.py, PERF.md).  Each thread
// loads its next record while it computes the current one.
//
// Build with --fmad=false: no contraction into FMA, as on the TPU and in the
// plain PyTorch versions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "collide_math.cuh"

namespace {

// Threads per CTA: 256 for the edge pass, 512 for the tet pass (a tet
// costs ~6x an edge; at 256 threads the tet pass ran 1.2x slower, at 512
// the edge pass 1.1x: tools/jacobi_tile_sizes.py, PERF.md).
__host__ __device__ constexpr int threads_of(int arity) { return arity == 4 ? 512 : 256; }

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

__device__ __forceinline__ void cross3(float ax, float ay, float az,
                                       float bx, float by, float bz,
                                       float& ox, float& oy, float& oz) {
  ox = ay * bz - az * by;
  oy = az * bx - ax * bz;
  oz = ax * by - ay * bx;
}

// One edge (a, b), record {row a, row b, slot a, slot b}, in the TPU
// kernel's arithmetic (_edge_pass_kernel):
//   w = w_a + w_b, d = x_a - x_b, valid: w != 0 and |d|^2 >= 1e-18;
//   lambda = (-k * (|d| - rest)) / w, s = d * (lambda / |d|);
//   a gets s * w_a, b gets -(s * w_b); both count when valid.
__device__ __forceinline__ void edge_visit(const float4* rows, float4* slots,
                                           short4 r, float rest, float k) {
  const float4 A = rows[r.x], B = rows[r.y];
  const float w = A.w + B.w;
  const float dx = A.x - B.x, dy = A.y - B.y, dz = A.z - B.z;
  const float len2 = dx * dx + dy * dy + dz * dz;
  const bool valid = w != 0.f && len2 >= 1e-18f;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (valid) {
    const float len = sqrtf(fmaxf(len2, 1e-30f));
    const float sl = ((-k * (len - rest)) / w) / len;
    sx = dx * sl;
    sy = dy * sl;
    sz = dz * sl;
  }
  const float flag = valid ? 1.f : 0.f;
  if (r.z >= 0) slots[r.z] = make_float4(sx * A.w, sy * A.w, sz * A.w, flag);
  if (r.w >= 0)
    slots[r.w] = make_float4(-(sx * B.w), -(sy * B.w), -(sz * B.w), flag);
}

// One tet (a, b, c, d), rows v and slots s, in the TPU kernel's arithmetic
// (_tet_pass_kernel; the f32 sixth multiplies, as there):
//   g_a = ((p_d - p_b) x (p_c - p_b)) * 1/6, g_b = ((p_c - p_a) x (p_d - p_a))
//   * 1/6, g_c = ((p_d - p_a) x (p_b - p_a)) * 1/6, g_d = ((p_b - p_a) x
//   (p_c - p_a)) * 1/6;
//   wsum = sum_r w_r |g_r|^2, valid: sum_r w_r != 0 and wsum >= 1e-20;
//   vol = g_d . (p_d - p_a); lambda = (-k * (vol - rest)) / wsum;
//   corner r gets g_r * (lambda * w_r), counted when valid and w_r != 0.
__device__ __forceinline__ void tet_visit(const float4* rows, float4* slots,
                                          short4 v, short4 s, float rest,
                                          float k) {
  constexpr float kSixth = 1.f / 6.f;
  const float4 A = rows[v.x], B = rows[v.y], C = rows[v.z], D = rows[v.w];
  const float dax = D.x - A.x, day = D.y - A.y, daz = D.z - A.z;
  float g[4][3];
  cross3(D.x - B.x, D.y - B.y, D.z - B.z, C.x - B.x, C.y - B.y, C.z - B.z,
         g[0][0], g[0][1], g[0][2]);
  cross3(C.x - A.x, C.y - A.y, C.z - A.z, dax, day, daz,
         g[1][0], g[1][1], g[1][2]);
  cross3(dax, day, daz, B.x - A.x, B.y - A.y, B.z - A.z,
         g[2][0], g[2][1], g[2][2]);
  cross3(B.x - A.x, B.y - A.y, B.z - A.z, C.x - A.x, C.y - A.y, C.z - A.z,
         g[3][0], g[3][1], g[3][2]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    g[r][0] = g[r][0] * kSixth;
    g[r][1] = g[r][1] * kSixth;
    g[r][2] = g[r][2] * kSixth;
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
    const float vol = g[3][0] * dax + g[3][1] * day + g[3][2] * daz;
    lam = (-k * (vol - rest)) / wsum;
  }
  const short dst[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (dst[r] >= 0) {
      const float sc = lam * w[r];
      slots[dst[r]] = make_float4(g[r][0] * sc, g[r][1] * sc, g[r][2] * sc,
                                  (valid && w[r] != 0.f) ? 1.f : 0.f);
    }
  }
}

// A family's heavy vertices (kernels/jacobi_plan.py): per tile its heavy
// runs [part_ptr[t], part_ptr[t + 1]), each one's end in the tile's slots
// and the partial it sums into (part_dst); per heavy vertex (verts,
// ascending) its partials, contiguous in tile order: partials[vptr[j] ..
// vptr[j + 1]).  partials: (P,) float4 scratch (xyz sum, count); ticket:
// one counter, 0 between launches.
struct Heavy {
  const int* part_ptr;
  const short* part_end;
  const int* part_dst;
  float4* partials;
  const int* verts;
  const int* vptr;
  int n;
  unsigned* ticket;
};

// A run of slots [s0, s1) summed in order: (xyz, count of flagged slots).
__device__ __forceinline__ float4 run_sum(const float4* slots, int s0,
                                          int s1) {
  float sx = 0.f, sy = 0.f, sz = 0.f;
  int cnt = 0;
#pragma unroll 4
  for (int s = s0; s < s1; ++s) {
    const float4 v = slots[s];
    sx = sx + v.x;
    sy = sy + v.y;
    sz = sz + v.z;
    cnt += v.w != 0.f ? 1 : 0;
  }
  return make_float4(sx, sy, sz, (float)cnt);
}

// One CTA per tile t.  Shared memory: the tile's referenced rows, then its
// slots (the owned runs, then the heavy runs); from float4 smem4 on (the
// plan's smem_bytes / 16) the collider table (kCollide).  rec: per listed
// constraint one short4 (edges: rows a, b, slots a, b) or two (tets:
// rows, then slots); rest / ktab per listed constraint.  kCollide: each
// row this launch writes gets the collide stage (ground, then the ncols
// colliders of cols) before its store.  kAccumulate: xout is the table of
// sums and counts, and nothing is applied (omegap and cnt_out unread).
template <int kArity, bool kCollide, bool kAccumulate>
__global__ void __launch_bounds__(threads_of(kArity))
tile_pass_kernel(const float4* __restrict__ xin, float4* __restrict__ xout,
                 const int* __restrict__ row_ptr,
                 const int* __restrict__ rows,
                 const int* __restrict__ own_ptr,
                 const short* __restrict__ slot_end,
                 const int* __restrict__ con_ptr,
                 const short4* __restrict__ rec,
                 const float* __restrict__ rest,
                 const float* __restrict__ ktab,
                 const float* __restrict__ kp,
                 const float* __restrict__ omegap,
                 int* __restrict__ cnt_out, int smem4, Heavy hv,
                 const float* __restrict__ cols, int ncols, Ground ground) {
  static_assert(!(kCollide && kAccumulate),
                "the accumulate-only mode has no collide stage");
  constexpr int kThreads = threads_of(kArity);
  const float k = *kp, omega = kAccumulate ? 0.f : *omegap;
  constexpr int kRec = kArity / 2;            // short4 per record
  extern __shared__ float4 smem[];
  const int t = blockIdx.x;
  const int r0 = row_ptr[t], nr = row_ptr[t + 1] - r0;
  const int o0 = own_ptr[t], no = own_ptr[t + 1] - o0;
  const int c0 = con_ptr[t], c1 = con_ptr[t + 1];
  const int p0 = hv.part_ptr[t], nparts = hv.part_ptr[t + 1] - p0;
  const int nown = no > 0 ? (int)slot_end[o0 + no - 1] : 0;
  float4* srows = smem;
  float4* slots = smem + nr;
  float* tab = reinterpret_cast<float*>(smem + smem4);

  if (kCollide)            // first: its loads overlap the rows' loads
    for (int q = threadIdx.x; q < ncols * 12; q += kThreads) tab[q] = cols[q];
  for (int r = threadIdx.x; r < nr; r += kThreads)
    srows[r] = xin[rows[r0 + r]];
  __syncthreads();

  // each thread's constraints, its next record loaded ahead of the visit
  short4 nr0 = {}, nr1 = {};
  float nrest = 0.f, nk = k;
  auto load_record = [&](int c) {
    nr0 = rec[kRec * c];
    if (kRec == 2) nr1 = rec[kRec * c + 1];
    nrest = rest[c];
    if (ktab != nullptr) nk = ktab[c] * k;
  };
  int c = c0 + threadIdx.x;
  if (c < c1) load_record(c);
  while (c < c1) {
    const short4 v0 = nr0, v1 = nr1;
    const float rs = nrest, kk = nk;
    c += kThreads;
    if (c < c1) load_record(c);
    if (kArity == 2) {
      edge_visit(srows, slots, v0, rs, kk);
    } else {
      tet_visit(srows, slots, v0, v1, rs, kk);
    }
  }
  __syncthreads();

  // the owned runs: sum, apply (and collide), store; then the heavy runs:
  // one partial each
  for (int o = threadIdx.x; o < no + nparts; o += kThreads) {
    if (o < no) {
      const int s0 = o > 0 ? (int)slot_end[o0 + o - 1] : 0;
      const float4 d = run_sum(slots, s0, slot_end[o0 + o]);
      const int cnt = (int)d.w;
      const int g = rows[r0 + o];
      if (kAccumulate) {
        xout[g] = d;
        continue;
      }
      float4 out = apply_delta(srows[o], d.x, d.y, d.z, cnt, omega);
      if (kCollide) out = collide_row(out, ground, tab, ncols);
      xout[g] = out;
      if (cnt_out != nullptr) cnt_out[g] = cnt;
    } else {
      const int j = o - no;
      const int s0 = j > 0 ? (int)hv.part_end[p0 + j - 1] : nown;
      hv.partials[hv.part_dst[p0 + j]] =
          run_sum(slots, s0, hv.part_end[p0 + j]);
    }
  }
  if (hv.n == 0) return;

  // the launch's last CTA to finish sums each heavy vertex's partials in
  // tile order and applies (every CTA's partials are visible to it: each
  // thread fences its stores before its CTA takes a ticket).  Thread j
  // takes heavy vertex j0 + j.  The partials pass through the first smem4
  // float4 of shared memory (the rows and slots, no longer read), a chunk
  // at a time, all of the CTA's threads loading a chunk at once from L2:
  // one thread loading a vertex's partials one by one would wait on L2
  // for each (~57 us for tet_ball(6)'s 256 partials on the H100).
  __threadfence();
  __syncthreads();
  const bool last = __syncthreads_or(
      threadIdx.x == 0 && atomicAdd(hv.ticket, 1u) == gridDim.x - 1);
  if (!last) return;
  __threadfence();
  for (int j0 = 0; j0 < hv.n; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const int q0 = hv.vptr[j0], q1 = hv.vptr[min(hv.n, j0 + kThreads)];
    const int m0 = j < hv.n ? hv.vptr[j] : 0;
    const int m1 = j < hv.n ? hv.vptr[j + 1] : 0;
    float sx = 0.f, sy = 0.f, sz = 0.f;
    int cnt = 0;
    for (int c0 = q0; c0 < q1; c0 += smem4) {
      const int c1 = min(q1, c0 + smem4);
      __syncthreads();                  // the last chunk is summed
      for (int q = c0 + threadIdx.x; q < c1; q += kThreads)
        smem[q - c0] = __ldcg(hv.partials + q);
      __syncthreads();
#pragma unroll 4
      for (int q = max(m0, c0); q < min(m1, c1); ++q) {
        const float4 v = smem[q - c0];
        sx = sx + v.x;
        sy = sy + v.y;
        sz = sz + v.z;
        cnt += (int)v.w;
      }
    }
    if (j < hv.n) {
      const int g = hv.verts[j];
      if (kAccumulate) {
        xout[g] = make_float4(sx, sy, sz, (float)cnt);
      } else {
        float4 out = apply_delta(xin[g], sx, sy, sz, cnt, omega);
        if (kCollide) out = collide_row(out, ground, tab, ncols);
        xout[g] = out;
        if (cnt_out != nullptr) cnt_out[g] = cnt;
      }
    }
  }
  if (threadIdx.x == 0) *hv.ticket = 0u;       // ready for the next launch
}

using PassKernel = void (*)(const float4*, float4*, const int*, const int*,
                            const int*, const short*, const int*,
                            const short4*, const float*, const float*,
                            const float*, const float*, int*, int, Heavy,
                            const float*, int, Ground);

// A variant's index: arity * 4 + collide + 2 * accumulate.
constexpr int variant(int arity, bool collide, bool accumulate) {
  return arity * 4 + (collide ? 1 : 0) + (accumulate ? 2 : 0);
}

// nullptr for a variant that does not exist (accumulate with collide).
PassKernel kernel_of(int arity, bool collide, bool accumulate) {
  switch (variant(arity, collide, accumulate)) {
    case variant(2, false, false): return tile_pass_kernel<2, false, false>;
    case variant(2, true, false): return tile_pass_kernel<2, true, false>;
    case variant(2, false, true): return tile_pass_kernel<2, false, true>;
    case variant(4, false, false): return tile_pass_kernel<4, false, false>;
    case variant(4, true, false): return tile_pass_kernel<4, true, false>;
    case variant(4, false, true): return tile_pass_kernel<4, false, true>;
    default: return nullptr;
  }
}

// Allow the kernel the card's whole opt-in shared memory, once per
// variant.
cudaError_t opt_in(int arity, bool collide, bool accumulate) {
  static bool done[variant(4, true, true) + 1] = {};
  const int v = variant(arity, collide, accumulate);
  if (done[v]) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel_of(arity, collide, accumulate),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  done[v] = err == cudaSuccess;
  return err;
}

}  // namespace

// Plain C entry points (bound with ctypes).
extern "C" {

// CTAs of the pass kernel of this arity (without the collide stage) that
// one SM holds at once with smem bytes of shared memory each (0: not even
// one); a negative CUDA error code on failure.
int sbs_jacobi_ctas_per_sm(int arity, int smem) {
  if (kernel_of(arity, false, false) == nullptr)
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = opt_in(arity, false, false);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_of(arity, false, false), threads_of(arity), smem);
  return err == cudaSuccess ? per_sm : -(int)err;
}

// One pass: one CTA of threads_of(arity) threads per tile, smem bytes of
// dynamic shared memory (the plan's largest tile); k and omega point to one
// f32 each in device memory.  The heavy tables (nheavy may be 0) as in
// struct Heavy.  cols != nullptr: the collide stage is fused into the pass
// (ncols rows of 12 f32, staged from byte smem on: smem + 48 * ncols
// bytes in all; the ground plane as given).  accumulate != 0: the
// accumulate-only mode, xout the (rows, 4) table of sums and counts (omega
// and cnt_out unread; refused with cols).  Launches on the given stream,
// does not synchronise, and returns cudaGetLastError() so that a refused
// launch is reported to the caller.
int sbs_jacobi_pass(int arity, const void* xin, void* xout,
                    const int* row_ptr, const int* rows, const int* own_ptr,
                    const short* slot_end, const int* con_ptr,
                    const void* rec, const float* rest, const float* ktab,
                    int ntiles, int smem, const float* k,
                    const float* omega, int* cnt_out, const int* part_ptr,
                    const short* part_end, const int* part_dst,
                    void* partials, const int* heavy, const int* heavy_ptr,
                    int nheavy, unsigned* ticket, const float* cols, int ncols,
                    int ground_on, float gpx, float gpy, float gpz,
                    float gnx, float gny, float gnz, float r, int accumulate,
                    void* stream) {
  const bool collide = cols != nullptr;
  PassKernel kernel = kernel_of(arity, collide, accumulate != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = opt_in(arity, collide, accumulate != 0);
  if (err != cudaSuccess) return (int)err;
  const Heavy hv = {part_ptr, part_end, part_dst, (float4*)partials,
                    heavy, heavy_ptr, nheavy, ticket};
  const Ground g = {ground_on, gpx, gpy, gpz, gnx, gny, gnz, r};
  const int smem4 = smem / 16;
  if (collide) smem += ncols * 12 * (int)sizeof(float);
  if (ntiles > 0) {
    kernel<<<ntiles, threads_of(arity), smem, (cudaStream_t)stream>>>(
        (const float4*)xin, (float4*)xout, row_ptr, rows, own_ptr, slot_end,
        con_ptr, (const short4*)rec, rest, ktab, k, omega, cnt_out, smem4,
        hv, cols, collide ? ncols : 0, g);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
