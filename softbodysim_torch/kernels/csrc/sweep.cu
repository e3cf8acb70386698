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
// The w fill and the super-block sweeps are instantiated on both particle
// tables of the JAX kernels (rows.cuh): float32, and bfloat16 -- the
// x_dtype=bfloat16 mode of make_sweep (sweep.py:1591), which upcasts
// every read (_gather_xyz :1083, _gather_w :1104, the per-target w at
// :1242 and :1354) and rounds each window's read-modify-write back on the
// store (_scatter_super :1151-1166).  The legacy sweeps take the f32 table
// only, as the JAX legacy kernels (sweep.py:1648-1652).
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
// -- so a row is one 16-byte load; at the north-star size it is 1.7 MB and
// stays in L2 (the bf16 table: one 8-byte row, 0.9 MB).  What bounds a
// sweep is latency, not bytes or FLOPs: each
// block is a short chain of dependent steps, and the plan order allows
// little parallelism (north star: 744 edge blocks in 626 dependency
// levels, 584 tet blocks in 110).  So:
//   * Schedule (host, sweep_plan.stage_plan).  Blocks that share no vertex
//     commute exactly, so the plan order is kept as a dependency order: a
//     block waits only for its predecessors (for each of its vertices the
//     last earlier block touching it).  The non-empty blocks are dealt to
//     Q queues, each in plan order, one persistent CTA per queue
//     (cooperative launch: all CTAs co-resident, so waiting cannot
//     deadlock).  Every block reads bit for bit what it reads in plan
//     order and sums every row in the same order: the result equals one
//     CTA walking the plan, whatever Q.
//   * Per block, a CTA (one thread per constraint lane) does:
//     A. wait: warp 0 polls (ld.acquire.gpu) the flag of each predecessor
//        on another queue until it holds this launch's epoch;
//     B. load the block's unique rows xw[cvert[u]] once into shared memory
//        with L2-only loads (__ldcg: L1 is not coherent across SMs);
//     C. each lane reads its corners from the shared rows through its
//        block-local row ids (lrow), computes dlambda, updates lambda (kept
//        in a register across the K in-block revisits) and writes its
//        per-role corrections to shared memory; __syncthreads;
//     D. one thread per row walks the row's entries (each (lane, role)
//        once, ascending: a fixed sum order, no atomics), adds the sum to
//        the shared row -- and on the last visit writes it to xw; on the
//        bf16 table the row rounds through bf16 after every visit (the
//        JAX kernel's per-visit store), so a revisit reads rounded
//        positions, as the JAX kernel's gathers read its table; then
//        __syncthreads, and if another queue waits for the block, one
//        thread publishes it (st.release.gpu of the flag).
//     The position-independent part of a block (lrow, lambda, rest, scale,
//     atab, the w table, and a record of its waits and CSR) is contiguous
//     in the plan; the CTA's last thread stages it into shared memory with
//     1-D bulk copies (cp.async.bulk, completing on an mbarrier) one block
//     ahead (two stages; one when two do not fit), while the other threads
//     load the current block's rows.  A block without waits starts without
//     a barrier (the block before ended on one).  The chain of a block is
//     then: wait -> one L2 round trip for its rows -> compute -> barrier ->
//     apply and write -> barrier -> release.
//   * What bounds it now (tools/profile_sweep_phases.py, per block on the
//     H100): the chain itself, ~2.5 us per super edge block and ~4 us per
//     super tet block, of which the visit and the apply are ~55% (1024
//     lanes' arithmetic on one SM's four schedulers) and the row round
//     trip ~17%; the edge plan is nearly serial (626 levels of 744), so
//     the edge sweep gains little from the schedule.
//   * A wait or a staged copy that does not complete within 2 s marks the
//     launch aborted (a per-plan word all waits poll), sets a word in
//     mapped host memory and ends the CTA; the wrapper raises on it.
//
// Build with --fmad=false: the products and sums are rounded as in the
// plain PyTorch versions and the JAX kernels (no contraction into FMA).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kSuper = 1024;     // constraints per super-block == CTA size
constexpr int kLegacyWidth = 128;  // constraints per legacy block == CTA size
constexpr int kRecHeader = 8;    // block, rows, entries, waits, release, pad
constexpr unsigned long long kTimeoutNs = 2000000000ull;

// The launch's arguments (mirrored by kernels/sweep.py::_SweepArgs).
struct SweepArgs {
  void* xw;              // (Vpad, 4) rows of the kernel's Row type
  float* lam;
  const short* lrow;     // (NB*W, arity) block-local row per (lane, role)
  const float* rest;
  const float* scale;
  const float* atab;     // per-lane compliance factor, or null
  const float* wt;       // wsum (NB*W,) / wtab (NB*W, 4); null at width 128
  const int* rec;        // per queue position: header, waits, CSR
  const int4* qinfo;     // per queue position: block, rec offset, rec ints
  const int* qptr;       // (nqueues + 1,) queue -> positions
  int* flags;            // (NB + 1,) release epoch per block; [NB] abort
  int* timeouts;         // the plan's timed-out word, pinned host
  int nqueues;
  int nblocks;
  int max_rows;
  int max_rec;
  int nstages;
  int epoch;
  float alpha;
  int local_iters;
  int ms;
};

// Shared memory: two mbarriers, nstages stages, the block's rows, the
// per-role corrections.
struct Layout {
  int lrow, lam, rest, scale, atab, wt, rec, stage;   // inside a stage
  int stages, srow, corr, total;
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

template <int kBlock, int kArity, bool kLegacy>
__host__ __device__ Layout make_layout(bool atab, int max_rows, int max_rec,
                                       int nstages) {
  Layout L{};
  int o = 0;
  L.lrow = o;
  o += align16(kBlock * kArity * 2);
  L.lam = o;
  o += kBlock * 4;
  L.rest = o;
  o += kBlock * 4;
  L.scale = o;
  o += kBlock * 4;
  L.atab = o;
  if (atab) o += kBlock * 4;
  L.wt = o;
  if (!kLegacy) o += kBlock * 4 * (kArity == 2 ? 1 : 4);
  L.rec = o;
  o += max_rec * 4;
  L.stage = align16(o);
  L.stages = 16;
  L.srow = L.stages + nstages * L.stage;
  L.corr = L.srow + align16(max_rows * 16);
  L.total = L.corr + (kArity == 2 ? 3 : 12) * kBlock * 4;
  return L;
}

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// flag value v was released in launch `epoch` (or a later one: the
// difference, not the values, so that the counter may wrap)
__device__ __forceinline__ bool released(int v, int epoch) {
  return (int)((unsigned)v - (unsigned)epoch) >= 0;
}

// ---- the families: per-lane work and per-row apply ------------------------

__device__ __forceinline__ void cross3(float ax, float ay, float az,
                                       float bx, float by, float bz,
                                       float& ox, float& oy, float& oz) {
  ox = ay * bz - az * by;
  oy = az * bx - ax * bz;
  oz = ax * by - ay * bx;
}

// XPBD distance constraint.  Per live lane: C = |d| - rest,
// dlambda = (-C - a*lambda) / (wsum + a) (wsum streamed from w_fill, or
// w0 + w1 off the rows when kLegacy; guards wsum != 0 and |d| >= 1e-12),
// times the lane's scale; lambda += dlambda.  Corrections: +n*dlambda*w to
// role 0, -n*dlambda*w to role 1, w the plain inverse mass of the target
// vertex.
template <int kBlock, bool kLegacy>
struct EdgeLane {
  static constexpr int kArity = 2;
  static constexpr bool kIsLegacy = kLegacy;
  short2 lr;
  bool live;
  float l, ws, r, sc, al;

  __device__ void load(const unsigned char* st, const Layout& L,
                       const SweepArgs& a, int t) {
    lr = reinterpret_cast<const short2*>(st + L.lrow)[t];
    live = lr.x >= 0;
    l = ws = r = sc = 0.f;
    al = a.alpha;
    if (live) {
      l = reinterpret_cast<const float*>(st + L.lam)[t];
      if (!kLegacy) ws = reinterpret_cast<const float*>(st + L.wt)[t];
      r = reinterpret_cast<const float*>(st + L.rest)[t];
      sc = reinterpret_cast<const float*>(st + L.scale)[t];
      if (a.atab != nullptr)
        al = a.alpha * reinterpret_cast<const float*>(st + L.atab)[t];
    }
  }

  __device__ void visit(const float4* rows, float* corr, int t) {
    float cx = 0.f, cy = 0.f, cz = 0.f;
    if (live) {
      const float4 a0 = rows[lr.x];
      const float4 a1 = rows[lr.y];
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
  }

  __device__ static void apply(float4& x, const int* ent, int e0, int e1,
                               const float* corr, int) {
    float sx = 0.f, sy = 0.f, sz = 0.f;
    for (int e = e0; e < e1; ++e) {
      const int en = ent[e];
      const int lane = en >> 2;
      const float f = (en & 3) == 0 ? x.w : -x.w;
      sx = sx + corr[lane] * f;
      sy = sy + corr[kBlock + lane] * f;
      sz = sz + corr[2 * kBlock + lane] * f;
    }
    x.x = x.x + sx;
    x.y = x.y + sy;
    x.z = x.z + sz;
  }
};

// XPBD volume constraint.  g_r = cross/6, wsum = sum_r w_r |g_r|^2 with
// the streamed (count-inflated under split) w_r, or the rows' w_r when
// kLegacy; guards sum w_r != 0 and wsum >= 1e-20; the same dlambda and
// lambda update as the edge sweep.  Corrections: g_r * dlambda * w_target
// under split (ms != 0, mass splitting applies the plain w of the target),
// else g_r * (w_r * dlambda).
template <int kBlock, bool kLegacy>
struct TetLane {
  static constexpr int kArity = 4;
  static constexpr bool kIsLegacy = kLegacy;
  short4 lr;
  bool live, split;
  float l, r, sc, al;
  float4 w;

  __device__ void load(const unsigned char* st, const Layout& L,
                       const SweepArgs& a, int t) {
    lr = reinterpret_cast<const short4*>(st + L.lrow)[t];
    live = lr.x >= 0;
    split = !kLegacy && a.ms;
    l = r = sc = 0.f;
    al = a.alpha;
    w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      l = reinterpret_cast<const float*>(st + L.lam)[t];
      r = reinterpret_cast<const float*>(st + L.rest)[t];
      sc = reinterpret_cast<const float*>(st + L.scale)[t];
      if (!kLegacy) w = reinterpret_cast<const float4*>(st + L.wt)[t];
      if (a.atab != nullptr)
        al = a.alpha * reinterpret_cast<const float*>(st + L.atab)[t];
    }
  }

  __device__ void visit(const float4* rows, float* corr, int t) {
    const float sixth = (float)(1.0 / 6.0);
    float g[4][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f},
                     {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      const float4 A = rows[lr.x], B = rows[lr.y], C = rows[lr.z],
                   D = rows[lr.w];
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
  }

  __device__ static void apply(float4& x, const int* ent, int e0, int e1,
                               const float* corr, int ms) {
    const bool split = !kLegacy && ms;
    float sx = 0.f, sy = 0.f, sz = 0.f;
    for (int e = e0; e < e1; ++e) {
      const int en = ent[e];
      const int base = (en & 3) * 3 * kBlock + (en >> 2);
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
  }
};

// ---- the persistent queue walk --------------------------------------------

// Stage one block (queue position info = block, rec offset, rec ints) into
// stage s; one thread.
template <int kBlock, class Lane>
__device__ void issue(const SweepArgs& a, const Layout& L,
                      unsigned char* smem, int4 info, int s) {
  constexpr int kArity = Lane::kArity;
  unsigned char* st = smem + L.stages + s * L.stage;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + s;
  const size_t p0 = (size_t)info.x * kBlock;
  const uint32_t lane_bytes = kBlock * 4;
  const uint32_t lrow_bytes = kBlock * kArity * 2;
  const uint32_t wt_bytes =
      Lane::kIsLegacy ? 0 : lane_bytes * (kArity == 2 ? 1 : 4);
  const uint32_t rec_bytes = (uint32_t)info.z * 4;
  const uint32_t total = lrow_bytes + 3 * lane_bytes + wt_bytes + rec_bytes +
                         (a.atab != nullptr ? lane_bytes : 0);
  mbar_expect_tx(bar, total);
  bulk_copy(st + L.lrow, a.lrow + p0 * kArity, lrow_bytes, bar);
  bulk_copy(st + L.lam, a.lam + p0, lane_bytes, bar);
  bulk_copy(st + L.rest, a.rest + p0, lane_bytes, bar);
  bulk_copy(st + L.scale, a.scale + p0, lane_bytes, bar);
  if (a.atab != nullptr) bulk_copy(st + L.atab, a.atab + p0, lane_bytes, bar);
  if (!Lane::kIsLegacy)
    bulk_copy(st + L.wt, a.wt + p0 * (kArity == 2 ? 1 : 4), wt_bytes, bar);
  bulk_copy(st + L.rec, a.rec + info.y, rec_bytes, bar);
}

__device__ bool wait_stage(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return true;
  const unsigned long long t0 = now_ns();
  while (!mbar_try_wait(bar, parity))
    if (now_ns() - t0 > kTimeoutNs) return false;
  return true;
}

// Warp 0: poll the flags of the block's waits (lane j takes j, j + 32, ...).
__device__ bool wait_blocks(const SweepArgs& a, const int* waits, int nw,
                            int lane) {
  for (int j = lane; j < nw; j += 32) {
    const int* f = a.flags + waits[j];
    if (released(ld_acquire(f), a.epoch)) continue;
    const unsigned long long t0 = now_ns();
    while (!released(ld_acquire(f), a.epoch)) {
      if (ld_relaxed(a.flags + a.nblocks) == a.epoch) return false;
      if (now_ns() - t0 > kTimeoutNs) return false;
    }
  }
  return true;
}

// Mark the launch aborted (every wait of every CTA gives up) and tell the
// host.
__device__ void abort_launch(const SweepArgs& a) {
  st_relaxed(a.flags + a.nblocks, a.epoch);
  *reinterpret_cast<volatile int*>(a.timeouts) = 1;
  __threadfence_system();
}

template <int kBlock, class Lane, class Row>
__device__ void run_queue(const SweepArgs& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout<kBlock, Lane::kArity, Lane::kIsLegacy>(
      a.atab != nullptr, a.max_rows, a.max_rec, a.nstages);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float4* rows = reinterpret_cast<float4*>(smem + L.srow);
  float* corr = reinterpret_cast<float*>(smem + L.corr);
  typename Row::T* xw = static_cast<typename Row::T*>(a.xw);
  const int t = threadIdx.x;
  const int i0 = a.qptr[blockIdx.x];
  const int n = a.qptr[blockIdx.x + 1] - i0;
  const int ns = a.nstages;
  if (t == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the last thread (rarely one with a row to load, never the poller)
  // stages ns - 1 blocks ahead; `next` is the next one to stage
  constexpr int kStager = kBlock - 1;
  int4 next = make_int4(0, 0, 0, 0);
  if (t == kStager) {
    if (ns == 2 && n > 0) issue<kBlock, Lane>(a, L, smem, a.qinfo[i0], 0);
    if (ns - 1 < n) next = a.qinfo[i0 + ns - 1];
  }
  for (int k = 0; k < n; ++k) {
    const int s = k % ns;
    if (t == kStager && k + ns - 1 < n) {
      // the stage was last read by the block before, which ended on a
      // barrier
      issue<kBlock, Lane>(a, L, smem, next, (k + ns - 1) % ns);
      if (k + ns < n) next = a.qinfo[i0 + k + ns];
    }
    const unsigned char* st = smem + L.stages + s * L.stage;
    // every thread times out on a stage that never lands, at about the
    // same time (it never does unless the plan and the copies disagree)
    if (!wait_stage(&bars[s], (uint32_t)((k / ns) & 1))) {
      if (t == 0) abort_launch(a);
      return;
    }
    const int* rec = reinterpret_cast<const int*>(st + L.rec);
    const int nw = rec[3];
    // the block before on this queue ended on a barrier: only waits on
    // other queues need one more
    if (nw > 0) {
      const bool ok = t >= 32 || wait_blocks(a, rec + kRecHeader, nw, t);
      if (__syncthreads_or(!ok)) {
        if (t == 0) abort_launch(a);
        return;
      }
    }
    // the stage is refilled once the stager passes the block's last
    // barrier: read the header before it
    const int b = rec[0], nu = rec[1], release = rec[4];
    const int* cvert = rec + kRecHeader + ((nw + 3) & ~3);
    const int* rptr = cvert + ((nu + 3) & ~3);
    const int* ent = rptr + ((nu + 4) & ~3);
    for (int u = t; u < nu; u += kBlock) rows[u] = Row::load_cg(xw, cvert[u]);
    Lane lane;
    lane.load(st, L, a, t);
    __syncthreads();
    for (int rep = 0; rep < a.local_iters; ++rep) {
      const bool last = rep + 1 == a.local_iters;
      lane.visit(rows, corr, t);
      __syncthreads();
      for (int u = t; u < nu; u += kBlock) {
        float4 x = rows[u];
        Lane::apply(x, ent, rptr[u], rptr[u + 1], corr, a.ms);
        if (last)
          Row::store_cg(xw, cvert[u], x);
        else
          rows[u] = Row::round(x);
      }
      __syncthreads();
    }
    if (lane.live) a.lam[(size_t)b * kBlock + t] = lane.l;
    // a thread of another warp than the poller publishes the block
    if (release && t == kStager) st_release(a.flags + b, a.epoch);
  }
}

template <int kBlock, bool kLegacy, class Row = RowF32>
__global__ void __launch_bounds__(kBlock, 1)
edge_sweep_kernel(const SweepArgs a) {
  run_queue<kBlock, EdgeLane<kBlock, kLegacy>, Row>(a);
}

template <int kBlock, bool kLegacy, class Row = RowF32>
__global__ void __launch_bounds__(kBlock, 1)
tet_sweep_kernel(const SweepArgs a) {
  run_queue<kBlock, TetLane<kBlock, kLegacy>, Row>(a);
}

// One thread per output value.  Edges (arity 2): wsum[p] = c0*w0 + c1*w1.
// Tets (arity 4): w[p, r] = c_r * w_r.  Pad lanes (vertex -1) get w = 0.
// The counts are the within-block multiplicities under the split scheme
// (mass splitting) and ones under the scale scheme.  The output is f32 on
// either table (the w read upcast, as _gather_w does).
template <class Row>
__global__ void w_fill_kernel(const int* __restrict__ verts,
                              const float* __restrict__ cnt,
                              const typename Row::T* __restrict__ xw,
                              float* __restrict__ wout, int n, int arity) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (arity == 2) {
    if (i >= n) return;
    const int v0 = verts[2 * i], v1 = verts[2 * i + 1];
    const float w0 = v0 >= 0 ? Row::load(xw, v0).w : 0.f;
    const float w1 = v1 >= 0 ? Row::load(xw, v1).w : 0.f;
    wout[i] = w0 * cnt[2 * i] + w1 * cnt[2 * i + 1];
  } else {
    if (i >= n * arity) return;
    const int v = verts[i];
    const float w = v >= 0 ? Row::load(xw, v).w : 0.f;
    wout[i] = w * cnt[i];
  }
}

// ---- host side ------------------------------------------------------------

// kinds: 0 edge_sweep, 1 tet_sweep, 2 legacy_edge_sweep, 3 legacy_tet_sweep
// (the f32 table); 4 edge_sweep, 5 tet_sweep on the bf16 table
constexpr int kKinds = 6;

const void* kernel_of(int kind) {
  switch (kind) {
    case 0: return (const void*)edge_sweep_kernel<kSuper, false>;
    case 1: return (const void*)tet_sweep_kernel<kSuper, false>;
    case 2: return (const void*)edge_sweep_kernel<kLegacyWidth, true>;
    case 3: return (const void*)tet_sweep_kernel<kLegacyWidth, true>;
    case 4: return (const void*)edge_sweep_kernel<kSuper, false, RowBF16>;
    case 5: return (const void*)tet_sweep_kernel<kSuper, false, RowBF16>;
  }
  return nullptr;
}

int threads_of(int kind) {
  return kind == 2 || kind == 3 ? kLegacyWidth : kSuper;
}

// the shared rows are f32 on either table: one layout per family and width
int smem_of(int kind, bool atab, int max_rows, int max_rec, int nstages) {
  switch (kind) {
    case 0:
    case 4: return make_layout<kSuper, 2, false>(atab, max_rows, max_rec,
                                                 nstages).total;
    case 1:
    case 5: return make_layout<kSuper, 4, false>(atab, max_rows, max_rec,
                                                 nstages).total;
    case 2: return make_layout<kLegacyWidth, 2, true>(atab, max_rows,
                                                      max_rec, nstages).total;
    case 3: return make_layout<kLegacyWidth, 4, true>(atab, max_rows,
                                                      max_rec, nstages).total;
  }
  return 0;
}

// Opt each sweep kernel in to the device's largest dynamic shared memory,
// once per process.
cudaError_t opt_in(int kind) {
  static bool done[kKinds] = {};
  if (done[kind]) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel_of(kind),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  done[kind] = err == cudaSuccess;
  return err;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on the given
// stream, does not synchronise, and returns a CUDA error code (0 when the
// launch was accepted) so that a refused launch is reported to the caller.
extern "C" {

// bf16: 0 the f32 table (float4 rows), 1 the bf16 table (8-byte rows)
int sbs_w_fill(const int* verts, const float* cnt, const void* xw,
               float* wout, int n, int arity, int bf16, void* stream) {
  const int total = arity == 2 ? n : n * arity;
  if (total > 0) {
    const int threads = 256;
    const int blocks = (total + threads - 1) / threads;
    if (bf16)
      w_fill_kernel<RowBF16><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          verts, cnt, (const RowBF16::T*)xw, wout, n, arity);
    else
      w_fill_kernel<RowF32><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          verts, cnt, (const RowF32::T*)xw, wout, n, arity);
  }
  return (int)cudaGetLastError();
}

// How many CTAs of sweep `kind` can be co-resident on the current device
// for a plan staging at most max_rows rows and max_rec record ints per
// block (SMs x CTAs per SM, from the occupancy API), the stages that fit
// (2, else 1) in *nstages and a CTA's shared memory in *smem.  0 when not
// even one stage fits; a negative CUDA error code on failure.
int sbs_sweep_ctas(int kind, int has_atab, int max_rows, int max_rec,
                   int* nstages, int* smem) {
  if (kernel_of(kind) == nullptr) return -(int)cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = opt_in(kind);
  if (err != cudaSuccess) return -(int)err;
  int ns = 2;
  if (smem_of(kind, has_atab, max_rows, max_rec, ns) > optin) ns = 1;
  const int bytes = smem_of(kind, has_atab, max_rows, max_rec, ns);
  if (bytes > optin) return 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_of(kind), threads_of(kind), bytes);
  if (err != cudaSuccess) return -(int)err;
  *nstages = ns;
  *smem = bytes;
  return per_sm * sms;
}

// One sweep: a cooperative launch of args->nqueues CTAs (refused, not
// hung, if they cannot all be co-resident).
int sbs_sweep(int kind, const void* args, void* stream) {
  SweepArgs a = *static_cast<const SweepArgs*>(args);
  if (kernel_of(kind) == nullptr) return (int)cudaErrorInvalidValue;
  if (a.nqueues <= 0) return 0;
  if (a.timeouts == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in(kind);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      kernel_of(kind), dim3(a.nqueues), dim3(threads_of(kind)), params,
      (size_t)smem_of(kind, a.atab != nullptr, a.max_rows, a.max_rec,
                      a.nstages),
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
