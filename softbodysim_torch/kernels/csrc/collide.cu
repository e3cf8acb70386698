// Fused collide stage for Hopper (sm_90a): ground plane, then every
// primitive collider in registration order.
//
// Replaces softbodysim_tpu/kernels/collide.py::_collide_kernel (:136,
// pallas_call :220).  Semantics: softbodysim_torch/collide/primitives.py
// (project_ground_plane, then collide_particles; each push times the slot's
// active flag; particles with inverse mass 0 untouched).
//
// Design.  One thread per particle holds its position in registers, reads
// its (x, y, z, w) row of the (V, 4) table once, applies the ground plane
// and the K colliders (table staged in shared memory, (K, 12) f32 rows
// [type, pos3, quat4, data3, active]) and writes x, y, z once, in place,
// only for free particles.  Only the selected primitive's push is computed
// (the plain version computes all three and selects; the selected value is
// the same arithmetic).
// What bounds it: bytes, V x 16 B read and V x 12 B written (~3 MB, about
// 1 us at 3.35 TB/s at 110k particles); at that size launch latency sets
// its time.  The per-particle work is a few hundred flops for K <= 16.
//
// Build with --fmad=false: the products and sums round as in the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}

// v + w*t + q x t, t = 2 q x v  (q = (qx, qy, qz), w = qw)
__device__ __forceinline__ V3 quat_rotate(V3 q, float w, V3 v) {
  const V3 t = scale(cross(q, v), 2.f);
  return add(add(v, scale(t, w)), cross(q, t));
}

__device__ __forceinline__ V3 push_sphere(V3 center, float radius, V3 p,
                                          float r) {
  const float big_r = radius + r;
  const V3 d = sub(p, center);
  const float dist2 = dot(d, d);
  if (!(dist2 < big_r * big_r)) return v3(0.f, 0.f, 0.f);
  const float dist = sqrtf(fmaxf(dist2, 1e-18f));
  const V3 n = dist > 1e-9f ? v3(d.x / dist, d.y / dist, d.z / dist)
                            : v3(0.f, 1.f, 0.f);
  return scale(n, big_r - dist);
}

__device__ __forceinline__ V3 push_capsule(V3 center, V3 q, float qw,
                                           float radius, float half_h, V3 p,
                                           float r) {
  const V3 axis = quat_rotate(q, qw, v3(0.f, 1.f, 0.f));
  const V3 a = sub(center, scale(axis, half_h));
  const V3 b = add(center, scale(axis, half_h));
  const V3 ab = sub(b, a);
  const float ab2 = dot(ab, ab);
  float t = ab2 < 1e-12f ? 0.f : dot(sub(p, a), ab) / fmaxf(ab2, 1e-20f);
  t = fminf(fmaxf(t, 0.f), 1.f);
  return push_sphere(add(a, scale(ab, t)), radius, p, r);
}

__device__ __forceinline__ V3 push_box(V3 center, V3 q, float qw, V3 he,
                                       V3 p, float r) {
  const V3 qc = v3(-q.x, -q.y, -q.z);
  const V3 pl = quat_rotate(qc, qw, sub(p, center));
  const V3 cl = v3(fminf(fmaxf(pl.x, -he.x), he.x),
                   fminf(fmaxf(pl.y, -he.y), he.y),
                   fminf(fmaxf(pl.z, -he.z), he.z));
  const V3 d = sub(pl, cl);
  const float dist2 = dot(d, d);
  V3 push_l;
  if (dist2 > 1e-18f) {
    const float dist = sqrtf(fmaxf(dist2, 1e-20f));
    if (dist < r) {
      const float m = r - dist;
      push_l = v3((d.x / dist) * m, (d.y / dist) * m, (d.z / dist) * m);
    } else {
      push_l = v3(0.f, 0.f, 0.f);
    }
  } else {
    const float dx = he.x - fabsf(pl.x);
    const float dy = he.y - fabsf(pl.y);
    const float dz = he.z - fabsf(pl.z);
    const float sx = pl.x >= 0.f ? 1.f : -1.f;
    const float sy = pl.y >= 0.f ? 1.f : -1.f;
    const float sz = pl.z >= 0.f ? 1.f : -1.f;
    const bool use_x = (dx <= dy) && (dx <= dz);
    const bool use_y = !use_x && (dy <= dz);
    const bool use_z = !(use_x || use_y);
    push_l = v3(use_x ? sx * (dx + r) : 0.f, use_y ? sy * (dy + r) : 0.f,
                use_z ? sz * (dz + r) : 0.f);
  }
  return quat_rotate(q, qw, push_l);
}

__global__ void __launch_bounds__(kThreads)
collide_kernel(float4* __restrict__ xw, int nv,
               const float* __restrict__ cols, int ncols, int ground_on,
               float gpx, float gpy, float gpz, float gnx, float gny,
               float gnz, float r) {
  extern __shared__ float tab[];           // [ncols][12]
  for (int q = threadIdx.x; q < ncols * 12; q += blockDim.x) tab[q] = cols[q];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nv) return;
  const float4 x = xw[i];
  if (x.w == 0.f) return;                  // pinned: untouched
  V3 p = v3(x.x, x.y, x.z);
  if (ground_on) {
    const V3 n = v3(gnx, gny, gnz);
    const float dist = dot(n, sub(p, v3(gpx, gpy, gpz)));
    if (dist < r) p = add(p, scale(n, r - dist));
  }
  for (int k = 0; k < ncols; ++k) {
    const float* c = tab + 12 * k;
    const float type = c[0];
    const V3 center = v3(c[1], c[2], c[3]);
    const V3 q = v3(c[4], c[5], c[6]);
    const float qw = c[7];
    V3 push;
    if (type == 0.f) {
      push = push_sphere(center, c[8], p, r);
    } else if (type == 1.f) {
      push = push_box(center, q, qw, v3(c[8], c[9], c[10]), p, r);
    } else {
      push = push_capsule(center, q, qw, c[8], c[9], p, r);
    }
    p = add(p, scale(push, c[11]));
  }
  float4 out = x;
  out.x = p.x;
  out.y = p.y;
  out.z = p.z;
  xw[i] = out;
}

}  // namespace

// Plain C entry point (bound with ctypes): launches on the given stream,
// does not synchronise, returns cudaGetLastError().
extern "C" int sbs_collide(void* xw, int nv, const float* cols, int ncols,
                           int ground_on, float gpx, float gpy, float gpz,
                           float gnx, float gny, float gnz, float r,
                           void* stream) {
  if (nv > 0) {
    const size_t smem = (size_t)ncols * 12 * sizeof(float);
    collide_kernel<<<(nv + kThreads - 1) / kThreads, kThreads, smem,
                     (cudaStream_t)stream>>>(
        (float4*)xw, nv, cols, ncols, ground_on, gpx, gpy, gpz, gnx, gny, gnz,
        r);
  }
  return (int)cudaGetLastError();
}
