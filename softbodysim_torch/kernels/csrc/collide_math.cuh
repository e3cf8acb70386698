// The collide stage's per-particle arithmetic, shared by the stand-alone
// collide kernel (collide.cu) and the Jacobi pass kernels that fuse the
// stage into their last pass (jacobi.cu).  One copy of the code, and both
// sources build with --fmad=false, so the fused and the stand-alone stage
// round the same way.
//
// Semantics: softbodysim_torch/collide/primitives.py (project_ground_plane,
// then collide_particles; each push times the slot's active flag).  Only
// the selected primitive's push is computed (the plain version computes
// all three and selects; the selected value is the same arithmetic).  The
// collider table is (K, 12) f32 rows [type, pos3, quat4, data3, active].

#pragma once

#include <cuda_runtime.h>

namespace {

struct V3 {
  float x, y, z;
};

// The ground plane (a unit normal n through a point p0; on == 0: none) and
// the particle radius r, which the colliders' push-outs use too.
struct Ground {
  int on;
  float px, py, pz, nx, ny, nz, r;
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

// The whole stage on one free particle's row x (pinned rows, w == 0, are
// returned untouched): the ground plane, then the ncols colliders of tab
// in order.
__device__ __forceinline__ float4 collide_row(float4 x, const Ground& g,
                                              const float* tab, int ncols) {
  if (x.w == 0.f) return x;
  V3 p = v3(x.x, x.y, x.z);
  if (g.on) {
    const V3 n = v3(g.nx, g.ny, g.nz);
    const float dist = dot(n, sub(p, v3(g.px, g.py, g.pz)));
    if (dist < g.r) p = add(p, scale(n, g.r - dist));
  }
  for (int k = 0; k < ncols; ++k) {
    const float* c = tab + 12 * k;
    const float type = c[0];
    const V3 center = v3(c[1], c[2], c[3]);
    const V3 q = v3(c[4], c[5], c[6]);
    const float qw = c[7];
    V3 push;
    if (type == 0.f) {
      push = push_sphere(center, c[8], p, g.r);
    } else if (type == 1.f) {
      push = push_box(center, q, qw, v3(c[8], c[9], c[10]), p, g.r);
    } else {
      push = push_capsule(center, q, qw, c[8], c[9], p, g.r);
    }
    p = add(p, scale(push, c[11]));
  }
  x.x = p.x;
  x.y = p.y;
  x.z = p.z;
  return x;
}

}  // namespace
