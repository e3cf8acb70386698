// The particle table's row types: one row is x, y, z and the inverse mass
// w of a particle, read into a float4 and written back from one.
//
//   RowF32   (V, 4) float32:  a 16-byte row, read and written as it is.
//   RowBF16  (V, 4) bfloat16: an 8-byte row (the JAX package's
//            SolverParams.xpbd_x_dtype="bfloat16",
//            softbodysim_tpu/kernels/sweep.py x_dtype): read upcast to
//            f32 (exact), written rounded to nearest even
//            (__float2bfloat16_rn, as PyTorch's and JAX's casts round).
//
// ``round`` passes a row through the table's type and back: the identity
// on RowF32, so the f32 kernels compute exactly what they computed before
// the row type became a parameter.  The kernels never write a row's w (it
// is a table value already, and rounds to itself).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct RowF32 {
  using T = float4;
  static constexpr bool kBf16 = false;

  __device__ __forceinline__ static float4 load(const T* xw, int i) {
    return xw[i];
  }
  // L2 only (L1 is not coherent across SMs)
  __device__ __forceinline__ static float4 load_cg(const T* xw, int i) {
    return __ldcg(xw + i);
  }
  __device__ __forceinline__ static void store(T* xw, int i, float4 v) {
    xw[i] = v;
  }
  __device__ __forceinline__ static void store_cg(T* xw, int i, float4 v) {
    __stcg(xw + i, v);
  }
  __device__ __forceinline__ static float4 round(float4 v) { return v; }
};

struct RowBF16 {
  using T = uint2;     // (x, y) and (z, w), each pair low half first
  static constexpr bool kBf16 = true;

  __device__ __forceinline__ static float lo(uint32_t u) {
    return __uint_as_float(u << 16);
  }
  __device__ __forceinline__ static float hi(uint32_t u) {
    return __uint_as_float(u & 0xffff0000u);
  }
  __device__ __forceinline__ static uint32_t bits(float f) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  __device__ __forceinline__ static float4 unpack(uint2 u) {
    return make_float4(lo(u.x), hi(u.x), lo(u.y), hi(u.y));
  }
  __device__ __forceinline__ static uint2 pack(float4 v) {
    return make_uint2(bits(v.x) | (bits(v.y) << 16),
                      bits(v.z) | (bits(v.w) << 16));
  }
  __device__ __forceinline__ static float4 load(const T* xw, int i) {
    return unpack(xw[i]);
  }
  __device__ __forceinline__ static float4 load_cg(const T* xw, int i) {
    return unpack(__ldcg(xw + i));
  }
  __device__ __forceinline__ static void store(T* xw, int i, float4 v) {
    xw[i] = pack(v);
  }
  __device__ __forceinline__ static void store_cg(T* xw, int i, float4 v) {
    __stcg(xw + i, pack(v));
  }
  __device__ __forceinline__ static float4 round(float4 v) {
    return unpack(pack(v));
  }
};

}  // namespace
