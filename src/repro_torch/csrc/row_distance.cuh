// The distance stage of the gather kernels: one warp computes the distance
// of one table row to one query. B.1 (gather_distance.cu), B.3
// (dequant_gather_distance.cu) and the hop step B.8 (hop_step.cu) all
// call these functions, so each (row, query, metric) has one reduction
// order and the three kernels give the same bits for it.
//
//   l2 : sum (x - q)^2      ip : -sum x q
//   cos: -sum x q / ((|x| + 1e-30) (|q| + 1e-30))
//
// Lanes stride the row: with 16-byte loads where the row width and both
// base addresses allow it (4 float32, 8 float16 or 16 int8 elements a
// lane and load, 512 contiguous bytes a warp instruction), element by
// element otherwise. Each lane sums its elements in order, then a
// shuffle tree of 5 steps adds the 32 partial sums; every lane ends with
// the same bits. cos accumulates x.q, x.x and q.q in the same pass and
// divides in the kernel. A quantized element is widened to float32 and,
// for int8, multiplied by its row's scale with __fmul_rn, which the
// compiler never contracts into the next add, so x equals the plain
// version's x.float() * scale bit for bit.

#pragma once

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace rowdist {

constexpr unsigned kFullMask = 0xffffffffu;

enum Metric { kL2 = 0, kIp = 1, kCos = 2 };
enum Elem { kInt8 = 0, kHalf = 1 };

template <int METRIC>
__device__ __forceinline__ void accumulate(float x, float q, float& acc,
                                           float& xx, float& qq) {
  if (METRIC == kL2) {
    const float diff = x - q;
    acc += diff * diff;
  } else {
    acc += x * q;
    if (METRIC == kCos) {
      xx += x * x;
      qq += q * q;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// The lanes' partial sums reduced to the distance (every lane gets it).
template <int METRIC>
__device__ __forceinline__ float finish(float acc, float xx, float qq) {
  acc = warp_sum(acc);
  if (METRIC == kCos) {
    xx = warp_sum(xx);
    qq = warp_sum(qq);
  }
  if (METRIC == kL2) return acc;
  if (METRIC == kIp) return -acc;
  return -acc / ((sqrtf(xx) + 1e-30f) * (sqrtf(qq) + 1e-30f));
}

// Distance of the float32 row x to the query q, d elements; the whole
// warp calls it. vec4: d % 4 == 0 and both rows 16-byte aligned.
template <int METRIC>
__device__ __forceinline__ float f32_row(const float* __restrict__ x,
                                         const float* __restrict__ q, int d,
                                         bool vec4, int lane) {
  float acc = 0.f, xx = 0.f, qq = 0.f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int d4 = d >> 2;
    for (int j = lane; j < d4; j += 32) {
      const float4 a = __ldg(x4 + j);
      const float4 c = __ldg(q4 + j);
      accumulate<METRIC>(a.x, c.x, acc, xx, qq);
      accumulate<METRIC>(a.y, c.y, acc, xx, qq);
      accumulate<METRIC>(a.z, c.z, acc, xx, qq);
      accumulate<METRIC>(a.w, c.w, acc, xx, qq);
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      accumulate<METRIC>(__ldg(x + j), __ldg(q + j), acc, xx, qq);
    }
  }
  return finish<METRIC>(acc, xx, qq);
}

// Storage type and widening of each quantized element kind; float16 rows
// are read as their raw 16 bits, so the 16-byte union below holds only
// plain types.
template <int ELEM>
struct Elt;
template <>
struct Elt<kInt8> {
  using S = int8_t;
  static __device__ __forceinline__ float widen(S v) {
    return static_cast<float>(v);
  }
};
template <>
struct Elt<kHalf> {
  using S = unsigned short;
  static __device__ __forceinline__ float widen(S v) {
    return __half2float(__ushort_as_half(v));
  }
};

// The dequantization scale of `row`: lane 0 reads it and a shuffle hands
// it to the warp; 1 where there are no scales (float16).
__device__ __forceinline__ float row_scale(const float* __restrict__ scales,
                                           int row, int lane) {
  if (scales == nullptr) return 1.0f;
  const float s = lane == 0 ? __ldg(scales + row) : 0.0f;
  return __shfl_sync(kFullMask, s, 0);
}

// Distance of the quantized row x (times the scale s) to the query q;
// the whole warp calls it. vec: d a multiple of the elements in 16 bytes
// and both rows 16-byte aligned.
template <int METRIC, int ELEM>
__device__ __forceinline__ float dequant_row(
    const typename Elt<ELEM>::S* __restrict__ x, float s,
    const float* __restrict__ q, int d, bool vec, int lane) {
  using S = typename Elt<ELEM>::S;
  constexpr int kE = 16 / static_cast<int>(sizeof(S));
  float acc = 0.f, xx = 0.f, qq = 0.f;
  if (vec) {
    const int4* x16 = reinterpret_cast<const int4*>(x);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int chunks = d / kE;
    for (int j = lane; j < chunks; j += 32) {
      union {
        int4 raw;
        S e[kE];
      } u;
      u.raw = __ldg(x16 + j);
#pragma unroll
      for (int h = 0; h < kE / 4; ++h) {
        const float4 c = __ldg(q4 + j * (kE / 4) + h);
        const float qv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float xv = __fmul_rn(Elt<ELEM>::widen(u.e[4 * h + t]), s);
          accumulate<METRIC>(xv, qv[t], acc, xx, qq);
        }
      }
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      const float xv = __fmul_rn(Elt<ELEM>::widen(x[j]), s);
      accumulate<METRIC>(xv, __ldg(q + j), acc, xx, qq);
    }
  }
  return finish<METRIC>(acc, xx, qq);
}

// Host side: whether the 16-byte path applies to a table of row width d
// and `elem_bytes` bytes an element and to the queries Q.
inline bool vec_loads(const void* table, const float* Q, int d,
                      int elem_bytes) {
  return (d % (16 / elem_bytes) == 0) &&
         (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(Q) % 16 == 0);
}

}  // namespace rowdist
