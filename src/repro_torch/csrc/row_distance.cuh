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
//
// f32_rows and dequant_rows compute up to R rows at once for one query
// (the hop step's), f32_row and dequant_row one (the gather kernels'):
// one code, so a row's distance has the same bits either way. Every lane
// issues its loads of all the rows (U of its 16-byte chunks a row, or U
// elements, at a time) before it adds any, so the rows' reads are in
// flight together instead of one row's after another's shuffle tree.

#pragma once

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace rowdist {

constexpr unsigned kFullMask = 0xffffffffu;

enum Metric { kL2 = 0, kIp = 1, kCos = 2 };
enum Elem { kInt8 = 0, kHalf = 1 };

// Each product is added by one fused multiply-add, written out (as the
// compiler contracts `acc += a * b` by default), so no kernel's bits hang
// on whether the compiler shares a product between rows (q * q) or not.
template <int METRIC>
__device__ __forceinline__ void accumulate(float x, float q, float& acc,
                                           float& xx, float& qq) {
  if (METRIC == kL2) {
    const float diff = x - q;
    acc = __fmaf_rn(diff, diff, acc);
  } else {
    acc = __fmaf_rn(x, q, acc);
    if (METRIC == kCos) {
      xx = __fmaf_rn(x, x, xx);
      qq = __fmaf_rn(q, q, qq);
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

// Distances of the nr <= R float32 rows x[0..nr) to the query q, d
// elements each (nr the same on every lane), into out[0..nr); the whole
// warp calls it. vec4: d % 4 == 0 and every row and q 16-byte aligned.
// The loads of all nr rows, U chunks (or elements) a lane at a time, are
// issued before any is summed.
template <int METRIC, int R, int U>
__device__ __forceinline__ void f32_rows(const float* const (&x)[R], int nr,
                                         const float* __restrict__ q, int d,
                                         bool vec4, int lane,
                                         float (&out)[R]) {
  float acc[R], xx[R], qq[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = xx[r] = qq[r] = 0.f;
  if (vec4) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int d4 = d >> 2;
    for (int j0 = lane; j0 < d4; j0 += 32 * U) {
      float4 xa[U][R], qa[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + 32 * u;
        if (j < d4) {
          qa[u] = __ldg(q4 + j);
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < nr) xa[u][r] = __ldg(reinterpret_cast<const float4*>(x[r]) + j);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + 32 * u < d4) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < nr) {
              accumulate<METRIC>(xa[u][r].x, qa[u].x, acc[r], xx[r], qq[r]);
              accumulate<METRIC>(xa[u][r].y, qa[u].y, acc[r], xx[r], qq[r]);
              accumulate<METRIC>(xa[u][r].z, qa[u].z, acc[r], xx[r], qq[r]);
              accumulate<METRIC>(xa[u][r].w, qa[u].w, acc[r], xx[r], qq[r]);
            }
          }
        }
      }
    }
  } else {
    for (int j0 = lane; j0 < d; j0 += 32 * U) {
      float xa[U][R], qa[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + 32 * u;
        if (j < d) {
          qa[u] = __ldg(q + j);
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < nr) xa[u][r] = __ldg(x[r] + j);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + 32 * u < d) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < nr) accumulate<METRIC>(xa[u][r], qa[u], acc[r], xx[r], qq[r]);
        }
      }
    }
  }
  // every row's shuffle tree at once (a row past nr sums zeros, unused)
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = finish<METRIC>(acc[r], xx[r], qq[r]);
}

// Distance of the float32 row x to the query q: f32_rows of one row.
template <int METRIC>
__device__ __forceinline__ float f32_row(const float* x, const float* q,
                                         int d, bool vec4, int lane) {
  const float* const rows[1] = {x};
  float out[1];
  f32_rows<METRIC, 1, 1>(rows, 1, q, d, vec4, lane, out);
  return out[0];
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

// Distances of the nr <= R quantized rows x[0..nr) (each times its scale
// s[r]) to the query q, as f32_rows does (nr the same on every lane);
// vec: d a multiple of the elements in 16 bytes and every row and q
// 16-byte aligned.
template <int METRIC, int ELEM, int R, int U>
__device__ __forceinline__ void dequant_rows(
    const typename Elt<ELEM>::S* const (&x)[R], const float (&s)[R], int nr,
    const float* __restrict__ q, int d, bool vec, int lane, float (&out)[R]) {
  using S = typename Elt<ELEM>::S;
  constexpr int kE = 16 / static_cast<int>(sizeof(S));
  union Chunk {
    int4 raw;
    S e[kE];
  };
  float acc[R], xx[R], qq[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = xx[r] = qq[r] = 0.f;
  if (vec) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int chunks = d / kE;
    for (int j0 = lane; j0 < chunks; j0 += 32 * U) {
      Chunk xa[U][R];
      float4 qa[U][kE / 4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + 32 * u;
        if (j < chunks) {
#pragma unroll
          for (int h = 0; h < kE / 4; ++h) qa[u][h] = __ldg(q4 + j * (kE / 4) + h);
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < nr) xa[u][r].raw = __ldg(reinterpret_cast<const int4*>(x[r]) + j);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + 32 * u < chunks) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < nr) {
#pragma unroll
              for (int h = 0; h < kE / 4; ++h) {
                const float qv[4] = {qa[u][h].x, qa[u][h].y, qa[u][h].z,
                                     qa[u][h].w};
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                  const float xv =
                      __fmul_rn(Elt<ELEM>::widen(xa[u][r].e[4 * h + t]), s[r]);
                  accumulate<METRIC>(xv, qv[t], acc[r], xx[r], qq[r]);
                }
              }
            }
          }
        }
      }
    }
  } else {
    for (int j0 = lane; j0 < d; j0 += 32 * U) {
      S xa[U][R];
      float qa[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + 32 * u;
        if (j < d) {
          qa[u] = __ldg(q + j);
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < nr) xa[u][r] = x[r][j];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + 32 * u < d) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < nr) {
              const float xv = __fmul_rn(Elt<ELEM>::widen(xa[u][r]), s[r]);
              accumulate<METRIC>(xv, qa[u], acc[r], xx[r], qq[r]);
            }
          }
        }
      }
    }
  }
  // every row's shuffle tree at once (a row past nr sums zeros, unused)
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = finish<METRIC>(acc[r], xx[r], qq[r]);
}

// Distance of the quantized row x (times the scale s) to the query q:
// dequant_rows of one row.
template <int METRIC, int ELEM>
__device__ __forceinline__ float dequant_row(const typename Elt<ELEM>::S* x,
                                             float s, const float* q, int d,
                                             bool vec, int lane) {
  const typename Elt<ELEM>::S* const rows[1] = {x};
  const float scale[1] = {s};
  float out[1];
  dequant_rows<METRIC, ELEM, 1, 1>(rows, scale, 1, q, d, vec, lane, out);
  return out[0];
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
