// Fused gather + distance for the lazy HNSW query path, written by hand
// for Hopper (sm_90a).
//
// Replaces src/repro/kernels/gather_distance.py :: gather_distance_pallas
// (one query) and gather_distance_batch_pallas (one query per id row).
// The single form is this kernel launched with B = 1, so the loop and the
// batched drivers get identical bits for the same row and query.
//
// out[b, i] = dist(table[ids[b, i]], Q[b]); ids < 0 give +inf and ids past
// the table's end read its last row (the oracle's clip).
//   l2 : sum (x - q)^2      ip : -sum x q
//   cos: -sum x q / ((|x| + 1e-30) (|q| + 1e-30))
//
// Bound: bytes. Each output reads one d-float row (and its query row,
// which stays in L1/L2 across the K outputs of a query) for 2-3 flops per
// element, far below the card's ~20 flop per byte, so the least time is
// each distinct valid row's d*4 bytes (at most B*K*d*4) over 3.35 TB/s,
// when the rows come from HBM; on the query path the tier-2 slab is a few
// MB and mostly sits in the 50 MB L2. Design: one warp per output; the id is
// read once per warp and a padded id skips the row entirely; lanes stride
// the row with float4 loads (16 bytes a lane, 512 contiguous bytes per
// warp instruction); the row never returns to device memory; a shuffle
// tree reduces the 32 partial sums. cos accumulates x.q, x.x and q.q in
// the same pass and divides in-kernel, where the TPU wrapper normalised
// the whole table on every call.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

enum Metric { kL2 = 0, kIp = 1, kCos = 2 };

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

template <int METRIC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_distance_kernel(const float* __restrict__ table, int n_rows, int d,
                       const int* __restrict__ ids,
                       const float* __restrict__ Q, int B, int K,
                       float* __restrict__ out, bool vec4) {
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= static_cast<long long>(B) * K) return;  // whole warp leaves
  const int b = static_cast<int>(w / K);
  const int id = ids[w];
  if (id < 0) {  // padded slot: no row read at all
    if (lane == 0) out[w] = CUDART_INF_F;
    return;
  }
  const int row = id < n_rows ? id : n_rows - 1;
  const float* x = table + static_cast<size_t>(row) * d;
  const float* q = Q + static_cast<size_t>(b) * d;
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
  acc = warp_sum(acc);
  if (METRIC == kCos) {
    xx = warp_sum(xx);
    qq = warp_sum(qq);
  }
  if (lane == 0) {
    float dist;
    if (METRIC == kL2) {
      dist = acc;
    } else if (METRIC == kIp) {
      dist = -acc;
    } else {
      dist = -acc / ((sqrtf(xx) + 1e-30f) * (sqrtf(qq) + 1e-30f));
    }
    out[w] = dist;
  }
}

}  // namespace

// C entry for ctypes. All pointers are device pointers; `stream` is the
// caller's cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int gather_distance_f32(const float* table, int n_rows, int d,
                                   const int* ids, const float* Q, int B,
                                   int K, int metric, float* out,
                                   void* stream) {
  const long long n_out = static_cast<long long>(B) * K;
  if (n_out == 0) return 0;
  if (n_rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = (d % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(Q) % 16 == 0);
  const dim3 grid(
      static_cast<unsigned>((n_out + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL2:
      gather_distance_kernel<kL2><<<grid, block, 0, s>>>(table, n_rows, d, ids,
                                                         Q, B, K, out, vec4);
      break;
    case kIp:
      gather_distance_kernel<kIp><<<grid, block, 0, s>>>(table, n_rows, d, ids,
                                                         Q, B, K, out, vec4);
      break;
    case kCos:
      gather_distance_kernel<kCos><<<grid, block, 0, s>>>(table, n_rows, d,
                                                          ids, Q, B, K, out,
                                                          vec4);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
