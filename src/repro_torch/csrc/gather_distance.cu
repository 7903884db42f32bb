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
// the whole table on every call. The row's distance is
// row_distance.cuh's, shared with B.3 and the hop step B.8.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "row_distance.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

using rowdist::kCos;
using rowdist::kIp;
using rowdist::kL2;

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
  const float dist = rowdist::f32_row<METRIC>(
      table + static_cast<size_t>(row) * d, Q + static_cast<size_t>(b) * d,
      d, vec4, lane);
  if (lane == 0) out[w] = dist;
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
  const bool vec4 = rowdist::vec_loads(table, Q, d, 4);
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
