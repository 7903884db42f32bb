// Fused dequant + gather + distance over a quantized tier-2 slab or
// tier-3 payload, written by hand for Hopper (sm_90a).
//
// Replaces src/repro/kernels/dequant_gather_distance.py ::
// dequant_gather_distance_pallas (one query) and
// dequant_gather_distance_batch_pallas (one query per id row). The single
// form is this kernel launched with B = 1, so the loop and the batched
// drivers get identical bits for the same row and query.
//
// out[b, i] = dist(x, Q[b]) with x = table[ids[b, i]] dequantized: an int8
// row times its float32 scale, a float16 row widened (no scale: `scales`
// is null). ids < 0 give +inf; ids past the table's end read its last row
// (the oracle's clip).
//   l2 : sum (x - q)^2      ip : -sum x q
//   cos: -sum x q / ((|x| + 1e-30) (|q| + 1e-30))
// Each element is dequantized with __fmul_rn, which the compiler never
// contracts into the next add, so x equals the plain version's x.float() *
// scale bit for bit; only the summation order differs.
//
// Bound: bytes. Each output reads one quantized row (d + 4 bytes int8, 2d
// float16) and its query row for 2-3 flops per element, so the least time
// is the distinct valid rows' bytes plus the queries, ids and outputs over
// 3.35 TB/s. Design: one warp per output; the id is read once per warp and
// a padded id skips the row entirely; lane 0 reads the row's scale and a
// shuffle hands it to the warp; lanes stride the row with 16-byte loads (16
// int8 or 8 float16 elements a lane, 512 contiguous bytes per warp
// instruction) and the matching query floats with float4 loads, when the
// row width and both base addresses allow it, and element by element
// otherwise; the dequantized values live only in registers, so no float32
// copy of the table or of the gathered rows is made; float32 sums of x.q
// (or (x-q)^2), x.x and q.q meet in a shuffle tree. The row's distance
// is row_distance.cuh's, shared with B.1 and the hop step B.8.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "row_distance.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

using rowdist::Elt;
using rowdist::kCos;
using rowdist::kHalf;
using rowdist::kInt8;
using rowdist::kIp;
using rowdist::kL2;

template <int METRIC, int ELEM>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dequant_gather_distance_kernel(
    const typename Elt<ELEM>::S* __restrict__ table,
    const float* __restrict__ scales, int n_rows, int d,
    const int* __restrict__ ids, const float* __restrict__ Q, int B, int K,
    float* __restrict__ out, bool vec) {
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
  const float s = rowdist::row_scale(scales, row, lane);
  const float dist = rowdist::dequant_row<METRIC, ELEM>(
      table + static_cast<size_t>(row) * d, s,
      Q + static_cast<size_t>(b) * d, d, vec, lane);
  if (lane == 0) out[w] = dist;
}

template <int ELEM>
int launch(const void* table_raw, const float* scales, int n_rows, int d,
           const int* ids, const float* Q, int B, int K, int metric,
           float* out, cudaStream_t s) {
  using S = typename Elt<ELEM>::S;
  const S* table = static_cast<const S*>(table_raw);
  const long long n_out = static_cast<long long>(B) * K;
  // 16-byte loads need every row and every query row to start on a
  // 16-byte boundary: the row width in bytes a multiple of 16 and both
  // bases aligned
  const bool vec =
      rowdist::vec_loads(table, Q, d, static_cast<int>(sizeof(S)));
  const dim3 grid(
      static_cast<unsigned>((n_out + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  switch (metric) {
    case kL2:
      dequant_gather_distance_kernel<kL2, ELEM><<<grid, block, 0, s>>>(
          table, scales, n_rows, d, ids, Q, B, K, out, vec);
      break;
    case kIp:
      dequant_gather_distance_kernel<kIp, ELEM><<<grid, block, 0, s>>>(
          table, scales, n_rows, d, ids, Q, B, K, out, vec);
      break;
    case kCos:
      dequant_gather_distance_kernel<kCos, ELEM><<<grid, block, 0, s>>>(
          table, scales, n_rows, d, ids, Q, B, K, out, vec);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes. All pointers are device pointers; `elem` is 0 for an
// int8 table, 1 for float16; `scales` is (n_rows,) float32 or null (no
// scale: float16); `stream` is the caller's cudaStream_t. Returns
// cudaGetLastError() after the launch.
extern "C" int dequant_gather_distance(const void* table, int elem,
                                       const float* scales, int n_rows, int d,
                                       const int* ids, const float* Q, int B,
                                       int K, int metric, float* out,
                                       void* stream) {
  const long long n_out = static_cast<long long>(B) * K;
  if (n_out == 0) return 0;
  if (n_rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem) {
    case kInt8:
      return launch<kInt8>(table, scales, n_rows, d, ids, Q, B, K, metric,
                           out, s);
    case kHalf:
      return launch<kHalf>(table, scales, n_rows, d, ids, Q, B, K, metric,
                           out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
