// Fused PQ code-gather + lookup-table accumulate (ADC) over a uint8 code
// slab or payload, written by hand for Hopper (sm_90a).
//
// Replaces src/repro/kernels/adc_gather_distance.py ::
// adc_gather_distance_pallas (one query) and
// adc_gather_distance_batch_pallas (one table per id row). The single form
// is this kernel launched with B = 1, so the loop and the batched drivers
// get identical bits for the same row and table.
//
// out[b, i] = sum_m luts[b, l, m, codes[ids[b, i], m]], the M entries added
// left to right in float32 with __fadd_rn (nothing can be reassociated or
// contracted); l2 and ip read one table (L = 1), cos two (L = 2) and
// finish with (-s1) / (sqrt(s2) + 1e-30) by __fsqrt_rn, __fadd_rn and
// __fdiv_rn. ids < 0 give +inf; ids past the end read the last row (the
// oracle's clip). So the result equals repro.core.pq.adc_distance_np under
// array_equal. Build without --use_fast_math.
//
// Bound: bytes. A query's (L, M, 256) float32 table (192 KiB at M = 192,
// l2) is read once, plus each distinct code row's M bytes, the ids and the
// outputs; one add per subspace is far below the card's rate. Design: one
// block takes one query and a tile of its ids, one thread per id, its
// running sums in registers. The block walks the subspaces in chunks of
// 32 KiB of table (MC = 32 subspaces at L = 1, 16 at L = 2): all threads
// stage the chunk into shared memory with float4 loads, synchronise, and
// each thread adds its row's entries for the chunk, reading the codes with
// 16-byte loads when the row width and base allow. Chunking keeps the
// summation order while letting every M fit (a whole table at M = 192 is
// 192 KiB for l2 and 384 KiB for cos, more than a block's 227 KB). Each
// block re-reads its query's whole table, so a batched call reads the
// tables once per id tile; keeping a search's tables resident across hops
// is left to a later change.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCentroids = 256;
constexpr int kChunkFloats = 8192;  // 32 KiB of table per chunk

template <bool COS>
__global__ void __launch_bounds__(kThreads)
adc_gather_distance_kernel(const uint8_t* __restrict__ codes, int n_rows,
                           int M, const float* __restrict__ luts,
                           const int* __restrict__ ids, int K,
                           float* __restrict__ out, bool vec_codes,
                           bool vec_lut) {
  constexpr int L = COS ? 2 : 1;
  constexpr int MC = kChunkFloats / (L * kCentroids);  // subspaces a chunk
  __shared__ __align__(16) float s_lut[kChunkFloats];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < K;
  const int id = active ? ids[static_cast<size_t>(b) * K + i] : -1;
  const bool valid = id >= 0;
  const int row = valid ? (id < n_rows ? id : n_rows - 1) : 0;
  const uint8_t* code = codes + static_cast<size_t>(row) * M;
  const float* lut = luts + static_cast<size_t>(b) * L * M * kCentroids;
  float s1 = 0.0f, s2 = 0.0f;
  for (int m0 = 0; m0 < M; m0 += MC) {
    const int mc = M - m0 < MC ? M - m0 : MC;
    const int n = mc * kCentroids;  // floats of one table in this chunk
    __syncthreads();  // every thread is done with the previous chunk
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float* src =
          lut + (static_cast<size_t>(l) * M + m0) * kCentroids;
      float* dst = s_lut + l * MC * kCentroids;
      if (vec_lut) {
        const float4* src4 = reinterpret_cast<const float4*>(src);
        float4* dst4 = reinterpret_cast<float4*>(dst);
        for (int j = threadIdx.x; j < n / 4; j += kThreads)
          dst4[j] = __ldg(src4 + j);
      } else {
        for (int j = threadIdx.x; j < n; j += kThreads) dst[j] = __ldg(src + j);
      }
    }
    __syncthreads();
    if (!valid) continue;
    const float* t0 = s_lut;
    const float* t1 = s_lut + MC * kCentroids;
    if (vec_codes) {  // mc is a multiple of 16 and every row 16-byte aligned
      for (int j = 0; j < mc; j += 16) {
        union {
          uint4 raw;
          uint8_t c[16];
        } u;
        u.raw = __ldg(reinterpret_cast<const uint4*>(code + m0 + j));
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          const int e = (j + t) * kCentroids + u.c[t];
          s1 = __fadd_rn(s1, t0[e]);
          if (COS) s2 = __fadd_rn(s2, t1[e]);
        }
      }
    } else {
      for (int j = 0; j < mc; ++j) {
        const int e = j * kCentroids + __ldg(code + m0 + j);
        s1 = __fadd_rn(s1, t0[e]);
        if (COS) s2 = __fadd_rn(s2, t1[e]);
      }
    }
  }
  if (!active) return;
  float dist = CUDART_INF_F;
  if (valid) {
    dist = COS ? __fdiv_rn(-s1, __fadd_rn(__fsqrt_rn(s2), 1e-30f)) : s1;
  }
  out[static_cast<size_t>(b) * K + i] = dist;
}

}  // namespace

// C entry for ctypes. All pointers are device pointers: codes (n_rows, M)
// uint8, luts (B, L, M, 256) float32 with L = 2 for cos (metric 2) and 1
// for l2 (0) and ip (1), ids (B, K) int32, out (B, K) float32; `stream` is
// the caller's cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int adc_gather_distance(const uint8_t* codes, int n_rows, int M,
                                   const float* luts, const int* ids, int B,
                                   int K, int metric, float* out,
                                   void* stream) {
  if (B == 0 || K == 0) return 0;
  if (n_rows <= 0 || M <= 0 || B > 65535 || metric < 0 || metric > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte code loads need every row on a 16-byte boundary; float4 table
  // loads need the tables' base aligned (each chunk then starts aligned)
  const bool vec_codes =
      (M % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  const bool vec_lut = reinterpret_cast<uintptr_t>(luts) % 16 == 0;
  const dim3 grid((K + kThreads - 1) / kThreads, B);
  if (metric == 2) {
    adc_gather_distance_kernel<true><<<grid, kThreads, 0, s>>>(
        codes, n_rows, M, luts, ids, K, out, vec_codes, vec_lut);
  } else {
    adc_gather_distance_kernel<false><<<grid, kThreads, 0, s>>>(
        codes, n_rows, M, luts, ids, K, out, vec_codes, vec_lut);
  }
  return static_cast<int>(cudaGetLastError());
}
