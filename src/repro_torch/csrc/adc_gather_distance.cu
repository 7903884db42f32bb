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
// Bound: bytes, and in practice latency. A slot (b, i) needs one code row
// (M bytes) and M of its query's L * M * 256 table entries (192 of 49,152
// at M = 192, l2); one add per subspace is far below the card's rate.
// After build_lut a query's table (192 KiB) is L2-resident, so a slot
// costs one dependent round trip for its code row, one for its entries and
// its ordered sum. Design: one warp per (query, id) slot, four slots a
// block, so the grid spreads B * K warps over the SMs (97 at a fused bulk
// load, 1,024 at a batched hop). In a chunk of up to kChunk subspaces,
// lane s of the first half-warp owns subspaces [16 s, 16 s + 16): it reads
// their codes with one 16-byte load where M % 16 == 0 and the slab is
// 16-byte aligned (bytewise otherwise) and gathers their table entries
// straight from global memory (__ldg), all in flight at once; at cos the
// second half-warp gathers the second table's entries the same way. No
// table is staged and no block-wide barrier is taken. The lanes write their
// entries in subspace order into the warp's slice of shared memory; after
// __syncwarp one lane adds them left to right (float4 reads, both tables'
// chains side by side at cos). Chunking keeps the order while letting any
// M fit.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;  // slots a block
constexpr int kThreads = 32 * kWarps;
constexpr int kCentroids = 256;
constexpr int kPerLane = 16;               // subspaces a lane gathers
constexpr int kChunk = 16 * kPerLane;      // subspaces a chunk: 16 lanes

// VEC: M % 16 == 0 and the slab 16-byte aligned, so every row is too.
// __launch_bounds__(kThreads, 1) lets ptxas take the registers it needs:
// with the default it caps the registers of some instantiations and
// spills.
template <bool COS, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
adc_gather_distance_kernel(const uint8_t* __restrict__ codes, int n_rows,
                           int M, const float* __restrict__ luts,
                           const int* __restrict__ ids, int K,
                           long long slots, float* __restrict__ out) {
  constexpr int L = COS ? 2 : 1;
  __shared__ __align__(16) float s_val[kWarps][L][kChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (slot >= slots) return;  // the whole warp
  const int id = __ldg(ids + slot);
  if (id < 0) {
    if (lane == 0) out[slot] = CUDART_INF_F;
    return;
  }
  const long long b = slot / K;
  const int row = id < n_rows ? id : n_rows - 1;
  const uint8_t* code = codes + static_cast<size_t>(row) * M;
  const int l = COS ? lane >> 4 : 0;  // the table this lane reads
  const bool gathers = COS || lane < 16;
  const float* lut =
      luts + (static_cast<size_t>(b) * L + l) * M * kCentroids;
  float* vals = s_val[warp][l];
  float s1 = 0.0f, s2 = 0.0f;
  for (int m0 = 0; m0 < M; m0 += kChunk) {
    const int mc = M - m0 < kChunk ? M - m0 : kChunk;
    const int j0 = (lane & 15) * kPerLane;  // first subspace in the chunk
    if (gathers && j0 < mc) {
      uint32_t w[kPerLane / 4];  // the 16 codes, four to a word
      if (VEC) {  // mc is a multiple of 16
        const uint4 raw =
            __ldg(reinterpret_cast<const uint4*>(code + m0 + j0));
        w[0] = raw.x;
        w[1] = raw.y;
        w[2] = raw.z;
        w[3] = raw.w;
      } else {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const uint32_t c = j0 + j < mc ? __ldg(code + m0 + j0 + j) : 0u;
          w[j / 4] = (j % 4 ? w[j / 4] : 0u) | c << (8 * (j % 4));
        }
      }
      float v[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        if (j0 + j < mc)
          v[j] = __ldg(lut + static_cast<size_t>(m0 + j0 + j) * kCentroids +
                       ((w[j / 4] >> (8 * (j % 4))) & 0xffu));
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        if (j0 + j < mc) vals[j0 + j] = v[j];
    }
    __syncwarp();
    if (lane == 0) {  // the ordered sum, left to right
      const float* a = s_val[warp][0];
      const float* c = s_val[warp][L - 1];
      int j = 0;
      for (; j + 4 <= mc; j += 4) {
        const float4 x = *reinterpret_cast<const float4*>(a + j);
        s1 = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s1, x.x), x.y), x.z),
                       x.w);
        if (COS) {
          const float4 y = *reinterpret_cast<const float4*>(c + j);
          s2 = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s2, y.x), y.y), y.z),
                         y.w);
        }
      }
      for (; j < mc; ++j) {
        s1 = __fadd_rn(s1, a[j]);
        if (COS) s2 = __fadd_rn(s2, c[j]);
      }
    }
    __syncwarp();  // the next chunk overwrites the slice
  }
  if (lane == 0)
    out[slot] = COS ? __fdiv_rn(-s1, __fadd_rn(__fsqrt_rn(s2), 1e-30f)) : s1;
}

template <bool COS>
void launch(const uint8_t* codes, int n_rows, int M, const float* luts,
            const int* ids, int K, long long slots, float* out,
            bool vec_codes, unsigned grid, cudaStream_t s) {
  if (vec_codes)
    adc_gather_distance_kernel<COS, true><<<grid, kThreads, 0, s>>>(
        codes, n_rows, M, luts, ids, K, slots, out);
  else
    adc_gather_distance_kernel<COS, false><<<grid, kThreads, 0, s>>>(
        codes, n_rows, M, luts, ids, K, slots, out);
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
  if (n_rows <= 0 || M <= 0 || B < 0 || K < 0 || metric < 0 || metric > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long slots = static_cast<long long>(B) * K;
  const long long blocks = (slots + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte code loads need every row on a 16-byte boundary
  const bool vec_codes =
      (M % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (metric == 2)
    launch<true>(codes, n_rows, M, luts, ids, K, slots, out, vec_codes, grid,
                 s);
  else
    launch<false>(codes, n_rows, M, luts, ids, K, slots, out, vec_codes,
                  grid, s);
  return static_cast<int>(cudaGetLastError());
}
