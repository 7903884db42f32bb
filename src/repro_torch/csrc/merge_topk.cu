// Top-k merge of (dist, id) candidates, written by hand for Hopper
// (sm_90a). It serves as the beam merge of the lazy HNSW search.
//
// Replaces src/repro/kernels/topk.py :: merge_topk_pallas.
//
// For each row of (B, M) candidates, return the k smallest as
// (dists, ids, src), each (B, k):
//   - entries with id < 0 or a non-finite dist are sentinels, never win;
//   - a duplicate id keeps only its best (dist, position) copy;
//   - ties go to the lower input position (lax.top_k's order on negated
//     distances, which the beam merge of search.py relies on);
//   - src is the winner's input position; rows past the survivors come
//     back (+inf, -1, -1).
//
// Bound: bytes, B*M*8 read and B*k*12 written (a sort's M*log2(M)^2/2
// compares are fewer still against the card's rate). At the query path's
// shapes (M <= ef + miss_cap = 161, k = ef = 64) that is tens of
// kilobytes, so what the kernel pays is the latency of its dependent
// steps, and the design keeps those few and off the block barrier.
//
// Rows of M <= kSortMax = 256 (every row the query path sends): one warp
// a row, kRows rows a block, through warp_merge.cuh's merge_row (shared
// with the hop step B.8): (dist, position) keys sorted by a bitonic
// network in registers, the dedup over the first k ranks only unless
// they hold a repeated id (search.py never merges an id twice). The row
// is stashed in shared memory by position, so what follows the sort reads
// no global memory. Output values are the input's, read back at the
// winner's position, so they are input bits (-0.0 stays -0.0, though it
// ties +0.0).
//
// Rows of M > 256 (a filter's widened beam sends them: the per-op hop
// step at ef 256 and the load phases at ef 208 and 256, M up to 545; the
// tests go up to MAX_CANDIDATES in kernels/topk.py) keep the first
// design: one block per row, the row staged in shared memory (M*8 bytes),
// k rounds of a block-wide argmin on (dist, position), each followed by
// retiring the winner and every entry with its id; a row that runs out of
// survivors stops early.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "warp_merge.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// ----------------------------------------------------- rows of M <= 256

using warpmerge::kSortMax;
using warpmerge::merge_row;
using warpmerge::RowSmem;

constexpr int kRows = 4;  // rows (warps) a block

template <int E>
__global__ void __launch_bounds__(kRows * 32)
merge_topk_warp_kernel(const float* __restrict__ dists,
                       const int* __restrict__ ids, int B, int M, int k,
                       float* __restrict__ out_d, int* __restrict__ out_i,
                       int* __restrict__ out_s) {
  __shared__ RowSmem smem[kRows];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + warp;
  if (row >= B) return;  // the whole warp leaves together
  merge_row<E>(dists + row * M, ids + row * M, M, k, smem[warp], lane,
               out_d + row * k, out_i + row * k, out_s + row * k);
}

// ------------------------------------------------------ rows of M > 256

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// one block's shared memory without an opt-in (48 KB), less room for the
// static per-warp arrays; rows wider than this are refused
constexpr size_t kMaxRowSmem = 48 * 1024 - 256;

__device__ __forceinline__ bool better(float da, int pa, float db, int pb) {
  return da < db || (da == db && pa < pb);
}

__global__ void __launch_bounds__(kThreads)
merge_topk_block_kernel(const float* __restrict__ dists,
                        const int* __restrict__ ids, int M, int k,
                        float* __restrict__ out_d, int* __restrict__ out_i,
                        int* __restrict__ out_s) {
  extern __shared__ float smem[];
  float* sd = smem;                              // (M,) live distances
  int* si = reinterpret_cast<int*>(smem + M);    // (M,) ids
  __shared__ float warp_d[kWarps];
  __shared__ int warp_p[kWarps];
  __shared__ float win_d;
  __shared__ int win_p;

  const size_t row = blockIdx.x;
  const float* d_row = dists + row * M;
  const int* i_row = ids + row * M;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const float v = d_row[m];
    const int id = i_row[m];
    sd[m] = (id >= 0 && isfinite(v)) ? v : CUDART_INF_F;
    si[m] = id;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* od = out_d + row * k;
  int* oi = out_i + row * k;
  int* os = out_s + row * k;
  int r = 0;
  for (; r < k; ++r) {
    float bd = CUDART_INF_F;
    int bp = INT_MAX;
    for (int m = threadIdx.x; m < M; m += kThreads) {
      const float v = sd[m];
      if (better(v, m, bd, bp)) {
        bd = v;
        bp = m;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float odist = __shfl_xor_sync(kFullMask, bd, off);
      const int opos = __shfl_xor_sync(kFullMask, bp, off);
      if (better(odist, opos, bd, bp)) {
        bd = odist;
        bp = opos;
      }
    }
    if (lane == 0) {
      warp_d[warp] = bd;
      warp_p[warp] = bp;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float fd = warp_d[0];
      int fp = warp_p[0];
      for (int w = 1; w < kWarps; ++w) {
        if (better(warp_d[w], warp_p[w], fd, fp)) {
          fd = warp_d[w];
          fp = warp_p[w];
        }
      }
      win_d = fd;
      win_p = fp;
      const bool ok = fd < CUDART_INF_F;
      od[r] = ok ? fd : CUDART_INF_F;
      oi[r] = ok ? si[fp] : -1;
      os[r] = ok ? fp : -1;
    }
    __syncthreads();
    if (!(win_d < CUDART_INF_F)) break;  // no survivor left (block-uniform)
    const int wid = si[win_p];
    const int wpos = win_p;
    for (int m = threadIdx.x; m < M; m += kThreads) {
      if (m == wpos || si[m] == wid) sd[m] = CUDART_INF_F;
    }
    __syncthreads();
  }
  for (int j = r + 1 + threadIdx.x; j < k; j += kThreads) {
    od[j] = CUDART_INF_F;
    oi[j] = -1;
    os[j] = -1;
  }
}

}  // namespace

// C entry for ctypes. All pointers are device pointers; `stream` is the
// caller's cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int merge_topk_f32(const float* dists, const int* ids, int B,
                              int M, int k, float* out_d, int* out_i,
                              int* out_s, void* stream) {
  if (B == 0 || k == 0) return 0;
  if (B < 0 || M < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= kSortMax) {
    const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
    if (M <= 32)
      merge_topk_warp_kernel<1><<<blocks, kRows * 32, 0, s>>>(
          dists, ids, B, M, k, out_d, out_i, out_s);
    else if (M <= 64)
      merge_topk_warp_kernel<2><<<blocks, kRows * 32, 0, s>>>(
          dists, ids, B, M, k, out_d, out_i, out_s);
    else if (M <= 128)
      merge_topk_warp_kernel<4><<<blocks, kRows * 32, 0, s>>>(
          dists, ids, B, M, k, out_d, out_i, out_s);
    else
      merge_topk_warp_kernel<8><<<blocks, kRows * 32, 0, s>>>(
          dists, ids, B, M, k, out_d, out_i, out_s);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(M) * (sizeof(float) + sizeof(int));
  if (smem > kMaxRowSmem) return static_cast<int>(cudaErrorInvalidValue);
  merge_topk_block_kernel<<<B, kThreads, smem, s>>>(dists, ids, M, k, out_d,
                                                    out_i, out_s);
  return static_cast<int>(cudaGetLastError());
}
