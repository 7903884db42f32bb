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
// shapes (M <= ef + miss_cap = 161, k = ef = 64; under a filter M <= 545,
// k <= 256) that is at most a few hundred kilobytes, so what the kernel
// pays is the latency of its dependent steps, and the design keeps those
// few and off the block barrier.
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
// tests go up to MAX_CANDIDATES in kernels/topk.py): one block of 512
// threads a row, no step taken once per output entry. (1) Runs: each warp
// sorts a run of 256 (dist, position) keys in registers (warp_sort<8>, as
// merge_row) and writes it to shared memory; a row wider than the block's
// 16 runs loops. (2) Merge by rank: keys are distinct (the position sits
// in the low bits), so a key's rank in the row is the sum over the runs
// of the keys below it there, each found by a binary search of 9 steps,
// four runs side by side; each valid key is written at its rank. At M =
// 545 that is three runs and one barrier. (3) Dedup: every valid rank
// puts its id in an open-addressing table in shared memory (the runs'
// space, at most half full) and atomicMin keeps each id's least rank,
// which no order of the atomics changes; a rank survives where it is its
// id's least. (4) A block prefix count of the survivors, in rank order,
// writes the first k, values read back at the winner's position. Shared
// memory, runs_smem(M): 8 bytes a key for the runs (padded to whole
// runs), the table's second half and the keys by rank, 8*M for the ids
// and table slots (195,840 bytes at M = 6,112, above the 48 KB default).
// Each wide launch first sets the kernel's dynamic shared-memory limit to
// what its row needs; a row past the card's opt-in (232,448 bytes a block
// on the H100, so M up to about 7,200) fails there, and the launch
// returns that error. The table replaces the warp variant's (id, rank)
// sort, which here would be one more warp's sort of 256 keys before the
// output, and marks every valid rank at once: with no sort there is
// nothing to save by marking the first k ranks first. Every key searches
// every run, so the merge reads 9*M*ceil(M/256) keys whatever k is: past
// about 2,000 entries at a small k it costs more than a selection would
// (PERF.md section 6, the kernel table's row 3).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "warp_merge.cuh"

namespace {

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

using warpmerge::entry_key;
using warpmerge::kFullMask;
using warpmerge::kNone;
using warpmerge::warp_sort;

typedef unsigned long long Key;

constexpr int kThreads = 512;  // one row a block
constexpr int kWarps = kThreads / 32;
constexpr int kRun = kSortMax;  // keys a run: one warp's sort, 8 a lane
constexpr unsigned kLow = 0xffffffffu;

// The keys below `key` in sorted runs i0 .. i0 + 3 of `runs` (kRun each),
// four binary searches of 9 dependent loads side by side; runs from R on
// count 0.
__device__ __forceinline__ int count_below(const Key* runs, int i0, int R,
                                           Key key) {
  int pos[4] = {0, 0, 0, 0};
#pragma unroll
  for (int step = kRun / 2; step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i0 + u < R && runs[(i0 + u) * kRun + pos[u] + step - 1] < key)
        pos[u] += step;
    }
  }
  int n = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (i0 + u < R) n += pos[u] + (runs[(i0 + u) * kRun + pos[u]] < key);
  }
  return n;
}

// Dynamic shared memory of a row of M: the runs and M keys more (the
// hash table of the dedup, once the runs are merged), the keys by rank,
// the ids by position and each rank's table slot.
__host__ __device__ __forceinline__ size_t runs_smem(int M) {
  const size_t R = (static_cast<size_t>(M) + kRun - 1) / kRun;
  return sizeof(Key) * (R * kRun + 2 * static_cast<size_t>(M)) +
         2 * sizeof(int) * static_cast<size_t>(M);
}

__global__ void __launch_bounds__(kThreads)
merge_topk_runs_kernel(const float* __restrict__ dists,
                       const int* __restrict__ ids, int M, int k,
                       float* __restrict__ out_d, int* __restrict__ out_i,
                       int* __restrict__ out_s) {
  extern __shared__ Key smem[];
  const int R = (M + kRun - 1) / kRun;
  Key* runs = smem;                        // (R * kRun,) sorted runs
  Key* by_rank = runs + R * kRun + M;      // (M,) the valid keys by rank
  int* sid = reinterpret_cast<int*>(by_rank + M);  // (M,) ids by position
  int* slot = sid + M;                     // (M,) each rank's table slot
  // the dedup's open-addressing table over the runs and the M keys after
  // them: T >= 2 M entries of (id, least rank), so at most half full
  const unsigned T = static_cast<unsigned>(R * kRun + M);
  int* tid = reinterpret_cast<int*>(runs);
  int* trank = tid + T;
  __shared__ int warp_valid[kWarps];  // valid keys in each warp's runs
  __shared__ int warp_n[kWarps];

  const size_t row = blockIdx.x;
  const float* d_row = dists + row * M;
  const int* i_row = ids + row * M;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* od = out_d + row * k;
  int* oi = out_i + row * k;
  int* os = out_s + row * k;

  // 1. runs: each warp sorts kRun (dist, position) keys in registers and
  // writes them in order, kNone (sentinels and padding) last; the ids are
  // kept by position
  int valid = 0;
  for (int j = warp; j < R; j += kWarps) {
    Key v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int m = j * kRun + 32 * e + lane;
      v[e] = kNone;
      if (m < M) {
        const int id = i_row[m];
        sid[m] = id;
        v[e] = entry_key(d_row[m], id, m);
      }
    }
    warp_sort<8>(v, lane);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      valid += __popc(__ballot_sync(kFullMask, v[e] != kNone));
      runs[j * kRun + 8 * lane + e] = v[e];
    }
  }
  if (lane == 0) warp_valid[warp] = valid;
  __syncthreads();

  // 2. merge by rank: keys are distinct, so a valid key's rank in the row
  // is the sum over the runs of the keys below it (its own run's count
  // being its place there)
  for (int t = threadIdx.x; t < R * kRun; t += kThreads) {
    const Key key = runs[t];
    if (key == kNone) continue;
    int rank = 0;
    for (int i0 = 0; i0 < R; i0 += 4) rank += count_below(runs, i0, R, key);
    by_rank[rank] = key;
  }
  int n_valid = 0;  // the valid keys are ranks [0, n_valid)
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n_valid += warp_valid[w];
  __syncthreads();

  // 3. dedup: each valid rank puts its id in the table and the least rank
  // of each id stays there (atomicMin: the same whatever the order); a
  // rank survives where it is its id's least
  for (unsigned t = threadIdx.x; t < T; t += kThreads) {
    tid[t] = -1;  // no valid id
    trank[t] = M;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n_valid; r += kThreads) {
    const int id = sid[by_rank[r] & kLow];
    unsigned h = static_cast<unsigned>(
        (static_cast<unsigned long long>(static_cast<unsigned>(id) *
                                         0x9E3779B1u) * T) >> 32);
    for (;;) {
      const int held = atomicCAS(&tid[h], -1, id);
      if (held == -1 || held == id) break;
      h = h + 1 == T ? 0 : h + 1;
    }
    atomicMin(&trank[h], r);
    slot[r] = static_cast<int>(h);
  }
  __syncthreads();

  // 4. the first k survivors in rank order, a tile of kThreads ranks at a
  // time: a ballot places each within its warp, the warps' counts within
  // the tile
  int base = 0;  // survivors before this tile (block-uniform)
  for (int r0 = 0; r0 < n_valid && base < k; r0 += kThreads) {
    const int r = r0 + threadIdx.x;
    const bool kept = r < n_valid && trank[slot[r]] == r;
    const unsigned ballot = __ballot_sync(kFullMask, kept);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, tile = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = warp_n[w];
      before += w < warp ? n : 0;
      tile += n;
    }
    const int at = base + before + __popc(ballot & ((1u << lane) - 1u));
    if (kept && at < k) {
      const int m = static_cast<int>(by_rank[r] & kLow);
      od[at] = d_row[m];
      oi[at] = sid[m];
      os[at] = m;
    }
    base += tile;
    __syncthreads();  // warp_n is rewritten by the next tile
  }
  for (int j = base + threadIdx.x; j < k; j += kThreads) {
    od[j] = CUDART_INF_F;
    oi[j] = -1;
    os[j] = -1;
  }
}

}  // namespace

// C entry for ctypes. All pointers are device pointers; `stream` is the
// caller's cudaStream_t. Returns the error of the shared-memory attribute
// call of a wide row, else cudaGetLastError() after the launch.
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
  // a host-side attribute, allowed inside a graph capture
  const size_t smem = runs_smem(M);
  const cudaError_t err = cudaFuncSetAttribute(
      merge_topk_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_topk_runs_kernel<<<B, kThreads, smem, s>>>(
      dists, ids, M, k, out_d, out_i, out_s);
  return static_cast<int>(cudaGetLastError());
}
