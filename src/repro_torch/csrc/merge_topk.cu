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
// a row, kRows rows a block. An entry is one 64-bit key, the
// order-preserving bits of its dist above its position (every sentinel
// the all-ones key), so (dist, position) order is one unsigned compare.
// Each lane holds ceil(M/32) rounded up to a power of two (E <= 8) keys in
// registers; a bitonic network sorts them (compare-exchanges inside a lane
// where the pair's stride is below E, else across lanes by
// __shfl_xor_sync, 15 shuffle steps at E = 8): no barrier, no dependence
// on k. The dedup sorts (id, rank) keys, rank being the place in the
// first sort: in each run of one id the first entry survives. It first
// takes only the ranks below min(k, valid entries), spread over fewer
// registers (2 a lane at k = 64): if their ids are distinct, as in every
// row the beam merge sends (search.py never merges an id twice), they are
// the answer; only a row with a duplicate among them pays for the sort of
// all its valid ranks. The row is stashed in shared memory by position,
// so what follows the sort reads no global memory. A warp prefix count of
// the survivors writes the first k in rank order.
// Output values are the input's, read back at the winner's position, so
// they are input bits (-0.0 stays -0.0, though it ties +0.0).
//
// Rows of M > 256 (no path sends them; the tests do, up to MAX_CANDIDATES
// in kernels/topk.py) keep the first design: one block per row, the row
// staged in shared memory (M*8 bytes), k rounds of a block-wide argmin on
// (dist, position), each followed by retiring the winner and every entry
// with its id; a row that runs out of survivors stops early.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;  // sentinel: after every key

// ----------------------------------------------------- rows of M <= 256

constexpr int kSortMax = 256;  // widest row the warp sort takes
constexpr int kRows = 4;       // rows (warps) a block

// Unsigned bits that order as a finite float does, -0 = +0.
__device__ __forceinline__ unsigned order_bits(float v) {
  const unsigned b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Ascending bitonic sort of the warp's 32*E keys, key j of lane l at index
// i = E*l + j: a pair closer than E apart sits in one lane (registers j
// and j | stride), a wider one in two lanes at one register (a shuffle), so
// of the log2(32E)(log2(32E) + 1)/2 steps only 15 shuffle.
template <int E>
__device__ __forceinline__ void warp_sort(unsigned long long (&v)[E],
                                          int lane) {
  constexpr int P = 32 * E;
#pragma unroll
  for (int size = 2; size <= P; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride < E) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          if (j & stride) continue;  // each pair once, from its lower slot
          const bool up = (((lane * E) | j) & size) == 0;
          const unsigned long long a = v[j], b = v[j | stride];
          const bool swap = up ? b < a : a < b;
          v[j] = swap ? b : a;
          v[j | stride] = swap ? a : b;
        }
      } else {
        const int ls = stride / E;
        const bool take_min = ((lane & ls) == 0) == (((lane * E) & size) == 0);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const unsigned long long o = __shfl_xor_sync(kFullMask, v[j], ls);
          v[j] = take_min ? (o < v[j] ? o : v[j]) : (o < v[j] ? v[j] : o);
        }
      }
    }
  }
}

// Per-warp shared memory of the warp-sort variant.
struct RowSmem {
  float d[kSortMax];                 // the row's dists and ids, by position
  int id[kSortMax];
  unsigned long long by_id[kSortMax];  // (id, rank) keys, staged by rank
  unsigned char first[kSortMax];     // by rank: the first of its id
};

// Marks each of ranks [0, c) first or not first of its id in the row,
// through a sort of their (id, rank) keys, E2 a lane, and returns whether
// any is not (warp-uniform). `key` holds ranks E*lane + j.
template <int E2, int E>
__device__ __forceinline__ bool mark_firsts(const unsigned long long (&key)[E],
                                            int lane, int c, RowSmem& sm) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int r = E * lane + j;
    if (r < c)
      sm.by_id[r] =
          (static_cast<unsigned long long>(sm.id[key[j] & 0xffffffffull])
           << 32) |
          static_cast<unsigned>(r);
  }
  __syncwarp();
  unsigned long long v[E2];
#pragma unroll
  for (int j = 0; j < E2; ++j) {
    const int r = E2 * lane + j;
    v[j] = r < c ? sm.by_id[r] : kNone;
  }
  warp_sort<E2>(v, lane);
  // the key before index E2*lane + j: slot j - 1, or lane - 1's last slot;
  // index 0 gets the all-ones, whose id bits match no valid id (< 2^31)
  const unsigned long long last = __shfl_up_sync(kFullMask, v[E2 - 1], 1);
  bool dup = false;
#pragma unroll
  for (int j = 0; j < E2; ++j) {
    const unsigned long long prev =
        j > 0 ? v[j > 0 ? j - 1 : 0] : (lane > 0 ? last : kNone);
    if (v[j] != kNone) {
      const bool f = (prev >> 32) != (v[j] >> 32);
      sm.first[v[j] & 0xffffffffull] = f;
      dup |= !f;
    }
  }
  __syncwarp();
  return __any_sync(kFullMask, dup);
}

// mark_firsts at the smallest E2 <= E that holds c keys.
template <int E>
__device__ __forceinline__ bool mark_firsts_of(
    const unsigned long long (&key)[E], int lane, int c, RowSmem& sm) {
  if (c <= 32) return mark_firsts<1>(key, lane, c, sm);
  if constexpr (E >= 2) {
    if (c <= 64) return mark_firsts<2>(key, lane, c, sm);
  }
  if constexpr (E >= 4) {
    if (c <= 128) return mark_firsts<4>(key, lane, c, sm);
  }
  if constexpr (E >= 8) return mark_firsts<8>(key, lane, c, sm);
  return false;  // c <= 32 * E always
}

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
  RowSmem& sm = smem[warp];

  // 1. (dist, position) keys, loaded coalesced (and kept by position in
  // shared memory) and sorted: rank E*lane + j
  unsigned long long key[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int m = 32 * j + lane;
    key[j] = kNone;
    if (m < M) {
      const float v = dists[row * M + m];
      const int id = ids[row * M + m];
      sm.d[m] = v;
      sm.id[m] = id;
      if (id >= 0 && isfinite(v))
        key[j] = (static_cast<unsigned long long>(order_bits(v)) << 32) |
                 static_cast<unsigned>(m);
    }
  }
  warp_sort<E>(key, lane);
  int n_valid = 0;  // the valid keys are ranks [0, n_valid)
#pragma unroll
  for (int j = 0; j < E; ++j)
    n_valid += __popc(__ballot_sync(kFullMask, key[j] != kNone));
  __syncwarp();  // the stash is visible to every lane

  // 2. dedup. If the first min(k, n_valid) ranks hold distinct ids (every
  // row of the query path), they are the answer; otherwise every valid
  // rank is marked, the first of each id surviving.
  int c = min(k, n_valid);
  if (mark_firsts_of<E>(key, lane, c, sm)) {
    c = n_valid;
    mark_firsts_of<E>(key, lane, c, sm);
  }
  bool kept[E];
  int n_kept = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int r = E * lane + j;
    kept[j] = r < c && sm.first[r];
    n_kept += kept[j];
  }

  // 3. the first k survivors in rank order: an exclusive prefix count of
  // the lanes' survivors places each
  int incl = n_kept;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += o;
  }
  const int total = __shfl_sync(kFullMask, incl, 31);
  int at = incl - n_kept;
  float* od = out_d + row * k;
  int* oi = out_i + row * k;
  int* os = out_s + row * k;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (kept[j] && at < k) {
      const int m = static_cast<int>(key[j] & 0xffffffffull);
      od[at] = sm.d[m];
      oi[at] = sm.id[m];
      os[at] = m;
    }
    at += kept[j];
  }
  for (int j = total + lane; j < k; j += 32) {
    od[j] = CUDART_INF_F;
    oi[j] = -1;
    os[j] = -1;
  }
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
