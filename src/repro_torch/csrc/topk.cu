// Row-wise k smallest of a distance matrix (split-K top-k), written by
// hand for Hopper (sm_90a). It serves the flat scan's local top-k, the
// substrate's global reduce over the shards' candidates and the recsys
// candidate retrieval.
//
// Replaces src/repro/kernels/topk.py :: topk_pallas.
//
// For each row of a (B, N) float32 matrix return the k smallest as
// (dists (B, k), ids (B, k)) under lax.top_k's contract (and a stable
// sort's): entries are ordered by (value, column), so ties -- +inf among
// them -- go to the lower column; ids are distinct and < N, even where a
// row holds fewer than k finite entries (topk_pallas repeats an id there,
// because an all-inf tile's argmin picks one column every round). -0.0
// ties +0.0 and a NaN sorts after +inf, as in torch.sort; the substrate
// masks every invalid entry to +inf before the call, so no NaN reaches
// it there. The output values are input values, bit for bit.
//
// Bound: bytes, B*N*4 read once (one ordered compare an element is far
// below the card's rate); at (32, 480000) that is 61 MB, 18 us at
// 3.35 TB/s, and at retrieval's (1, 1000000) 4 MB, 1.2 us. Design: the
// blocks run in no order, so the split-K of the TPU kernel (a sequential
// grid carrying nothing) becomes a first pass over tiles and a tree of
// merges. An entry is one 64-bit key, the order-preserving bits of its
// value above its column, so (value, column) order is one unsigned
// compare.
//   Pass 1: one warp per (row, 1024-column tile), each lane holding 32
//   values in registers (coalesced 128-byte loads per warp); it writes the
//   tile's k smallest keys in ascending order: k rounds of a shuffle-tree
//   minimum over the lanes each emit one key, and only the lane that gave
//   it rescans its registers for its next key above the one it gave (keys
//   are distinct, so nothing is marked); a tile with fewer than k entries
//   pads its list with the all-ones sentinel key, which sorts after every
//   real key.
//   Merge levels: the row's T = ceil(N/1024) sorted lists are merged in a
//   tree. At each level one block takes a group of up to kGroup = 32
//   lists, padded to K2 = the power of two >= k, stages them in shared
//   memory (every load in flight at once) and merges them pairwise in
//   log2(32) rounds, one warp a pair and one block barrier a round: the
//   lower half of two sorted lists is min(a[i], b[K2-1-i]), a bitonic
//   sequence, which log2(K2) half-cleaner steps sort in the warp's
//   registers. A level leaves ceil(L/32) lists a row, so (1, 1000000) takes
//   977 -> 31 -> 1 and (32, 480000) 469 -> 15 -> 1, where the one-block
//   selection this replaces took k dependent rounds over all T*k
//   survivors. The last level writes each winner's column and reads its
//   value back from the input.
// What pass 1 pays instead of bytes is issued instructions (k rounds of
// a rescan), several times its bound at every shape timed. k is capped
// at kMaxK = 128 (twice the reference's 64), where pass 1 still shrinks a
// row eightfold.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kPer = 32;            // values a lane holds in pass 1
constexpr int kTile = 32 * kPer;    // columns a warp selects from
constexpr int kWarps1 = 4;          // warps a block in pass 1
constexpr int kGroup = 32;          // lists a block merges in a level
constexpr int kThreadsL = 256;      // threads a block in a merge level
constexpr int kMaxK = 128;
constexpr int kMaxK2 = 128;         // kMaxK rounded up to a power of two
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;  // sentinel: after every key

// Unsigned bits that order as the float does; NaN after +inf, -0 = +0.
__device__ __forceinline__ unsigned order_bits(float v) {
  if (v != v) return 0xffffffffu;
  const unsigned b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// (value, column) as one key; every real key is > 0 and < kNone.
__device__ __forceinline__ unsigned long long make_key(float v, int col) {
  return (static_cast<unsigned long long>(order_bits(v)) << 32) |
         static_cast<unsigned>(col);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFullMask, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// The smallest of a lane's keys above `floor` (kNone if none is left).
__device__ __forceinline__ unsigned long long lane_min(const float (&v)[kPer],
                                                       int c0, int N,
                                                       unsigned long long floor) {
  unsigned long long best = kNone;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = c0 + 32 * i;
    if (c < N) {
      const unsigned long long key = make_key(v[i], c);
      if (key > floor && key < best) best = key;
    }
  }
  return best;
}

__global__ void __launch_bounds__(kWarps1 * 32)
topk_tiles_kernel(const float* __restrict__ D, int N, int T, long long n_warps,
                  int k, unsigned long long* __restrict__ keys) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps1 +
                      (threadIdx.x >> 5);
  if (w >= n_warps) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long row = w / T;
  const int c0 = static_cast<int>(w % T) * kTile + lane;  // this lane's first
  const float* d_row = D + static_cast<size_t>(row) * N;
  float v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = c0 + 32 * i;
    v[i] = c < N ? d_row[c] : 0.0f;
  }
  unsigned long long mine = lane_min(v, c0, N, 0ull);
  unsigned long long* out = keys + static_cast<size_t>(w) * k;  // (row, tile)
  for (int r = 0; r < k; ++r) {
    const unsigned long long win = warp_min(mine);  // the same in every lane
    if (win == kNone) {  // the tile ran out of entries: pad with sentinels
      for (int j = r + lane; j < k; j += 32) out[j] = kNone;
      break;
    }
    if (lane == 0) out[r] = win;
    if (mine == win) mine = lane_min(v, c0, N, win);  // exactly one lane
  }
}

// The lower K2 keys of two ascending K2-key lists a and b, ascending, into
// a; one warp, R = max(1, K2 / 32) keys a lane in registers (element
// R*lane + j). min(a[e], b[K2-1-e]) is a bitonic sequence holding the lower
// half; log2(K2) half-cleaner steps sort it, by shuffle where the stride
// is R or more, inside the lane below.
template <int R>
__device__ __forceinline__ void merge_pair(unsigned long long* a,
                                           const unsigned long long* b,
                                           int K2, int lane) {
  unsigned long long x[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int e = R * lane + j;
    x[j] = kNone;
    if (e < K2) {
      const unsigned long long p = a[e], q = b[K2 - 1 - e];
      x[j] = q < p ? q : p;
    }
  }
  for (int st = K2 >> 1; st >= R; st >>= 1) {
    const int ls = st / R;
    const bool lower = (lane & ls) == 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const unsigned long long o = __shfl_xor_sync(kFullMask, x[j], ls);
      x[j] = lower == (o < x[j]) ? o : x[j];
    }
  }
#pragma unroll
  for (int st = R >> 1; st > 0; st >>= 1) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j & st) continue;
      const unsigned long long p = x[j], q = x[j | st];
      x[j] = q < p ? q : p;
      x[j | st] = q < p ? p : q;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int e = R * lane + j;
    if (e < K2) a[e] = x[j];
  }
}

// One level of the merge tree. Block (row, g) merges the sorted k-key
// lists g*kGroup .. of its row (L_in lists a row, k keys apart) into one,
// written as list g of L_out; at the last level (L_out == 1) it writes
// the row's (dists, ids) instead. Dynamic shared memory: P2*K2 keys,
// P2 = the power of two >= the group's list count, K2 = 1 << lg_K2 >= k,
// R = max(1, K2 / 32). Each pair of lists is merged by one warp in
// registers, so a round of pairs costs one block barrier.
template <int R>
__global__ void __launch_bounds__(kThreadsL)
topk_level_kernel(const unsigned long long* __restrict__ in, int L_in, int k,
                  int lg_K2, int L_out, unsigned long long* __restrict__ out,
                  const float* __restrict__ D, int N, float* __restrict__ out_d,
                  int* __restrict__ out_i) {
  extern __shared__ unsigned long long s[];
  const int K2 = 1 << lg_K2;
  const long long row = blockIdx.x / L_out;
  const int g = static_cast<int>(blockIdx.x % L_out);
  const int first = g * kGroup;
  const int nl = min(kGroup, L_in - first);
  int P2 = 1;
  while (P2 < nl) P2 <<= 1;
  const unsigned long long* src =
      in + (static_cast<size_t>(row) * L_in + first) * k;
  // stage the group: every load issued before the first is waited on
  constexpr int kLoads = kGroup * kMaxK2 / kThreadsL;
  unsigned long long tmp[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int t = threadIdx.x + q * kThreadsL;
    const int l = t >> lg_K2, e = t & (K2 - 1);
    tmp[q] = (l < nl && e < k) ? src[static_cast<size_t>(l) * k + e] : kNone;
  }
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int t = threadIdx.x + q * kThreadsL;
    if (t < P2 * K2) s[t] = tmp[q];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int w = 1; w < P2; w <<= 1) {  // list p*2w takes in list p*2w + w
    for (int p = warp; p < P2 / (2 * w); p += kThreadsL / 32) {
      unsigned long long* a = s + (static_cast<size_t>(p) * 2 * w << lg_K2);
      merge_pair<R>(a, a + (static_cast<size_t>(w) << lg_K2), K2, lane);
    }
    __syncthreads();
  }
  if (L_out == 1) {
    for (int e = threadIdx.x; e < k; e += kThreadsL) {
      // k <= N, so every place holds a real key; the sentinel branch only
      // keeps a broken input from reading out of bounds
      const unsigned long long key = s[e];
      const bool ok = key != kNone;
      const int col = static_cast<int>(key & 0xffffffffull);
      out_d[row * k + e] = ok ? D[row * N + col] : CUDART_INF_F;
      out_i[row * k + e] = ok ? col : -1;
    }
  } else {
    unsigned long long* dst = out + (static_cast<size_t>(row) * L_out + g) * k;
    for (int e = threadIdx.x; e < k; e += kThreadsL) dst[e] = s[e];
  }
}

int tiles(int N) { return (N + kTile - 1) / kTile; }

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// C entry for ctypes. D (B, N) float32, out_d (B, k) float32 and out_i
// (B, k) int32 are contiguous device arrays; `scratch` holds
// topk_scratch_keys(B, N, k) 64-bit keys (pass 1's lists, then the first
// level's, the levels reading one and writing the other in turn);
// `stream` is the caller's cudaStream_t. Returns cudaGetLastError() after
// the launches.
extern "C" long long topk_scratch_keys(int B, int N, int k) {
  const long long T = tiles(N);
  return static_cast<long long>(B) * (T + (T + kGroup - 1) / kGroup) * k;
}

// Merge levels after pass 1 at row width N: ceil(log32(ceil(N / 1024))),
// at least one (the level that writes the output).
extern "C" int topk_levels(int N) {
  int L = tiles(N), n = 0;
  do {
    L = (L + kGroup - 1) / kGroup;
    ++n;
  } while (L > 1);
  return n;
}

extern "C" int topk_max_k() { return kMaxK; }

extern "C" int topk_f32(const float* D, int B, int N, int k,
                        unsigned long long* scratch, float* out_d, int* out_i,
                        void* stream) {
  if (B < 0 || k < 0 || k > kMaxK || k > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || k == 0) return 0;
  const int T = tiles(N);
  const long long n_warps = static_cast<long long>(B) * T;
  const long long blocks1 = (n_warps + kWarps1 - 1) / kWarps1;
  if (blocks1 > 0x7fffffffLL || n_warps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  topk_tiles_kernel<<<static_cast<unsigned>(blocks1), kWarps1 * 32, 0, s>>>(
      D, N, T, n_warps, k, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int lg_K2 = 0;
  while ((1 << lg_K2) < k) ++lg_K2;
  const int K2 = 1 << lg_K2;
  unsigned long long* cur = scratch;
  unsigned long long* nxt = scratch + n_warps * k;
  int L = T;
  do {
    const int L_out = (L + kGroup - 1) / kGroup;
    const size_t smem =
        static_cast<size_t>(next_pow2(L < kGroup ? L : kGroup)) * K2 *
        sizeof(unsigned long long);  // at most 32 * 128 * 8 = 32 KB
    const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) *
                                                  L_out);
    if (K2 <= 32)
      topk_level_kernel<1><<<blocks, kThreadsL, smem, s>>>(
          cur, L, k, lg_K2, L_out, nxt, D, N, out_d, out_i);
    else if (K2 == 64)
      topk_level_kernel<2><<<blocks, kThreadsL, smem, s>>>(
          cur, L, k, lg_K2, L_out, nxt, D, N, out_d, out_i);
    else
      topk_level_kernel<4><<<blocks, kThreadsL, smem, s>>>(
          cur, L, k, lg_K2, L_out, nxt, D, N, out_d, out_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    unsigned long long* t = cur;
    cur = nxt;
    nxt = t;
    L = L_out;
  } while (L > 1);
  return 0;
}
