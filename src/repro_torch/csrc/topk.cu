// Row-wise k smallest of a distance matrix (split-K top-k), written by
// hand for Hopper (sm_90a). It serves the flat scan's local top-k and the
// substrate's global reduce over the shards' candidates.
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
// 3.35 TB/s. Design: the blocks run in no order, so the split-K of the
// TPU kernel (a sequential grid carrying nothing) becomes two passes.
// An entry is one 64-bit key, the order-preserving bits of its value above
// its column, so (value, column) order is one unsigned compare.
//   Pass 1: one warp per (row, 1024-column tile). Each lane holds 32 values
//   in registers (coalesced 128-byte loads per warp) and its smallest key;
//   k rounds of a shuffle-tree minimum over the lanes each emit one key,
//   and only the lane that gave it rescans its registers for its next key
//   above the one it gave (keys are distinct, so nothing is marked). A tile
//   with fewer than k entries pads its list with an all-ones sentinel key,
//   which sorts after every real key.
//   Pass 2: one block per row over the row's ceil(N/1024)*k survivors, the
//   same selection with a block-wide minimum (one barrier a round, the
//   per-warp minima double-buffered); it writes each winner's column and
//   reads its value back from the input.
// What this design pays instead of bytes is issued instructions: in each
// of pass 1's k rounds one lane rescans its 32 registers while its warp
// waits (a later version may keep a second-smallest key a lane, or filter
// by a warp threshold, so a round rarely rescans). k is capped at
// kMaxK = 128 (twice the reference's 64), where pass 1 still shrinks a row
// eightfold.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kPer = 32;            // values a lane holds in pass 1
constexpr int kTile = 32 * kPer;    // columns a warp selects from
constexpr int kWarps1 = 4;          // warps a block in pass 1
constexpr int kThreads2 = 256;      // threads a block in pass 2
constexpr int kWarps2 = kThreads2 / 32;
constexpr int kMaxK = 128;
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

__global__ void __launch_bounds__(kThreads2)
topk_merge_kernel(const unsigned long long* __restrict__ keys, int M, int k,
                  const float* __restrict__ D, int N, float* __restrict__ out_d,
                  int* __restrict__ out_i) {
  __shared__ unsigned long long warp_best[2][kWarps2];
  const size_t row = blockIdx.x;
  const unsigned long long* kr = keys + row * M;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  auto thread_min = [&](unsigned long long floor) {
    unsigned long long best = kNone;
    for (int m = threadIdx.x; m < M; m += kThreads2) {
      const unsigned long long key = kr[m];
      if (key > floor && key < best) best = key;
    }
    return best;
  };

  unsigned long long mine = thread_min(0ull);
  for (int r = 0; r < k; ++r) {
    // one barrier a round: a warp can write round r + 2's slot only after
    // every warp has passed round r + 1's barrier, i.e. read round r's
    const unsigned long long wmin = warp_min(mine);
    if (lane == 0) warp_best[r & 1][warp] = wmin;
    __syncthreads();
    unsigned long long win = warp_best[r & 1][0];
#pragma unroll
    for (int w = 1; w < kWarps2; ++w) {
      const unsigned long long o = warp_best[r & 1][w];
      win = o < win ? o : win;
    }
    if (threadIdx.x == 0) {
      // k <= N, so every round finds a real key; the sentinel branch only
      // keeps a broken input from reading out of bounds
      const bool ok = win != kNone;
      const int col = static_cast<int>(win & 0xffffffffull);
      out_d[row * k + r] = ok ? D[row * N + col] : CUDART_INF_F;
      out_i[row * k + r] = ok ? col : -1;
    }
    if (win != kNone && mine == win) mine = thread_min(win);
  }
}

}  // namespace

// C entry for ctypes. D (B, N) float32, out_d (B, k) float32 and out_i
// (B, k) int32 are contiguous device arrays; `scratch` holds
// topk_scratch_keys(B, N, k) 64-bit keys; `stream` is the caller's
// cudaStream_t. Returns cudaGetLastError() after the launches.
extern "C" long long topk_scratch_keys(int B, int N, int k) {
  return static_cast<long long>(B) * ((N + kTile - 1) / kTile) * k;
}

extern "C" int topk_max_k() { return kMaxK; }

extern "C" int topk_f32(const float* D, int B, int N, int k,
                        unsigned long long* scratch, float* out_d, int* out_i,
                        void* stream) {
  if (B < 0 || k < 0 || k > kMaxK || k > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || k == 0) return 0;
  const int T = (N + kTile - 1) / kTile;
  const long long n_warps = static_cast<long long>(B) * T;
  const long long blocks1 = (n_warps + kWarps1 - 1) / kWarps1;
  if (blocks1 > 0x7fffffffLL || static_cast<long long>(T) * k > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  topk_tiles_kernel<<<static_cast<unsigned>(blocks1), kWarps1 * 32, 0, s>>>(
      D, N, T, n_warps, k, scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<<<static_cast<unsigned>(B), kThreads2, 0, s>>>(
      scratch, T * k, k, D, N, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}
