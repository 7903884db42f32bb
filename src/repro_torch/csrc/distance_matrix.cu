// Distance matrix of a query batch against a table, written by hand for
// Hopper (sm_90a). It is the local scan of the flat search substrate.
//
// Replaces src/repro/kernels/distance.py :: distance_matrix_pallas.
//
// out[b, n] for Q (B, d) and X (N, d), float32, in the reference's GEMM
// form with g = q.x:
//   l2 : max(|q|^2 + |x|^2 - 2 g, 0)   (a NaN stays NaN, as jnp.maximum)
//   ip : -g
//   cos: -g / ((|q| + 1e-30) (|x| + 1e-30))
//
// Bound: bytes at the flat scan's shape. At (32, 480000, 768) the table is
// 1.47 GB and the output 61 MB, 0.459 ms at 3.35 TB/s; the 2*B*N*d = 23.6
// GFLOP of float32 FMA take 0.352 ms at 67 TFLOP/s, so the two are close
// and the kernel must keep both the loads and the FMA pipes busy.
// Design: a tiled float32 GEMM on the CUDA cores (FFMA, no TF32 and no
// tensor cores: wgmma takes no float32 inputs, and TF32's ~3 digits would
// move l2 distances near |x|^2 ~ 860 by far more than the gaps the ids
// depend on). A block computes a 32 x 128 output tile; its 256 threads
// stage a 32-deep slice of Q and of X through shared memory (16-byte
// coalesced loads, stored transposed so the inner loop reads them as
// conflict-free float4), and each thread keeps a 4 x 4 register tile of
// dot products. At B <= 32 one block row covers the whole batch, so X is
// read from device memory once. The row norms |x|^2 and |q|^2 are summed
// from the same staged tiles (X is not read a second time), and the
// epilogue applies the metric: cos divides by the norms here, where the
// TPU wrapper normalised the whole table on every call. Ragged B, N and d
// are masked in the kernel (zeros staged past the edge, stores guarded);
// no padded copy of X is made. Several blocks share an SM, so one block's
// loads overlap another's FMA without explicit double buffering; at l2 and
// cos the norms and epilogue take ~120 registers a thread, which leaves
// two blocks an SM and about half the memory rate (a later version may
// add cp.async stages and trim registers).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 32;   // output rows (queries) a block
constexpr int kBN = 128;  // output columns (table rows) a block
constexpr int kBK = 32;   // depth of one staged slice of d
constexpr int kTM = 4;    // rows of a thread's register tile
constexpr int kTN = 4;    // columns of a thread's register tile
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256: 8 warps x 32
constexpr int kQS = kBM + 4;  // padded row stride of the staged Q slice
constexpr int kXS = kBN + 4;  // padded row stride of the staged X slice
constexpr unsigned kFullMask = 0xffffffffu;

static_assert(kBM / kTM == 8 && kBN / kTN == 32, "one warp per row group");
static_assert(kBK == 32 && kBK == 4 * (kBM / kTM),
              "norm split: 32 lanes x 1 k for q, 8 warps x 4 k for x");

enum Metric { kL2 = 0, kIp = 1, kCos = 2 };

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

template <int METRIC>
__device__ __forceinline__ float finish(float g, float qn, float xn) {
  if (METRIC == kL2) {
    const float v = (qn + xn) - 2.0f * g;
    return v < 0.0f ? 0.0f : v;  // NaN fails the test and stays NaN
  }
  if (METRIC == kIp) return -g;
  return -g / ((sqrtf(qn) + 1e-30f) * (sqrtf(xn) + 1e-30f));
}

// Stage the [k0, k0 + kBK) slice of the Q rows [m0, m0 + kBM) and the X rows
// [n0, n0 + kBN) into shared memory, transposed ([k][row]); zeros past the
// edges of B, N and d. VEC: d % 4 == 0 and 16-byte aligned bases.
template <bool VEC>
__device__ __forceinline__ void stage(const float* __restrict__ Q,
                                      const float* __restrict__ X, int B,
                                      int N, int d, int m0, int n0, int k0,
                                      float (*qs)[kQS], float (*xs)[kXS]) {
  const int t = threadIdx.x;
  if (VEC) {
    {  // Q: kBM x kBK = 256 float4, one a thread; 8 threads a row
      const int row = t >> 3, c = (t & 7) * 4;
      const int gm = m0 + row, gk = k0 + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gm < B && gk < d)
        v = *reinterpret_cast<const float4*>(Q + static_cast<size_t>(gm) * d + gk);
      qs[c + 0][row] = v.x;
      qs[c + 1][row] = v.y;
      qs[c + 2][row] = v.z;
      qs[c + 3][row] = v.w;
    }
#pragma unroll
    for (int i = 0; i < (kBN * kBK / 4) / kThreads; ++i) {  // X: 4 a thread
      const int f = t + i * kThreads;
      const int row = f >> 3, c = (f & 7) * 4;
      const int gn = n0 + row, gk = k0 + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gn < N && gk < d)
        v = *reinterpret_cast<const float4*>(X + static_cast<size_t>(gn) * d + gk);
      xs[c + 0][row] = v.x;
      xs[c + 1][row] = v.y;
      xs[c + 2][row] = v.z;
      xs[c + 3][row] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {  // Q: 4 a thread
      const int f = t + i * kThreads;
      const int row = f / kBK, kk = f % kBK;
      const int gm = m0 + row, gk = k0 + kk;
      qs[kk][row] = (gm < B && gk < d) ? Q[static_cast<size_t>(gm) * d + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (kBN * kBK) / kThreads; ++i) {  // X: 16 a thread
      const int f = t + i * kThreads;
      const int row = f / kBK, kk = f % kBK;
      const int gn = n0 + row, gk = k0 + kk;
      xs[kk][row] = (gn < N && gk < d) ? X[static_cast<size_t>(gn) * d + gk] : 0.f;
    }
  }
}

template <int METRIC, bool VEC>
__global__ void __launch_bounds__(kThreads)
distance_matrix_kernel(const float* __restrict__ Q, const float* __restrict__ X,
                       int B, int N, int d, int tiles_m,
                       float* __restrict__ out) {
  __shared__ __align__(16) float qs[kBK][kQS];
  __shared__ __align__(16) float xs[kBK][kXS];
  __shared__ float xn_part[kBM / kTM][kBN];

  const int tx = threadIdx.x & 31;  // column group: columns tx*4 .. tx*4+3
  const int ty = threadIdx.x >> 5;  // row group (= warp): rows ty*4 .. ty*4+3
  // row tiles of one column tile are neighbours in launch order, so at
  // B > 32 they share the X tile through L2
  const int m0 = static_cast<int>(blockIdx.x % tiles_m) * kBM;
  const int n0 = static_cast<int>(blockIdx.x / tiles_m) * kBN;

  float acc[kTM][kTN];
  float qn[kTM], xn[kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    qn[i] = 0.f;
    xn[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < d; k0 += kBK) {
    stage<VEC>(Q, X, B, N, d, m0, n0, k0, qs, xs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[kk][ty * kTM]);
      const float4 b = *reinterpret_cast<const float4*>(&xs[kk][tx * kTN]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (METRIC != kIp) {
      // |x|^2 of this thread's 4 columns over k in [ty*4, ty*4 + 4), and
      // |q|^2 of its 4 rows at k = tx: every staged element counted once
#pragma unroll
      for (int kk = ty * 4; kk < ty * 4 + 4; ++kk) {
        const float4 b = *reinterpret_cast<const float4*>(&xs[kk][tx * kTN]);
        xn[0] = fmaf(b.x, b.x, xn[0]);
        xn[1] = fmaf(b.y, b.y, xn[1]);
        xn[2] = fmaf(b.z, b.z, xn[2]);
        xn[3] = fmaf(b.w, b.w, xn[3]);
      }
      const float4 a = *reinterpret_cast<const float4*>(&qs[tx][ty * kTM]);
      qn[0] = fmaf(a.x, a.x, qn[0]);
      qn[1] = fmaf(a.y, a.y, qn[1]);
      qn[2] = fmaf(a.z, a.z, qn[2]);
      qn[3] = fmaf(a.w, a.w, qn[3]);
    }
    __syncthreads();  // the next slice overwrites qs and xs
  }

  if (METRIC != kIp) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) qn[i] = warp_sum(qn[i]);  // over the 32 k
#pragma unroll
    for (int j = 0; j < kTN; ++j) xn_part[ty][tx * kTN + j] = xn[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTN; ++j) {  // over the 8 warps' k ranges
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kBM / kTM; ++w) s += xn_part[w][tx * kTN + j];
      xn[j] = s;
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= B) break;
    float* o = out + static_cast<size_t>(gm) * N;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < N) o[gn] = finish<METRIC>(acc[i][j], qn[i], xn[j]);
    }
  }
}

template <int METRIC>
void launch(const float* Q, const float* X, int B, int N, int d, int tiles_m,
            unsigned blocks, bool vec, float* out, cudaStream_t s) {
  if (vec)
    distance_matrix_kernel<METRIC, true><<<blocks, kThreads, 0, s>>>(
        Q, X, B, N, d, tiles_m, out);
  else
    distance_matrix_kernel<METRIC, false><<<blocks, kThreads, 0, s>>>(
        Q, X, B, N, d, tiles_m, out);
}

}  // namespace

// C entry for ctypes. Q (B, d), X (N, d) and out (B, N) are contiguous
// float32 device arrays; `stream` is the caller's cudaStream_t. Returns
// cudaGetLastError() after the launch.
extern "C" int distance_matrix_f32(const float* Q, const float* X, int B,
                                   int N, int d, int metric, float* out,
                                   void* stream) {
  if (B < 0 || N < 0 || d < 0 || metric < kL2 || metric > kCos)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const long long tiles_m = (B + kBM - 1) / kBM;
  const long long tiles_n = (N + kBN - 1) / kBN;
  if (tiles_m * tiles_n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(tiles_m * tiles_n);
  const bool vec = (d % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(Q) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(X) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tm = static_cast<int>(tiles_m);
  switch (metric) {
    case kL2: launch<kL2>(Q, X, B, N, d, tm, blocks, vec, out, s); break;
    case kIp: launch<kIp>(Q, X, B, N, d, tm, blocks, vec, out, s); break;
    default: launch<kCos>(Q, X, B, N, d, tm, blocks, vec, out, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
