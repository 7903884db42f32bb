// Distance matrix of a query batch against a table, written by hand for
// Hopper (sm_90a). It is the local scan of the flat search substrate and
// recsys' candidate retrieval.
//
// Replaces src/repro/kernels/distance.py :: distance_matrix_pallas.
//
// out[b, n] for Q (B, d) and X (N, d), float32, in the reference's GEMM
// form with g = q.x:
//   l2 : max(|q|^2 + |x|^2 - 2 g, 0)   (a NaN stays NaN, as jnp.maximum)
//   ip : -g
//   cos: -g / ((|q| + 1e-30) (|x| + 1e-30))
//
// Bound: bytes. At the flat scan's (32, 480000, 768) the table is 1.47 GB
// and the output 61 MB, 0.459 ms at 3.35 TB/s; at retrieval's
// (1, 1000000, 64) the table is 256 MB, 0.078 ms. The 2*B*N*d FMAs would
// take 0.352 ms on the CUDA cores at the scan's shape, close to the bytes,
// so the products go to the tensor cores instead.
//
// Design: a stream over the table with the products on the tensor cores
// in 3xTF32. Each staged float32 element v is split into hi = tf32(v) and
// lo = tf32(v - hi), each rounded to nearest with ties away from zero (the
// bits of cvt.rna.tf32.f32, by two integer operations; raw float32 bits
// fed as TF32 would be truncated), and each m16n8k8 product tile takes
// three mma.sync TF32 products into float32 accumulators, small terms
// first: lo.hi, hi.lo, then hi.hi. That keeps g to about float32 accuracy
// (plain TF32 moves l2 distances near |x|^2 ~ 860 by ~5e-5 of the scale,
// past the near-tie gaps the ids depend on; see
// tests/test_torch_kernels.py). Table rows are the M side of the product
// and queries the N side, so B <= 32 takes at most four n8 tiles and
// B = 1 one (NT, a template parameter). A tile is 128 table rows by up to
// 32 queries; its four warps own 32 rows each. A persistent grid (as many
// blocks as fit on the card: three an SM) walks the tiles; a ring of
// kStages 32-deep slices of the X tile and the Q slice is filled by
// cp.async 16-byte copies (4-byte copies where d % 4 != 0 or a base is not
// 16-byte aligned), kStages - 1 slices ahead and across tile boundaries,
// so one tile's epilogue overlaps the next tile's loads and no load passes
// through registers. Slices are stored as loaded, rows padded to 40 floats
// so that the fragments' 8-byte loads are free of bank conflicts (each
// k-step of 8 maps its k index t to 2t and t + 4 to 2t + 1, the same map
// for both operands). |x|^2 and |q|^2 are summed in float32 FFMA from the
// same staged values (not their TF32 parts), so X is read from device
// memory once; the epilogue applies the metric (ip reads the norms only to
// keep a NaN input) and guards its stores at ragged B and N (zeros are
// staged past the edges). At B > 32 the tiles of one table slab are
// neighbours in the walk, so blocks in flight share an X tile through L2.
// Occupancy: shared memory (three 25 KiB stages) allows three blocks an
// SM; __launch_bounds__(kThreads, 1) lets ptxas take the registers it
// needs without spilling (chip_smoke.py prints the counts), which still
// fit three blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;   // table rows a tile (the products' M side)
constexpr int kMaxQ = 32;    // queries a tile (at most four n8 tiles)
constexpr int kBK = 32;      // depth of one staged slice of d
constexpr int kStride = 40;  // padded row stride of a staged slice, floats
constexpr int kStages = 3;   // slices in the ring
constexpr int kWarps = 4;    // each owns 32 table rows: two m16 tiles
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRows == 32 * kWarps, "a warp owns two m16 tiles");
static_assert(kBK % 8 == 0 && kStride % 8 == 0 && kStride >= kBK,
              "8-byte fragment loads without bank conflicts");

enum Metric { kL2 = 0, kIp = 1, kCos = 2 };

// floats of one stage of the ring: the X tile's rows, then the Q slice's
template <int NT>
constexpr int kStageFloats = (kRows + NT * 8) * kStride;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// asynchronous copies into shared memory
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the bits cvt.rna.tf32.f32 gives for a finite v, in two integer
// operations where cvt.rna compiles to three (it also tests for inf and
// NaN), and every element takes two roundings. A NaN may come out as a
// zero here; the norms, summed from the raw values, carry it to the output
// (finish).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo + (what TF32 cannot hold of lo); v - hi is exact in float32
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int METRIC>
__device__ __forceinline__ float finish(float g, float qn, float xn) {
  if (METRIC == kL2) {
    const float v = (qn + xn) - 2.0f * g;
    return v < 0.0f ? 0.0f : v;  // NaN fails the test and stays NaN
  }
  if (METRIC == kIp) {
    const float n = qn + xn;  // NaN exactly where an input element was
    return n != n ? n : -g;
  }
  return -g / ((sqrtf(qn) + 1e-30f) * (sqrtf(xn) + 1e-30f));
}

// One thread's share of a slice: kWidth floats (a 16-byte copy, or 4 bytes
// on the scalar path) at column `col` of the slice's rows r0, r0 + kStep,
// ..., the same for every slice.
template <bool VEC>
struct Share {
  static constexpr int kWidth = VEC ? 4 : 1;
  static constexpr int kPerRow = kBK / kWidth;       // threads a row
  static constexpr int kStep = kThreads / kPerRow;   // 16 or 4 rows apart
};

// Copy this thread's share of one slice of ROWS rows into `dst` (its first
// element in the stage); `src` is its first element in global memory and
// `step` the distance of kStep rows there. Rows at or past `n_ok` of the
// share, or a column at or past d (`k_ok` false), get zeros, by a plain
// store, so the ragged edges of N, B and d add nothing.
template <int ROWS, bool VEC>
__device__ __forceinline__ void copy_share(float* dst, const float* src,
                                           size_t step, int n_ok,
                                           bool k_ok) {
  using S = Share<VEC>;
  const int r0 = threadIdx.x / S::kPerRow;
#pragma unroll
  for (int i = 0; i < (ROWS + S::kStep - 1) / S::kStep; ++i) {
    if (ROWS % S::kStep != 0 && r0 + i * S::kStep >= ROWS) break;
    float* to = dst + i * S::kStep * kStride;
    const bool in = k_ok && i < n_ok;
    if (VEC) {
      if (in)
        cp16(to, src + i * step);
      else
        *reinterpret_cast<float4*>(to) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      if (in)
        cp4(to, src + i * step);
      else
        *to = 0.f;
    }
  }
}

// How many of the rows first, first + kStep, ... lie below `limit`.
template <bool VEC>
__device__ __forceinline__ int rows_below(int first, int limit) {
  constexpr int kStep = Share<VEC>::kStep;
  return first < limit ? (limit - first + kStep - 1) / kStep : 0;
}

template <int METRIC, int NT, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
distance_matrix_kernel(const float* __restrict__ Q,
                       const float* __restrict__ X, int B, int N, int d,
                       int tiles_m, long long n_tiles,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' group, slot
  const int KT = d > kBK ? (d + kBK - 1) / kBK : 1;
  // this block's tiles: blockIdx.x, + gridDim.x, ...; a tile is
  // (n-slab, m-tile) with the m-tiles of one slab adjacent
  const long long step = gridDim.x;
  const long long total = (n_tiles - blockIdx.x + step - 1) / step * KT;

  // producer: the next slice to copy in, kStages - 1 ahead of the consumer
  using S = Share<VEC>;
  const int r0 = threadIdx.x / S::kPerRow;
  const int col = threadIdx.x % S::kPerRow * S::kWidth;
  const size_t row_step = static_cast<size_t>(S::kStep) * d;
  long long p_tile = blockIdx.x, p_it = 0;
  int p_kt = 0, p_stage = 0;
  const float *x_src, *q_src;  // this thread's first element of the tile
  int x_ok, q_ok;              // its rows inside N and B
  auto start_tile = [&]() {
    const int m0 = static_cast<int>(p_tile % tiles_m) * kMaxQ;
    const int n0 = static_cast<int>(p_tile / tiles_m) * kRows;
    x_src = X + static_cast<size_t>(n0 + r0) * d + col;
    q_src = Q + static_cast<size_t>(m0 + r0) * d + col;
    x_ok = rows_below<VEC>(n0 + r0, N);
    q_ok = rows_below<VEC>(m0 + r0, B);
  };
  start_tile();
  auto produce = [&]() {
    if (p_it < total) {
      float* xs = smem + p_stage * kStageFloats<NT> + r0 * kStride + col;
      const int k0 = p_kt * kBK;
      const bool k_ok = k0 + col < d;
      copy_share<kRows, VEC>(xs, x_src + k0, row_step, x_ok, k_ok);
      copy_share<NT * 8, VEC>(xs + kRows * kStride, q_src + k0, row_step,
                              q_ok, k_ok);
      if (++p_kt == KT) {
        p_kt = 0;
        p_tile += step;
        start_tile();
      }
      p_stage = p_stage + 1 == kStages ? 0 : p_stage + 1;
    }
    ++p_it;
    cp_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) produce();

  float acc[2][NT][4];
  float xn[2][2];     // |x|^2 of rows g and g + 8 of each m16 tile
  float qp[NT];       // |q|^2 of column nt * 8 + g, this lane's k's
  long long c_tile = blockIdx.x;
  int c_kt = 0, c_stage = 0;
  for (long long it = 0; it < total; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();  // this slice is in; every warp is done with the last
    produce();        // refills the stage the last iteration read
    const float* xs = smem + c_stage * kStageFloats<NT>;
    const float* qs = xs + kRows * kStride;
    if (c_kt == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        xn[mt][0] = xn[mt][1] = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) qp[nt] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      // B fragments (queries): b0 = (k 2t, n g), b1 = (k 2t + 1, n g)
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 v = *reinterpret_cast<const float2*>(
            qs + (nt * 8 + g) * kStride + kk + 2 * t);
        split(v.x, bh[nt][0], bl[nt][0]);
        split(v.y, bh[nt][1], bl[nt][1]);
        qp[nt] = fmaf(v.y, v.y, fmaf(v.x, v.x, qp[nt]));
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // A fragments (table rows): a0 = (g, 2t), a1 = (g + 8, 2t),
        // a2 = (g, 2t + 1), a3 = (g + 8, 2t + 1)
        const float* r = xs + (warp * 32 + mt * 16 + g) * kStride + kk + 2 * t;
        const float2 u0 = *reinterpret_cast<const float2*>(r);
        const float2 u1 = *reinterpret_cast<const float2*>(r + 8 * kStride);
        uint32_t ah[4], al[4];
        split(u0.x, ah[0], al[0]);
        split(u1.x, ah[1], al[1]);
        split(u0.y, ah[2], al[2]);
        split(u1.y, ah[3], al[3]);
        xn[mt][0] = fmaf(u0.y, u0.y, fmaf(u0.x, u0.x, xn[mt][0]));
        xn[mt][1] = fmaf(u1.y, u1.y, fmaf(u1.x, u1.x, xn[mt][1]));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma(acc[mt][nt], al, bh[nt]);
          mma(acc[mt][nt], ah, bl[nt]);
          mma(acc[mt][nt], ah, bh[nt]);
        }
      }
    }
    c_stage = c_stage + 1 == kStages ? 0 : c_stage + 1;
    if (++c_kt < KT) continue;

    // epilogue of tile c_tile, while the next tile's slices are in flight
    const int m0 = static_cast<int>(c_tile % tiles_m) * kMaxQ;
    const int n0 = static_cast<int>(c_tile / tiles_m) * kRows;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // over the quad's k's
        xn[mt][h] += __shfl_xor_sync(kFull, xn[mt][h], 1);
        xn[mt][h] += __shfl_xor_sync(kFull, xn[mt][h], 2);
      }
    float qn[NT][2];  // |q|^2 of columns nt * 8 + 2t and + 1
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float v = qp[nt];
      v += __shfl_xor_sync(kFull, v, 1);
      v += __shfl_xor_sync(kFull, v, 2);
      qn[nt][0] = __shfl_sync(kFull, v, 8 * t);      // column 2t
      qn[nt][1] = __shfl_sync(kFull, v, 8 * t + 4);  // column 2t + 1
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gn = n0 + warp * 32 + mt * 16 + h * 8 + g;
        if (gn >= N) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int gm = m0 + nt * 8 + 2 * t + j;
            if (gm < B)
              out[static_cast<size_t>(gm) * N + gn] = finish<METRIC>(
                  acc[mt][nt][2 * h + j], qn[nt][j], xn[mt][h]);
          }
      }
    c_kt = 0;
    c_tile += step;
  }
  cp_wait<0>();  // only empty groups are left; leave none behind
}

// Blocks of one instantiation that fit on an SM of the current device,
// asked once per device (and before any graph capture, by the first call).
template <int METRIC, int NT, bool VEC>
int launch(const float* Q, const float* X, int B, int N, int d, int tiles_m,
           long long n_tiles, float* out, cudaStream_t s) {
  constexpr int kMaxDevices = 64;
  static int per_sm[kMaxDevices] = {};
  static int n_sms[kMaxDevices] = {};
  auto kernel = distance_matrix_kernel<METRIC, NT, VEC>;
  constexpr size_t smem = sizeof(float) * kStages * kStageFloats<NT>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    int fit = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    per_sm[dev] = fit;
  }
  const long long resident = static_cast<long long>(per_sm[dev]) * n_sms[dev];
  const unsigned blocks =
      static_cast<unsigned>(n_tiles < resident ? n_tiles : resident);
  kernel<<<blocks, kThreads, smem, s>>>(Q, X, B, N, d, tiles_m, n_tiles, out);
  return static_cast<int>(cudaGetLastError());
}

template <int METRIC>
int launch_metric(const float* Q, const float* X, int B, int N, int d,
                  int tiles_m, long long n_tiles, bool vec, float* out,
                  cudaStream_t s) {
  const int nq = B < kMaxQ ? B : kMaxQ;  // queries of the widest m-tile
#define DM_LAUNCH(NT)                                                      \
  return vec ? launch<METRIC, NT, true>(Q, X, B, N, d, tiles_m, n_tiles,  \
                                        out, s)                           \
             : launch<METRIC, NT, false>(Q, X, B, N, d, tiles_m, n_tiles, \
                                         out, s)
  if (nq <= 8) DM_LAUNCH(1);
  if (nq <= 16) DM_LAUNCH(2);
  DM_LAUNCH(4);
#undef DM_LAUNCH
}

}  // namespace

// C entry for ctypes. Q (B, d), X (N, d) and out (B, N) are contiguous
// float32 device arrays on the current device; `stream` is the caller's
// cudaStream_t. Returns a CUDA error code: cudaGetLastError() after the
// launch, or the error of the launch's set-up.
extern "C" int distance_matrix_f32(const float* Q, const float* X, int B,
                                   int N, int d, int metric, float* out,
                                   void* stream) {
  if (B < 0 || N < 0 || d < 0 || metric < kL2 || metric > kCos)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const long long tiles_m = (B + kMaxQ - 1) / kMaxQ;
  const long long tiles_n = (N + kRows - 1) / kRows;
  const long long n_tiles = tiles_m * tiles_n;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (d % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(Q) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(X) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tm = static_cast<int>(tiles_m);
  switch (metric) {
    case kL2: return launch_metric<kL2>(Q, X, B, N, d, tm, n_tiles, vec, out, s);
    case kIp: return launch_metric<kIp>(Q, X, B, N, d, tm, n_tiles, vec, out, s);
    default: return launch_metric<kCos>(Q, X, B, N, d, tm, n_tiles, vec, out, s);
  }
}
