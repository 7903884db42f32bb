// Padded multi-hot embedding bag for the recsys substrate, written by hand
// for Hopper (sm_90a).
//
// Replaces src/repro/kernels/embedding_bag.py :: embedding_bag_pallas, and
// the weighted bags that the reference's dispatch sends to its plain
// embedding_bag_ref (src/repro/kernels/ops.py:144-149), so no plain version
// runs on the card's path.
//
// out[b, :] = sum over the slots s = 0..S-1 with idx[b, s] >= 0 of
//             w[b, s] * float(table[min(idx[b, s], V - 1), :])
// with w = 1 where no weights are given. Each column is summed from +0.0 in
// slot order, one __fadd_rn a slot (after one __fmul_rn by the weight), the
// order of the Pallas kernel's revisited output block, so the kernel and
// its plain version (kernels/ref.py::embedding_bag_ref) agree bit for bit.
// "mean" divides by max(sum of w over the valid slots, 1e-9) with
// __fdiv_rn, the count summed in slot order too; a bag of nothing but
// padding gives 0. Ids at or above V read row V - 1, as the reference's
// oracle clips (its Pallas index_map clamps only at 0). Tables are float32,
// float16 or bfloat16, widened to float32 in registers; ids int32 or int64.
//
// Bound: bytes. Each valid slot reads one d-wide row for one add a column
// (two with a weight), far below the card's ~20 float32 operations a byte;
// the least time is each distinct row read once, plus the ids and the
// output, over 3.35 TB/s. Design: a bag's columns go across a group of
// threads, one 16-byte float4 (or an 8-byte group of four 16-bit values)
// a thread where d % 4 == 0 and the row is aligned, one value otherwise;
// at d = 64 (DLRM-RM2) a group is 16 lanes, two bags a warp. The lanes of
// a group read one slot id (and weight) each, coalesced, and broadcast them
// with __shfl_sync; four slots' rows are loaded before their adds so the
// loads overlap. Ragged B, S and d are masked in the kernel: no padded copy
// of the table is made, and a padded slot reads no row.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kUnroll = 4;         // slots whose rows are loaded together
constexpr int kBlockThreads = 64;  // a block of small groups; larger
                                   // groups take a block each
constexpr int kMaxGroup = 1024;

enum Dtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

template <typename T>
__device__ __forceinline__ float bits_to_f32(unsigned short u);
template <>
__device__ __forceinline__ float bits_to_f32<__half>(unsigned short u) {
  return __half2float(__ushort_as_half(u));
}
template <>
__device__ __forceinline__ float bits_to_f32<__nv_bfloat16>(unsigned short u) {
  return __bfloat162float(__ushort_as_bfloat16(u));
}

// VEC consecutive values of a row, widened to float32 (exact).
template <typename T, int VEC>
struct Row {
  static __device__ __forceinline__ void load(const T* p, float (&x)[VEC]) {
    if constexpr (VEC == 1) {
      x[0] = bits_to_f32<T>(__ldg(reinterpret_cast<const unsigned short*>(p)));
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      x[0] = bits_to_f32<T>(static_cast<unsigned short>(v.x & 0xffffu));
      x[1] = bits_to_f32<T>(static_cast<unsigned short>(v.x >> 16));
      x[2] = bits_to_f32<T>(static_cast<unsigned short>(v.y & 0xffffu));
      x[3] = bits_to_f32<T>(static_cast<unsigned short>(v.y >> 16));
    }
  }
};

template <int VEC>
struct Row<float, VEC> {
  static __device__ __forceinline__ void load(const float* p,
                                              float (&x)[VEC]) {
    if constexpr (VEC == 1) {
      x[0] = __ldg(p);
    } else {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    }
  }
};

// One group of `group` threads a bag; a group of 32 or fewer lies inside
// one warp (its shuffle segment), a larger one spans whole warps, each of
// which reads the slot ids for itself.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxGroup)
embedding_bag_kernel(const T* __restrict__ table, int V, int d,
                     const void* __restrict__ idx, int idx64,
                     const float* __restrict__ weights, int B, int S,
                     int group, int mean, float* __restrict__ out) {
  const int bags_per_block = blockDim.x / group;
  const long long b =
      static_cast<long long>(blockIdx.x) * bags_per_block + threadIdx.x / group;
  const int t = threadIdx.x % group;
  const int width = group < 32 ? group : 32;  // the shuffle segment
  const int seg_lane = threadIdx.x & (width - 1);
  const bool bag_ok = b < B;
  const int C = d / VEC;  // VEC divides d (the host picks VEC = 1 otherwise)
  // every loop bound below is the same for the whole warp, so every lane
  // reaches each __shfl_sync; a lane with nothing to do reads no row
  for (int c0 = 0; c0 < C; c0 += group) {
    const int j = c0 + t;
    const bool col_ok = bag_ok && j < C;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    float cnt = 0.f;
    for (int s0 = 0; s0 < S; s0 += width) {
      const int my_s = s0 + seg_lane;
      int my_id = -1;
      float my_w = 1.f;
      if (bag_ok && my_s < S) {
        const long long flat = b * S + my_s;
        const long long v =
            idx64 ? static_cast<const long long*>(idx)[flat]
                  : static_cast<long long>(static_cast<const int*>(idx)[flat]);
        my_id = v < 0 ? -1 : (v >= V ? V - 1 : static_cast<int>(v));
        if (weights != nullptr) my_w = weights[flat];
      }
      const int n = min(width, S - s0);
      for (int u = 0; u < n; u += kUnroll) {
        float x[kUnroll][VEC];
        int id[kUnroll];
        float w[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int src = (u + k) & (width - 1);
          id[k] = __shfl_sync(kFullMask, my_id, src, width);
          w[k] = __shfl_sync(kFullMask, my_w, src, width);
          if (u + k >= n || !col_ok) id[k] = -1;
          if (id[k] >= 0) {
            Row<T, VEC>::load(
                table + static_cast<size_t>(id[k]) * d +
                    static_cast<size_t>(j) * VEC,
                x[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {  // slot order: u, u + 1, ...
          if (id[k] < 0) continue;  // padding contributes nothing
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            acc[e] = weights != nullptr
                         ? __fadd_rn(acc[e], __fmul_rn(x[k][e], w[k]))
                         : __fadd_rn(acc[e], x[k][e]);
          }
          cnt = __fadd_rn(cnt, w[k]);
        }
      }
    }
    if (col_ok) {
      if (mean) {
        const float den = fmaxf(cnt, 1e-9f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = __fdiv_rn(acc[e], den);
      }
      float* o = out + b * d + static_cast<long long>(j) * VEC;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2],
                                                    acc[3]);
      } else {
        o[0] = acc[0];
      }
    }
  }
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <typename T>
int launch(const void* table, int V, int d, const void* idx, int idx64,
           const float* weights, int B, int S, int mean, float* out,
           cudaStream_t stream) {
  // 4-wide loads where a row is a whole number of aligned 4-vectors
  const size_t align = 4 * sizeof(T);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % align == 0;
  const int C = vec ? d / 4 : d;
  const int group =
      C <= 32 ? next_pow2(C) : std::min(kMaxGroup, (C + 31) / 32 * 32);
  const int bags_per_block = group < kBlockThreads ? kBlockThreads / group : 1;
  const dim3 block(group * bags_per_block);
  const dim3 grid(static_cast<unsigned>(
      (static_cast<long long>(B) + bags_per_block - 1) / bags_per_block));
  const T* tab = static_cast<const T*>(table);
  if (vec) {
    embedding_bag_kernel<T, 4><<<grid, block, 0, stream>>>(
        tab, V, d, idx, idx64, weights, B, S, group, mean, out);
  } else {
    embedding_bag_kernel<T, 1><<<grid, block, 0, stream>>>(
        tab, V, d, idx, idx64, weights, B, S, group, mean, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes. All pointers are device pointers (`weights` may be
// null: no weights); `dtype` is 0 float32, 1 float16, 2 bfloat16; `idx64`
// is 1 for int64 ids, 0 for int32; `mean` is 1 for the mean combiner;
// `stream` is the caller's cudaStream_t. Returns cudaGetLastError() after
// the launch.
extern "C" int embedding_bag(const void* table, int dtype, int V, int d,
                             const void* idx, int idx64, const float* weights,
                             int B, int S, int mean, float* out,
                             void* stream) {
  if (B == 0 || d == 0) return 0;
  if (V <= 0 || B < 0 || S < 0 || d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(table, V, d, idx, idx64, weights, B, S, mean, out,
                           s);
    case kF16:
      return launch<__half>(table, V, d, idx, idx64, weights, B, S, mean, out,
                            s);
    case kBF16:
      return launch<__nv_bfloat16>(table, V, d, idx, idx64, weights, B, S,
                                   mean, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
