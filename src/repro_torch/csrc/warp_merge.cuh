// The warp merge of B.2 (merge_topk.cu), shared with the hop step B.8
// (hop_step.cu): one warp selects the k smallest (dist, id) candidates of
// a row of M <= kSortMax, so both kernels merge a beam by one code.
//
// An entry is one 64-bit key, the order-preserving bits of its dist above
// its position (every sentinel -- id < 0 or a non-finite dist -- the
// all-ones key), so (dist, position) order is one unsigned compare. Each
// lane holds ceil(M/32) rounded up to a power of two (E <= 8) keys in
// registers; a bitonic network sorts them (compare-exchanges inside a lane
// where the pair's stride is below E, else across lanes by
// __shfl_xor_sync, 15 shuffle steps at E = 8): no barrier, no dependence
// on k. The dedup sorts (id, rank) keys, rank being the place in the
// first sort: in each run of one id the first entry survives. It first
// takes only the ranks below min(k, valid entries): if their ids are
// distinct, as in every row the beam merge sends, they are the answer;
// only a row with a duplicate among them pays for the sort of all its
// valid ranks. A warp prefix count of the survivors writes the first k in
// rank order; rows past the survivors come back (+inf, -1, -1). Output
// values are the input's, read back at the winner's position.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace warpmerge {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;  // sentinel: after every key

constexpr int kSortMax = 256;  // widest row the warp sort takes

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

// The key of an entry at position m: its dist's order bits above m, or
// kNone for a sentinel (id < 0 or a non-finite dist).
__device__ __forceinline__ unsigned long long entry_key(float v, int id,
                                                        int m) {
  return id >= 0 && isfinite(v)
             ? (static_cast<unsigned long long>(order_bits(v)) << 32) |
                   static_cast<unsigned>(m)
             : kNone;
}

// The k smallest of the row (d_in, id_in) of M <= 32 * E candidates as
// (od, oi, os), each k long: dist, id and input position of each winner,
// in (dist, position) order, one copy of each id. The whole warp calls
// it; the inputs and outputs may be global or shared memory.
template <int E>
__device__ __forceinline__ void merge_row(const float* d_in,
                                          const int* id_in, int M, int k,
                                          RowSmem& sm, int lane, float* od,
                                          int* oi, int* os) {
  // 1. (dist, position) keys, loaded coalesced (and kept by position in
  // shared memory) and sorted: rank E*lane + j
  unsigned long long key[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int m = 32 * j + lane;
    key[j] = kNone;
    if (m < M) {
      const float v = d_in[m];
      const int id = id_in[m];
      sm.d[m] = v;
      sm.id[m] = id;
      key[j] = entry_key(v, id, m);
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

}  // namespace warpmerge
