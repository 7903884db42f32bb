// One hop step of the lazy HNSW search (Algorithm 1, lines 6-21) for B
// queries in one launch, written by hand for Hopper (sm_90a): B.8.
//
// Replaces no TPU kernel. The reference's hop step is the body of a
// lax.while_loop that XLA fuses into one program
// (src/repro/core/search.py:240-268); the port ran it as ~90 small
// launches (an argmin, gathers, scatters, wheres, a cumsum, B.1 or B.3
// for the distances, B.2 for the merge), each at the launch floor. This
// kernel is the whole step, with B.1's and B.3's distance stage
// (row_distance.cuh) and B.2's warp merge (warp_merge.cuh) inside it, so
// it gives the bits of the per-op step (search.batch_hop_step_plain on
// CUDA tensors).
//
// It computes exactly batch_hop_step(Q, neighbors, state, tier2, metric,
// trigger, max_hops, gate) for a float32, int8 (per-row scales) or
// float16 tier 2, with or without a cache (slot_of, id_of), out of place:
// every output row is written whole, so the inputs stay as they were.
// One block a query:
//   0. stage the beam in shared memory; copy the query's visited row and
//      miss list to the outputs (16-byte copies where the row allows);
//   1. active: an unexplored candidate, miss_count < trigger,
//      n_hops < max_hops and the gate (a () or (B,) bool, or none);
//   2. j: the argmin of the unexplored distances, ties to the lowest
//      index (torch.argmin's rule), 0 with nothing unexplored;
//   3. explored[j] |= active;
//   then, for an active query only:
//   4. the neighbour row of the beam's id at j, clamped to the graph;
//   5. visited test-and-set: fresh = not PAD and not visited; a neighbour
//      row holds no id twice, so a row's bits cannot race;
//   6. tier 2: present and slot through slot_of and the id_of
//      cross-check (the whole table, ids clamped, without a cache);
//   7. the distances of the usable (fresh and present) neighbours, one
//      warp a row, by row_distance.cuh (B.1's float32 path, B.3's
//      dequantized one);
//   8. the merge of the ef-wide beam with the deg new entries (a
//      non-usable one as (+inf, -1)) by warp_merge.cuh, k = ef; explored
//      follows each winner's input position;
//   9. the misses (fresh, not present) appended to L in neighbour-row
//      order, by a warp ballot and a prefix popcount (the cumsum of the
//      per-op step); past the cap they are dropped;
//  10. n_hops += 1, n_dist += usable; visited's spare column n takes
//      False where a slot of the row is not fresh, as the per-op scatter
//      writes each masked slot's own False there.
// An inactive query's outputs are its inputs (the spare column False).
//
// Bound: bytes. A step does a few hundred flops a query besides its
// distances (2-3 flops an element of each usable row), far below the
// card's flops per byte. Each input read once and each output written
// once: the visited rows ((N + 1) bytes a query, in and out: 20 KB at N =
// 10,000), the beam (9 bytes an entry, in and out), the miss list, the
// counters and the query; and for an active query its neighbour row, one
// visited byte, a slot_of and an id_of entry a neighbour, and the usable
// rows (4d, 2d or d + 4 bytes), over 3.35 TB/s. The rows mostly sit in
// the 50 MB L2 (the tier-2 slab is a few MB), so what the kernel pays is
// latency: its dependent steps are a handful of global reads (neighbour
// row, visited byte, slot_of, id_of, the rows) and one warp sort.
//
// Design: 8 warps a block. Every warp copies; warp 0 alone runs steps 1-6
// and 8-9 (a beam of at most 255 entries is a few register keys a lane;
// neighbours 32 at a time, one a lane); step 7 spreads the usable rows
// over the 8 warps with 16-byte loads. There is no host sync and no
// allocation, so a CUDA graph captures the launch like any other.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "row_distance.cuh"
#include "warp_merge.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPad = -1;  // graph.PAD: an absent neighbour slot
// widest merge row, ef + deg: the warp merge's limit
constexpr int kMaxRow = warpmerge::kSortMax;

enum Elem { kF32 = 0, kI8 = 1, kF16 = 2 };

struct HopArgs {
  // inputs
  const float* Q;  // (B, d)
  const int* neighbors;  // (n_nodes, deg)
  const int* beam_ids;  // (B, ef)
  const float* beam_dists;
  const unsigned char* explored;
  const unsigned char* visited;  // (B, n_nodes + 1)
  const int* miss_ids;  // (B, cap)
  const long long* miss_count;  // (B,)
  const long long* n_hops;
  const long long* n_dist;
  const void* table;  // (n_rows, d)
  const float* scales;  // (n_rows,) for int8, else null
  const int* slot_of;  // (n_slot_of,), null without a cache
  const int* id_of;  // (n_rows,)
  const unsigned char* gate;  // null, or gate[b * gate_stride]
  // outputs
  int* o_ids;
  float* o_dists;
  unsigned char* o_explored;
  unsigned char* o_visited;
  int* o_miss_ids;
  long long* o_miss_count;
  long long* o_n_hops;
  long long* o_n_dist;
  unsigned char* o_active;
  long long trigger, max_hops;
  int d, n_nodes, deg, ef, cap, n_rows, n_slot_of, gate_stride, metric;
  bool vec;  // 16-byte loads of table rows and queries
  bool copy16;  // visited rows in and out share their offset mod 16
};

__device__ __forceinline__ long long clamp_ll(long long v, long long lo,
                                              long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// dst[0, n) = src[0, n) by the block; 16 bytes a thread where src and dst
// share their offset mod 16, bytes at the ragged ends.
__device__ __forceinline__ void copy_bytes(const unsigned char* src,
                                           unsigned char* dst, size_t n,
                                           bool copy16, int tid) {
  size_t head = n;
  if (copy16) {
    head = (16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15;
    head = head < n ? head : n;
    const size_t n16 = (n - head) / 16;
    const int4* s4 = reinterpret_cast<const int4*>(src + head);
    int4* d4 = reinterpret_cast<int4*>(dst + head);
    for (size_t i = tid; i < n16; i += kThreads) d4[i] = s4[i];
    for (size_t i = head + n16 * 16 + tid; i < n; i += kThreads)
      dst[i] = src[i];
  }
  for (size_t i = tid; i < head; i += kThreads) dst[i] = src[i];
}

// The distance of tier-2 row `row` to the query q (the whole warp).
template <int ELEM>
__device__ __forceinline__ float distance(const HopArgs& a, int row,
                                          const float* q, int lane) {
  using rowdist::kCos;
  using rowdist::kIp;
  using rowdist::kL2;
  if constexpr (ELEM == kF32) {
    const float* x =
        static_cast<const float*>(a.table) + static_cast<size_t>(row) * a.d;
    if (a.metric == kL2) return rowdist::f32_row<kL2>(x, q, a.d, a.vec, lane);
    if (a.metric == kIp) return rowdist::f32_row<kIp>(x, q, a.d, a.vec, lane);
    return rowdist::f32_row<kCos>(x, q, a.d, a.vec, lane);
  } else {
    constexpr int R = ELEM == kI8 ? rowdist::kInt8 : rowdist::kHalf;
    using S = typename rowdist::Elt<R>::S;
    const S* x = static_cast<const S*>(a.table) + static_cast<size_t>(row) * a.d;
    const float s = rowdist::row_scale(a.scales, row, lane);
    if (a.metric == kL2)
      return rowdist::dequant_row<kL2, R>(x, s, q, a.d, a.vec, lane);
    if (a.metric == kIp)
      return rowdist::dequant_row<kIp, R>(x, s, q, a.d, a.vec, lane);
    return rowdist::dequant_row<kCos, R>(x, s, q, a.d, a.vec, lane);
  }
}

template <int ELEM, int E>
__global__ void __launch_bounds__(kThreads)
hop_step_kernel(const __grid_constant__ HopArgs a) {
  __shared__ float cand_d[kMaxRow];  // the merge's row: beam, then new
  __shared__ int cand_id[kMaxRow];
  __shared__ unsigned char expl[kMaxRow];  // the beam's flags, j marked
  __shared__ int nbr[kMaxRow];  // the neighbour row
  __shared__ int slot[kMaxRow];  // tier-2 row of a usable neighbour, or -1
  __shared__ float out_d[kMaxRow];
  __shared__ int out_i[kMaxRow];
  __shared__ int out_s[kMaxRow];
  __shared__ warpmerge::RowSmem msm;
  __shared__ int s_active;
  __shared__ int s_c;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ef = a.ef;
  const int deg = a.deg;
  const int cap = a.cap;
  const size_t W = static_cast<size_t>(a.n_nodes) + 1;
  const size_t be = static_cast<size_t>(b) * ef;

  // 0. the beam into shared memory; visited and L copied to the outputs
  for (int i = tid; i < ef; i += kThreads) {
    cand_d[i] = a.beam_dists[be + i];
    cand_id[i] = a.beam_ids[be + i];
    expl[i] = a.explored[be + i];
  }
  copy_bytes(a.visited + b * W, a.o_visited + b * W, W, a.copy16, tid);
  const size_t bc = static_cast<size_t>(b) * cap;
  for (int i = tid; i < cap; i += kThreads)
    a.o_miss_ids[bc + i] = a.miss_ids[bc + i];
  __syncthreads();

  // 1-3. active test, the pick, its mark
  if (warp == 0) {
    float bv = CUDART_INF_F;
    int bi = INT_MAX;
    bool any = false;
    for (int i = lane; i < ef; i += 32) {
      const bool un = cand_id[i] >= 0 && !expl[i];
      any |= un;
      const float v = un ? cand_d[i] : CUDART_INF_F;
      if (v < bv || (v == bv && i < bi)) {
        bv = v;
        bi = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFullMask, bv, off);
      const int oi = __shfl_xor_sync(kFullMask, bi, off);
      if (ov < bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    any = __any_sync(kFullMask, any);
    if (lane == 0) {
      bool act = any && a.miss_count[b] < a.trigger && a.n_hops[b] < a.max_hops;
      if (a.gate != nullptr)
        act = act && a.gate[static_cast<size_t>(b) * a.gate_stride];
      s_active = act;
      s_c = cand_id[bi];
      expl[bi] = expl[bi] | static_cast<unsigned char>(act);
    }
  }
  __syncthreads();

  if (!s_active) {  // the state as it was
    for (int i = tid; i < ef; i += kThreads) {
      a.o_ids[be + i] = cand_id[i];
      a.o_dists[be + i] = cand_d[i];
      a.o_explored[be + i] = expl[i];
    }
    if (tid == 0) {
      if (deg > 0) a.o_visited[b * W + a.n_nodes] = 0;
      a.o_miss_count[b] = a.miss_count[b];
      a.o_n_hops[b] = a.n_hops[b];
      a.o_n_dist[b] = a.n_dist[b];
      a.o_active[b] = 0;
    }
    return;  // the whole block: s_active is the block's
  }

  // 4-6, 9-10. neighbours, visited, tier 2, misses, counters (warp 0)
  if (warp == 0) {
    const long long crow = clamp_ll(s_c, 0, a.n_nodes - 1);
    const int* row = a.neighbors + crow * deg;
    const long long mc = a.miss_count[b];
    int n_usable = 0, n_missing = 0;
    bool nonfresh = false;
    for (int t0 = 0; t0 < deg; t0 += 32) {
      const int t = t0 + lane;
      bool fresh = false, present = false;
      int nb = kPad, sl = -1;
      if (t < deg) {
        nb = row[t];
        fresh = nb != kPad && !a.visited[b * W + nb];
        if (fresh) {
          a.o_visited[b * W + nb] = 1;
          if (a.slot_of == nullptr) {
            present = true;
            sl = static_cast<int>(clamp_ll(nb, 0, a.n_rows - 1));
          } else {
            const int s0 = a.slot_of[clamp_ll(nb, 0, a.n_slot_of - 1)];
            sl = static_cast<int>(clamp_ll(s0, 0, a.n_rows - 1));
            present = s0 >= 0 && a.id_of[sl] == nb;
          }
        }
        nbr[t] = nb;
        slot[t] = fresh && present ? sl : -1;
      }
      const bool missing = fresh && !present;
      const unsigned used = __ballot_sync(kFullMask, fresh && present);
      const unsigned miss = __ballot_sync(kFullMask, missing);
      nonfresh |= __ballot_sync(kFullMask, t < deg && !fresh) != 0;
      if (missing) {
        const long long pos =
            mc + n_missing + __popc(miss & ((1u << lane) - 1u));
        if (pos < cap) a.o_miss_ids[bc + pos] = nb;
      }
      n_usable += __popc(used);
      n_missing += __popc(miss);
    }
    if (lane == 0) {
      if (nonfresh) a.o_visited[b * W + a.n_nodes] = 0;
      const long long m = mc + n_missing;
      a.o_miss_count[b] = m < cap ? m : cap;
      a.o_n_hops[b] = a.n_hops[b] + 1;
      a.o_n_dist[b] = a.n_dist[b] + n_usable;
      a.o_active[b] = 1;
    }
  }
  __syncthreads();

  // 7. the usable rows' distances, a warp a row
  const float* q = a.Q + static_cast<size_t>(b) * a.d;
  for (int t = warp; t < deg; t += kWarps) {
    const int sl = slot[t];
    float dist = CUDART_INF_F;
    int id = -1;
    if (sl >= 0) {
      dist = distance<ELEM>(a, sl < a.n_rows ? sl : a.n_rows - 1, q, lane);
      id = nbr[t];
    }
    if (lane == 0) {
      cand_d[ef + t] = dist;
      cand_id[ef + t] = id;
    }
  }
  __syncthreads();

  // 8. the merge, k = ef; explored follows each winner's position
  if (warp == 0) {
    warpmerge::merge_row<E>(cand_d, cand_id, ef + deg, ef, msm, lane, out_d,
                            out_i, out_s);
    __syncwarp();
    for (int r = lane; r < ef; r += 32) {
      const int src = out_s[r];
      a.o_ids[be + r] = out_i[r];
      a.o_dists[be + r] = out_d[r];
      a.o_explored[be + r] = src >= 0 && src < ef && expl[src];
    }
  }
}

template <int ELEM>
cudaError_t launch(const HopArgs& a, int B, cudaStream_t s) {
  const int M = a.ef + a.deg;
  if (M <= 32)
    hop_step_kernel<ELEM, 1><<<B, kThreads, 0, s>>>(a);
  else if (M <= 64)
    hop_step_kernel<ELEM, 2><<<B, kThreads, 0, s>>>(a);
  else if (M <= 128)
    hop_step_kernel<ELEM, 4><<<B, kThreads, 0, s>>>(a);
  else
    hop_step_kernel<ELEM, 8><<<B, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes. All pointers are device pointers; `elem` is 0 for a
// float32 table, 1 for int8 (with `scales`), 2 for float16; `slot_of` and
// `id_of` are null without a cache; `gate` is null or a bool read at
// b * gate_stride (0 for one gate for all); `stream` is the caller's
// cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int hop_step(
    const float* Q, int d, const int* neighbors, int n_nodes, int deg,
    const int* beam_ids, const float* beam_dists,
    const unsigned char* explored, int ef, const unsigned char* visited,
    const int* miss_ids, int cap, const long long* miss_count,
    const long long* n_hops, const long long* n_dist, const void* table,
    int elem, const float* scales, int n_rows, const int* slot_of,
    int n_slot_of, const int* id_of, const unsigned char* gate,
    int gate_stride, long long trigger, long long max_hops, int metric,
    int B, int* o_ids, float* o_dists, unsigned char* o_explored,
    unsigned char* o_visited, int* o_miss_ids, long long* o_miss_count,
    long long* o_n_hops, long long* o_n_dist, unsigned char* o_active,
    void* stream) {
  if (B == 0) return 0;
  if (B < 0 || ef < 1 || deg < 0 || ef + deg > kMaxRow || n_nodes < 1 ||
      n_rows < 1 || d < 1 || cap < 0 || metric < 0 || metric > 2 ||
      (slot_of != nullptr && (id_of == nullptr || n_slot_of < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  HopArgs a;
  a.Q = Q;
  a.neighbors = neighbors;
  a.beam_ids = beam_ids;
  a.beam_dists = beam_dists;
  a.explored = explored;
  a.visited = visited;
  a.miss_ids = miss_ids;
  a.miss_count = miss_count;
  a.n_hops = n_hops;
  a.n_dist = n_dist;
  a.table = table;
  a.scales = scales;
  a.slot_of = slot_of;
  a.id_of = id_of;
  a.gate = gate;
  a.o_ids = o_ids;
  a.o_dists = o_dists;
  a.o_explored = o_explored;
  a.o_visited = o_visited;
  a.o_miss_ids = o_miss_ids;
  a.o_miss_count = o_miss_count;
  a.o_n_hops = o_n_hops;
  a.o_n_dist = o_n_dist;
  a.o_active = o_active;
  a.trigger = trigger;
  a.max_hops = max_hops;
  a.d = d;
  a.n_nodes = n_nodes;
  a.deg = deg;
  a.ef = ef;
  a.cap = cap;
  a.n_rows = n_rows;
  a.n_slot_of = n_slot_of;
  a.gate_stride = gate_stride;
  a.metric = metric;
  a.copy16 = (reinterpret_cast<uintptr_t>(visited) & 15) ==
             (reinterpret_cast<uintptr_t>(o_visited) & 15);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem) {
    case kF32:
      a.vec = rowdist::vec_loads(table, Q, d, 4);
      return static_cast<int>(launch<kF32>(a, B, s));
    case kI8:
      if (scales == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      a.vec = rowdist::vec_loads(table, Q, d, 1);
      return static_cast<int>(launch<kI8>(a, B, s));
    case kF16:
      a.vec = rowdist::vec_loads(table, Q, d, 2);
      return static_cast<int>(launch<kF16>(a, B, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
