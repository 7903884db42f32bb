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
//   7. the distances of the usable (fresh and present) neighbours, by
//      row_distance.cuh (B.1's float32 path, B.3's dequantized one);
//   8. the merge of the ef-wide beam with the deg new entries (a
//      non-usable one as (+inf, -1)), k = ef: warp_merge.cuh's merge_row
//      result, its dedup included; explored follows each winner's input
//      position;
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
// latency: a chain of dependent global reads, then the merge.
//
// Design: 8 warps a block, the chain kept short.
//  - Warps 1-7 copy the visited row and L while warp 0 runs steps 1-6:
//    the copy is off the chain. The fresh bytes are written after the
//    barrier that follows the copy, so a copied 0 never lands on a 1.
//  - Warp 0 reads the beam (and the counters and gate, which wait for
//    nothing), picks, reads the neighbour row, then each neighbour's
//    visited byte and its slot_of entry side by side: visited is read
//    from the input, which no one writes, so it needs no copy to land.
//    The chain to the rows is three global round trips.
//  - Step 7 lists the candidate rows (fresh, and slot_of >= 0 with a
//    cache) and spreads them over the 8 warps, 4 a warp, each warp's rows
//    loaded all together (row_distance.cuh's f32_rows / dequant_rows),
//    each row's id_of check read beside it: present = the check holds.
//  - Step 8 sorts nothing: the merge row has at most 256 entries, one a
//    thread, and each thread ranks its entry's (dist, position) key by
//    counting smaller keys in shared memory. A beam in key order, as
//    every step, seed and load phase leaves it, needs only the new keys
//    counted (a beam entry's rank in the beam is its position, a new
//    entry's a binary search); a beam out of order has the whole row
//    counted. Warps 1-7 key the beam and check its order after their
//    copy, off the chain. A hash set of the winners' ids in shared
//    memory finds a repeated id; a row with one takes merge_row
//    (warp_merge.cuh, B.2's code) on warp 0, its dedup included. One
//    warp sorting the same row takes about half of a step (PERF.md §6).
//    Warp 1 then appends the misses and writes the counters.
// There is no host sync and no allocation, so a CUDA graph captures the
// launch like any other.
//
// Timing: hop_step_stamps launches the float32 kernel's TIMED
// instantiation, which writes clock64() at the stage boundaries (kStamps a
// query) to a small device buffer; hop_step_floor launches an empty kernel
// of the same grid (the launch floor) and hop_step_clock measures the SM
// clock against the global timer. The engine launches none of them.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "row_distance.cuh"
#include "warp_merge.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCopiers = kThreads - 32;  // warps 1-7 copy while warp 0 looks up
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPad = -1;  // graph.PAD: an absent neighbour slot
// widest merge row, ef + deg: the warp merge's limit
constexpr int kMaxRow = warpmerge::kSortMax;
// a neighbour row is read 32 slots a pass: at most kMaxRow / 32 passes
constexpr int kPasses = kMaxRow / 32;
// step 7: the rows a warp has in flight together, and the 16-byte chunks
// (or elements) of each a lane loads before summing: all of a 768-wide
// row at every precision
constexpr int kRowsInFlight = 4;

enum Elem { kF32 = 0, kI8 = 1, kF16 = 2 };

template <int ELEM>
constexpr int kChunksInFlight = ELEM == kF32 ? 6 : (ELEM == kI8 ? 2 : 3);

// the stage boundaries a timed launch stamps, in cycles of the block's SM:
// 0 start, 1 step 0 (the copy, by warp 1's first lane), 2 steps 1-3, 3
// steps 4-6 (the lookups, and the copy landed), 4 step 7, 5 step 8; an
// inactive query stamps 0-2
constexpr int kStamps = 6;

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
  long long* stamps;  // (B, kStamps) for the TIMED instantiation, else null
};

// clock64() into stamp i of query b, by the calling thread (TIMED only)
template <bool TIMED>
__device__ __forceinline__ void stamp(const HopArgs& a, int b, int i) {
  if constexpr (TIMED) a.stamps[static_cast<size_t>(b) * kStamps + i] = clock64();
}

__device__ __forceinline__ long long clamp_ll(long long v, long long lo,
                                              long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// dst[0, n) = src[0, n) by `threads` threads (this one `idx`); 16 bytes a
// thread where src and dst share their offset mod 16, bytes at the ragged
// ends. A thread's loads go out kCopyBatch at a time, before its stores.
constexpr int kCopyBatch = 4;
__device__ __forceinline__ void copy_bytes(const unsigned char* src,
                                           unsigned char* dst, size_t n,
                                           bool copy16, int idx,
                                           int threads) {
  size_t head = n;
  if (copy16) {
    head = (16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15;
    head = head < n ? head : n;
    const size_t n16 = (n - head) / 16;
    const int4* s4 = reinterpret_cast<const int4*>(src + head);
    int4* d4 = reinterpret_cast<int4*>(dst + head);
    for (size_t i0 = idx; i0 < n16; i0 += kCopyBatch * threads) {
      int4 v[kCopyBatch];
#pragma unroll
      for (int c = 0; c < kCopyBatch; ++c)
        if (i0 + c * threads < n16) v[c] = s4[i0 + c * threads];
#pragma unroll
      for (int c = 0; c < kCopyBatch; ++c)
        if (i0 + c * threads < n16) d4[i0 + c * threads] = v[c];
    }
    for (size_t i = head + n16 * 16 + idx; i < n; i += threads)
      dst[i] = src[i];
  }
  for (size_t i = idx; i < head; i += threads) dst[i] = src[i];
}

// Step 8's hash set of ids (at most kMaxRow in kIdSlots slots, -1 empty):
// inserts `id` (>= 0) and returns whether it was there already.
constexpr int kIdSlots = 2 * kMaxRow;
__device__ __forceinline__ bool id_seen(int* set, int id) {
  unsigned h = (static_cast<unsigned>(id) * 2654435761u) >> 23;  // 9 bits
  while (true) {
    const int prev = atomicCAS(set + h, -1, id);
    if (prev == -1) return false;
    if (prev == id) return true;
    h = (h + 1) & (kIdSlots - 1);
  }
}

// The distances to the query q of the nr <= kRowsInFlight tier-2 rows
// sl[0..nr) (the whole warp): B.1's and B.3's distance stage, all the
// rows' loads in flight together.
template <int ELEM>
__device__ __forceinline__ void distances(const HopArgs& a,
                                          const int (&sl)[kRowsInFlight],
                                          int nr, const float* q, int lane,
                                          float (&out)[kRowsInFlight]) {
  using rowdist::kCos;
  using rowdist::kIp;
  using rowdist::kL2;
  constexpr int R = kRowsInFlight;
  constexpr int U = kChunksInFlight<ELEM>;
  if constexpr (ELEM == kF32) {
    const float* x[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      x[r] = static_cast<const float*>(a.table) +
             static_cast<size_t>(sl[r < nr ? r : 0]) * a.d;
    if (a.metric == kL2)
      rowdist::f32_rows<kL2, R, U>(x, nr, q, a.d, a.vec, lane, out);
    else if (a.metric == kIp)
      rowdist::f32_rows<kIp, R, U>(x, nr, q, a.d, a.vec, lane, out);
    else
      rowdist::f32_rows<kCos, R, U>(x, nr, q, a.d, a.vec, lane, out);
  } else {
    constexpr int K = ELEM == kI8 ? rowdist::kInt8 : rowdist::kHalf;
    using S = typename rowdist::Elt<K>::S;
    const S* x[R];
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = sl[r < nr ? r : 0];
      x[r] = static_cast<const S*>(a.table) + static_cast<size_t>(row) * a.d;
      // every lane reads the scale (one broadcast load): row_scale's value
      s[r] = a.scales == nullptr ? 1.0f : __ldg(a.scales + row);
    }
    if (a.metric == kL2)
      rowdist::dequant_rows<kL2, K, R, U>(x, s, nr, q, a.d, a.vec, lane, out);
    else if (a.metric == kIp)
      rowdist::dequant_rows<kIp, K, R, U>(x, s, nr, q, a.d, a.vec, lane, out);
    else
      rowdist::dequant_rows<kCos, K, R, U>(x, s, nr, q, a.d, a.vec, lane,
                                           out);
  }
}

template <int ELEM, int E, bool TIMED>
__global__ void __launch_bounds__(kThreads)
hop_step_kernel(const __grid_constant__ HopArgs a) {
  __shared__ float cand_d[kMaxRow];  // the merge's row: beam, then new
  __shared__ int cand_id[kMaxRow];
  __shared__ unsigned char expl[kMaxRow];  // the beam's flags, j marked
  __shared__ int nbr[kMaxRow];  // the neighbour row
  __shared__ unsigned char fresh_at[kMaxRow];  // by slot: fresh
  __shared__ unsigned char present_at[kMaxRow];  // by slot: fresh, present
  __shared__ unsigned char row_t[kMaxRow];  // by candidate row: its slot
  __shared__ int row_sl[kMaxRow];  // by candidate row: its tier-2 row
  __shared__ unsigned long long keys[kMaxRow];  // the row's merge keys
  __shared__ int id_set[kIdSlots];  // the winners' ids, open addressing
  // step 8's counts, a slot a warp (each warp writes its own: no reset):
  // the beam's valid keys and pairs out of order (warps 1-7), the valid
  // new keys (step 7)
  __shared__ int w_beam_valid[kWarps], w_beam_unsorted[kWarps];
  __shared__ int w_new_valid[kWarps];
  __shared__ int out_s[kMaxRow];  // merge_row's winners' positions
  __shared__ warpmerge::RowSmem msm;
  __shared__ int s_active;
  __shared__ int s_rows;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ef = a.ef;
  const int deg = a.deg;
  const int cap = a.cap;
  const size_t W = static_cast<size_t>(a.n_nodes) + 1;
  const size_t be = static_cast<size_t>(b) * ef;
  const size_t bc = static_cast<size_t>(b) * cap;
  const unsigned lt = (1u << lane) - 1u;  // the lanes below this one
  if (tid == 0) stamp<TIMED>(a, b, 0);

  // warp 0's neighbour slots, 32 a pass: id, fresh; warp 1's counters
  int nb[kPasses];
  long long mc1 = 0, hops1 = 0, dist1 = 0;
  unsigned fresh_bits = 0;  // bit p: slot 32p + lane is fresh
  bool nonfresh = false;
  if (warp == 0) {
    // 1-3. the beam staged, the active test, the pick and its mark; lane
    // 0's scalars first, as they wait for nothing
    long long mc = 0, hops = 0;
    bool gate = true;
    if (lane == 0) {
      mc = a.miss_count[b];
      hops = a.n_hops[b];
      if (a.gate != nullptr)
        gate = a.gate[static_cast<size_t>(b) * a.gate_stride];
    }
    float bd[kPasses];
    int bids[kPasses];
    unsigned char bex[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {  // every load in flight at once
      const int i = 32 * p + lane;
      if (i < ef) {
        bd[p] = a.beam_dists[be + i];
        bids[p] = a.beam_ids[be + i];
        bex[p] = a.explored[be + i];
      }
    }
    float bv = CUDART_INF_F;
    int bi = INT_MAX, bid = -1;
    bool any = false;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int i = 32 * p + lane;
      if (i >= ef) break;
      const float v0 = bd[p];
      const int id = bids[p];
      const unsigned char e = bex[p];
      cand_d[i] = v0;
      cand_id[i] = id;
      expl[i] = e;
      const bool un = id >= 0 && !e;
      any |= un;
      const float v = un ? v0 : CUDART_INF_F;
      if (v < bv || (v == bv && i < bi)) {
        bv = v;
        bi = i;
        bid = id;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFullMask, bv, off);
      const int oi = __shfl_xor_sync(kFullMask, bi, off);
      const int oid = __shfl_xor_sync(kFullMask, bid, off);
      if (ov < bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
        bid = oid;
      }
    }
    any = __any_sync(kFullMask, any);
    __syncwarp();  // the staged flags, before lane 0 marks one
    bool act = false;
    if (lane == 0) {
      act = any && mc < a.trigger && hops < a.max_hops && gate;
      expl[bi] = expl[bi] | static_cast<unsigned char>(act);
      s_active = act;
      stamp<TIMED>(a, b, 2);
    }
    act = __shfl_sync(kFullMask, act, 0);

    // 4-6. the neighbour row, clamped to the graph; then, side by side,
    // each neighbour's visited byte (of the input, which no one writes)
    // and its tier-2 slot: fresh = not PAD and not visited; a candidate
    // row = fresh and (without a cache) the id clamped to the table, or
    // (with one) slot_of >= 0. Its id_of check comes in step 7, beside
    // the row.
    if (act) {
      const long long crow = clamp_ll(bid, 0, a.n_nodes - 1);
      const int* row = a.neighbors + crow * deg;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int t = 32 * p + lane;
        nb[p] = t < deg ? row[t] : kPad;
      }
      bool seen[kPasses];
      int s0[kPasses];
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const bool valid = nb[p] != kPad;
        seen[p] = !valid || a.visited[b * W + nb[p]];
        s0[p] = valid && a.slot_of != nullptr
                    ? a.slot_of[clamp_ll(nb[p], 0, a.n_slot_of - 1)]
                    : 0;
      }
      int n_rows = 0;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        if (32 * p >= deg) break;
        const int t = 32 * p + lane;
        const bool fresh = t < deg && !seen[p];
        bool cand = fresh;
        int sl = 0;
        if (fresh) {
          const long long at = a.slot_of == nullptr ? nb[p] : s0[p];
          cand = a.slot_of == nullptr || s0[p] >= 0;
          sl = static_cast<int>(clamp_ll(at, 0, a.n_rows - 1));
        }
        const unsigned cm = __ballot_sync(kFullMask, cand);
        if (cand) {
          const int u = n_rows + __popc(cm & lt);
          row_t[u] = static_cast<unsigned char>(t);
          row_sl[u] = sl;
        }
        n_rows += __popc(cm);
        nonfresh |= __ballot_sync(kFullMask, t < deg && !fresh) != 0;
        fresh_bits |= static_cast<unsigned>(fresh) << p;
        if (t < deg) {
          nbr[t] = nb[p];
          fresh_at[t] = fresh;
          present_at[t] = 0;
          cand_d[ef + t] = CUDART_INF_F;  // (+inf, -1) unless step 7 finds it
          cand_id[ef + t] = -1;
          keys[ef + t] = warpmerge::kNone;
        }
      }
      if (lane == 0) s_rows = n_rows;
    }
  } else {
    // 0. the visited row and L copied to the outputs by warps 1-7 (warp
    // 1 first reads the counters it writes in step 10)
    if (warp == 1) {
      mc1 = a.miss_count[b];
      hops1 = a.n_hops[b];
      dist1 = a.n_dist[b];
    }
    copy_bytes(a.visited + b * W, a.o_visited + b * W, W, a.copy16, tid - 32,
               kCopiers);
    for (int i = tid - 32; i < cap; i += kCopiers)
      a.o_miss_ids[bc + i] = a.miss_ids[bc + i];
    if (tid == 32) stamp<TIMED>(a, b, 1);
    // for step 8, off the chain: the beam's keys (from the input, which
    // no one writes), how many are valid, whether each is at most the
    // next; the id set emptied
    int n_valid = 0;
    bool unsorted = false;
    for (int i = tid - 32; i < ef; i += kCopiers) {
      const unsigned long long k0 =
          warpmerge::entry_key(a.beam_dists[be + i], a.beam_ids[be + i], i);
      keys[i] = k0;
      n_valid += k0 != warpmerge::kNone;
      if (i + 1 < ef)
        unsorted |= k0 > warpmerge::entry_key(a.beam_dists[be + i + 1],
                                              a.beam_ids[be + i + 1], i + 1);
    }
    n_valid = __reduce_add_sync(kFullMask, n_valid);
    unsorted = __any_sync(kFullMask, unsorted);
    if (lane == 0) {
      w_beam_valid[warp] = n_valid;
      w_beam_unsorted[warp] = unsorted;
    }
    for (int i = tid - 32; i < kIdSlots; i += kCopiers) id_set[i] = -1;
  }
  __syncthreads();  // the copy has landed; the candidate rows are listed

  if (!s_active) {  // the state as it was
    if (warp == 0) {
      for (int i = lane; i < ef; i += 32) {
        a.o_ids[be + i] = cand_id[i];
        a.o_dists[be + i] = cand_d[i];
        a.o_explored[be + i] = expl[i];
      }
      if (lane == 0) {
        if (deg > 0) a.o_visited[b * W + a.n_nodes] = 0;
        a.o_miss_count[b] = a.miss_count[b];
        a.o_n_hops[b] = a.n_hops[b];
        a.o_n_dist[b] = a.n_dist[b];
        a.o_active[b] = 0;
      }
    }
    return;  // the whole block: s_active is the block's
  }
  if (warp == 0) {
    // 5. the fresh neighbours marked visited, after the copy of the row;
    // the spare column n takes False where a slot is not fresh
#pragma unroll
    for (int p = 0; p < kPasses; ++p)
      if ((fresh_bits >> p) & 1u) a.o_visited[b * W + nb[p]] = 1;
    if (lane == 0) {
      if (nonfresh) a.o_visited[b * W + a.n_nodes] = 0;
      stamp<TIMED>(a, b, 3);
    }
  }

  // 7. the candidate rows' distances and their id_of checks, all of a
  // warp's in flight together; rows go to warps 1-7 first (warp 0 has the
  // visited bytes to write) and then to warp 0, 8 a round
  const float* q = a.Q + static_cast<size_t>(b) * a.d;
  const int n_rows = s_rows;
  const int wr = (warp + kWarps - 1) % kWarps;  // the warp's turn
  int n_new_valid = 0;
  for (int base = 0; base < n_rows; base += kWarps * kRowsInFlight) {
    int sl[kRowsInFlight], t[kRowsInFlight], id_ok[kRowsInFlight];
    int nr = 0;
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      const int u = base + wr + kWarps * r;
      if (u < n_rows) {
        nr = r + 1;
        sl[r] = row_sl[u];
        t[r] = row_t[u];
      }
    }
    if (nr == 0) break;  // warp-uniform: later groups hold none either
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r)
      id_ok[r] = r < nr && (a.slot_of == nullptr ||
                            a.id_of[sl[r]] == nbr[t[r]]);
    float dist[kRowsInFlight];
    distances<ELEM>(a, sl, nr, q, lane, dist);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        if (r < nr && id_ok[r]) {
          const int m = ef + t[r];
          cand_d[m] = dist[r];
          cand_id[m] = nbr[t[r]];
          present_at[t[r]] = 1;
          keys[m] = warpmerge::entry_key(dist[r], nbr[t[r]], m);
          n_new_valid += keys[m] != warpmerge::kNone;
        }
      }
    }
  }
  if (lane == 0) w_new_valid[warp] = n_new_valid;
  __syncthreads();
  if (tid == 0) stamp<TIMED>(a, b, 4);

  // 8. the merge of the row (the beam, then the new entries), k = ef, as
  // merge_row gives it, without a sort: thread m ranks entry m's (dist,
  // position) key, the count of the row's smaller keys (keys are distinct
  // but for the sentinels, so the ranks are the sorted order). A beam in
  // key order (each key at most the next), as every step, seed and load
  // phase leaves it, needs only the new keys counted: a beam entry's rank
  // among the beam is its position, a new one's a binary search; a beam
  // out of order has the whole row counted. Where the winners (rank <
  // min(ef, valid)) hold distinct ids, a hash set in shared memory says,
  // each writes itself at its rank; otherwise warp 0 runs merge_row, whose
  // dedup marks every valid rank. Explored follows each winner's position.
  const int M = ef + deg;
  int n_valid = 0;
  bool sorted_beam = true;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    n_valid += w_new_valid[w];
    if (w > 0) {
      n_valid += w_beam_valid[w];
      sorted_beam &= !w_beam_unsorted[w];
    }
  }
  const unsigned long long key = tid < M ? keys[tid] : warpmerge::kNone;
  const bool valid = key != warpmerge::kNone;
  const float kd = valid ? cand_d[tid] : 0.0f;
  const int kid = valid ? cand_id[tid] : -1;
  int rank = 0;
  if (valid) {
    const int from = sorted_beam ? ef : 0;  // the keys counted
#pragma unroll 4
    for (int m = from; m < M; ++m) rank += keys[m] < key;
    if (sorted_beam) {
      if (tid < ef) {
        rank += tid;
      } else {  // lower bound of the key in the beam's keys[0, ef)
        int lo = 0, n = ef;
        while (n > 0) {
          const int half = n >> 1;
          if (keys[lo + half] < key) {
            lo += half + 1;
            n -= half + 1;
          } else {
            n = half;
          }
        }
        rank += lo;
      }
    }
  }
  const bool winner = valid && rank < min(ef, n_valid);
  if (!__syncthreads_or(winner && id_seen(id_set, kid))) {
    if (winner) {
      a.o_ids[be + rank] = kid;
      a.o_dists[be + rank] = kd;
      a.o_explored[be + rank] = tid < ef && expl[tid];
    }
    if (tid >= n_valid && tid < ef) {
      a.o_ids[be + tid] = -1;
      a.o_dists[be + tid] = CUDART_INF_F;
      a.o_explored[be + tid] = 0;
    }
  } else if (warp == 0) {
    warpmerge::merge_row<E>(cand_d, cand_id, M, ef, msm, lane, a.o_dists + be,
                            a.o_ids + be, out_s);
    __syncwarp();
    for (int r = lane; r < ef; r += 32) {
      const int src = out_s[r];
      a.o_explored[be + r] = src >= 0 && src < ef && expl[src];
    }
  }
  if (tid == 0) stamp<TIMED>(a, b, 5);

  if (warp == 1) {
    // 9-10. the misses (fresh, not present) appended to L in slot order
    // (a ballot and a prefix popcount, the per-op step's cumsum), dropped
    // past the cap; the counters
    int n_usable = 0, n_missing = 0;
    for (int t0 = 0; t0 < deg; t0 += 32) {
      const int t = t0 + lane;
      const bool fresh = t < deg && fresh_at[t];
      const bool present = t < deg && present_at[t];
      const bool missing = fresh && !present;
      const unsigned used = __ballot_sync(kFullMask, fresh && present);
      const unsigned miss = __ballot_sync(kFullMask, missing);
      if (missing) {
        const long long pos = mc1 + n_missing + __popc(miss & lt);
        if (pos < cap) a.o_miss_ids[bc + pos] = nbr[t];
      }
      n_usable += __popc(used);
      n_missing += __popc(miss);
    }
    if (lane == 0) {
      const long long m = mc1 + n_missing;
      a.o_miss_count[b] = m < cap ? m : cap;
      a.o_n_hops[b] = hops1 + 1;
      a.o_n_dist[b] = dist1 + n_usable;
      a.o_active[b] = 1;
    }
  }
}

__global__ void launch_floor_kernel() {}

// SM cycles and global-timer nanoseconds over a spin of `cycles` cycles
__global__ void clock_kernel(long long cycles, long long* out) {
  long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  long long c1 = c0;
  while (c1 - c0 < cycles) c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[0] = c1 - c0;
  out[1] = g1 - g0;
}

template <int ELEM, bool TIMED>
cudaError_t launch(const HopArgs& a, int B, cudaStream_t s) {
  const int M = a.ef + a.deg;
  if (M <= 32)
    hop_step_kernel<ELEM, 1, TIMED><<<B, kThreads, 0, s>>>(a);
  else if (M <= 64)
    hop_step_kernel<ELEM, 2, TIMED><<<B, kThreads, 0, s>>>(a);
  else if (M <= 128)
    hop_step_kernel<ELEM, 4, TIMED><<<B, kThreads, 0, s>>>(a);
  else
    hop_step_kernel<ELEM, 8, TIMED><<<B, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <int ELEM>
cudaError_t launch(const HopArgs& a, int B, cudaStream_t s) {
  if constexpr (ELEM == kF32) {
    if (a.stamps != nullptr) return launch<ELEM, true>(a, B, s);
  }
  return launch<ELEM, false>(a, B, s);
}

int run(const float* Q, int d, const int* neighbors, int n_nodes, int deg,
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
        long long* stamps, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || ef < 1 || deg < 0 || ef + deg > kMaxRow || n_nodes < 1 ||
      n_rows < 1 || d < 1 || cap < 0 || metric < 0 || metric > 2 ||
      (slot_of != nullptr && (id_of == nullptr || n_slot_of < 1)) ||
      (stamps != nullptr && elem != kF32))
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
  a.stamps = stamps;
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
  return run(Q, d, neighbors, n_nodes, deg, beam_ids, beam_dists, explored,
             ef, visited, miss_ids, cap, miss_count, n_hops, n_dist, table,
             elem, scales, n_rows, slot_of, n_slot_of, id_of, gate,
             gate_stride, trigger, max_hops, metric, B, o_ids, o_dists,
             o_explored, o_visited, o_miss_ids, o_miss_count, o_n_hops,
             o_n_dist, o_active, nullptr, stream);
}

// hop_step's arguments and, before the stream, a (B, kStamps) int64
// buffer: the float32 step's TIMED instantiation, its stage boundaries in
// SM cycles. Not the engine's: for measuring the step only.
extern "C" int hop_step_stamps(
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
    long long* stamps, void* stream) {
  if (stamps == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(Q, d, neighbors, n_nodes, deg, beam_ids, beam_dists, explored,
             ef, visited, miss_ids, cap, miss_count, n_hops, n_dist, table,
             elem, scales, n_rows, slot_of, n_slot_of, id_of, gate,
             gate_stride, trigger, max_hops, metric, B, o_ids, o_dists,
             o_explored, o_visited, o_miss_ids, o_miss_count, o_n_hops,
             o_n_dist, o_active, stamps, stream);
}

// An empty kernel on the step's grid (B blocks of kThreads): the launch
// floor a step's time is measured against.
extern "C" int hop_step_floor(int B, void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  launch_floor_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// out[0] SM cycles and out[1] global-timer nanoseconds over one spin of
// `cycles` cycles on one thread: the SM clock a stamp's cycles convert by.
extern "C" int hop_step_clock(long long cycles, long long* out,
                              void* stream) {
  clock_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(cycles, out);
  return static_cast<int>(cudaGetLastError());
}
