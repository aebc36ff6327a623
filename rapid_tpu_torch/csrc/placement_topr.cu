// Rendezvous top-R of the placement plane, for Hopper (sm_90a).
//
// Replaces the XLA program rapid_tpu/placement/device.py::_builder._build
// (build_jit: R rounds of argmax-and-mask over a materialised [P, C] uint32
// score matrix) and the chunked numpy topr_full that the JAX driver runs on
// the host; no Pallas kernel computed it. For each partition row p and each
// candidate column c:
//
//   score(p, c) = max over v < weights[c] of mix32(part32[p], inst32[v, c])
//   mix32(a, b) = murmur3 fmix32 of a ^ b (placement/engine.py:mix32)
//   composite   = (score << 32) | (0xFFFFFFFF - c)   if c is a candidate
//               = 0                                  otherwise
//
// and the row's R largest composites, descending, become assign (int32, -1
// for a composite of 0) and the score bits (uint32, held in int32), written
// side by side into one [rows, 2R] int32 buffer, so the host fetches a
// build with one copy. Two uses, one entry point:
//   - full or affected-row build: columns are all n_slots, candidates where
//     active[c] is set (cols == nullptr);
//   - added-column merge: columns are the explicit list cols[0..n_cols),
//     candidates where 0 <= cols[i] < n_slots, and each row's prior [rows, 2R]
//     (assign | scores) is merged in as composites (prior != nullptr).
//
// What bounds it: integer operations. Each (row, column) pair takes, per
// virtual instance, the xor, two multiplies, two shifts and two xors of
// mix32 and a max, then one compare against the row's R-th best (9 ops a
// pair at one instance). At [8192, 100000], V = 1, that is 819.2 M pairs,
// 7.4 G ops, 0.44 ms at the H100's INT32 rate (132 SMs x 64 lanes x 1.98 GHz
// = 16.7 T ops/s); the compulsory bytes (keys, weights, mask in, the
// [8192, 6] int32 map out, about 1.1 MB) take 0.3 us at 3.35 TB/s.
//
// Design. The plan -- the column split, the slices, the tile width, the
// shared memory -- is chosen on the host by placement/device.py::topr_plan
// and passed in; PERF.md has the variants timed against each choice
// (placement/topr_variants.py).
//   - Lanes own rows, the warp shares the columns. Lane l of a warp holds one
//     row: its key, its descending top-R of 64-bit composites and a 32-bit
//     threshold, in registers (at R 16 the list is 32 of them; no spill at
//     any R). All 32 lanes score the same columns at once, so a column's
//     instance keys, weight and mask are shared-memory broadcasts, and the
//     skip of a non-candidate and the loop over instances are warp-uniform:
//     no divergence at any weight. (Two and four rows a lane ran slower:
//     fewer warps, and a lane's admissions, below, twice as often.)
//   - Groups of columns, and admissions apart. A warp takes 16 consecutive
//     columns at a time (one instance row; 4 with several), loads their keys
//     with 16-byte broadcasts and computes all 16 scores before it tests any
//     against the lane's threshold -- 16 independent mixes, then their max,
//     one compare and one warp vote. Only when some lane has a score at or
//     above its threshold does the warp walk the group's quads of 4 columns
//     (those where some lane admits, a warp-uniform branch each) and insert.
//     A lane's list takes about R (1 + ln(n / R)) entries over n columns,
//     but the warp stops for any of its 32 lanes, so admissions are what the
//     column split and the shared floors below are sized against. The threshold is the
//     R-th best score, plus one while the lane's columns come in ascending
//     order (a tie then loses on its column index); a group whose columns
//     are all candidates of weight 1 (a ballot when the tile lands) skips the
//     masks a non-candidate or a weight of 0 needs.
//   - Columns stream through shared memory. The block's slice of columns is
//     cut into tiles of tile_cols columns; a ring of kStages stages is filled
//     with cp.async (4-byte copies, so any n_slots and any offset of the bool
//     mask work: the mask is copied as the aligned words that cover it,
//     zero-filled past its end) while the warps score the tile before. When
//     a tile lands, its weights and mask become one effective weight a column
//     (-1: not a candidate). The explicit-cols path gathers its columns by
//     index with plain loads (TMA cannot gather; it has about 1000 columns).
//     With several instance rows, the tile's columns are then counting-sorted
//     by weight into a scratch stage, so a group of 4 scores to one weight
//     and not to the largest of four (their order no longer ascends, so the
//     threshold drops the plus one).
//   - Column split and slices, merged on chip in one launch. A row's columns
//     are split over `col_split` warps of a block (1, 2, 4 or 8: few rows
//     take more warps a row) and over the S blocks of a thread-block cluster
//     (S <= 16; above 8 with the non-portable cluster attribute). Each part of
//     a row raises a floor that rank 0 keeps for the row (a distributed
//     shared-memory atomicMax of its R-th best score at each tile) and takes
//     that floor into its threshold: a part admits only what may still reach
//     the row's top-R. After a cluster barrier, each block merges a share of
//     the tile's rows across every part's list through distributed shared
//     memory, inserts the row's prior once (merge path; the prior's R-th score
//     also seeds every part's threshold) and writes the row; a second cluster
//     barrier keeps every block's lists alive until all are read. No partial
//     list goes to device memory.
//   - The grid (row tiles x S) is sized to the card by the host plan, so
//     8192, 1024, a view change's ~233 and a single row fill the SMs as far as
//     rows x slices allow.
// Composites are unique per column, the parts partition the columns and every
// filter admits ties, so the order is total and the result is numpy's bit for
// bit. R is capped at kMaxR (16); the wrapper raises above.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxR = 16;
constexpr int kStages = 3;
constexpr int kMaxSlices = 16;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most on sm_90
constexpr int kMinTile = 32;
constexpr int kMaxTile = 512;
constexpr int kGroup = 16;  // columns a warp scores at once at one instance row
constexpr int kGroupW = 4;  // the same with several instance rows

__host__ __device__ constexpr long long round16(long long x) { return (x + 15) & ~15LL; }

// one ring stage: keys [V][T] u32 | eff [T] i32 | col [T] i32 | plain
// [T / kGroup] i32 (a group's columns all candidates of weight 1) | mask
// [T + 8] u8
__host__ __device__ constexpr long long stage_bytes(int tile, int n_inst) {
  return round16(4LL * tile * n_inst + 8LL * tile + 4LL * (tile / kGroup) + tile + 8);
}

// the weight sort's scratch (several instance rows only): keys [V][T] u32 |
// eff [T] i32 | col [T] i32 | two histograms [2][V + 2] i32
__host__ __device__ constexpr long long sort_bytes(int tile, int n_inst) {
  return n_inst > 1 ? round16(4LL * tile * n_inst + 8LL * tile + 8LL * (n_inst + 2)) : 0;
}

// the shared memory a plan needs: the ring and the sort's scratch, or the
// block's lists laid over them after the last tile; then the rows' floors
// (placement/device.py::_topr_smem mirrors it)
__host__ __device__ constexpr long long smem_need(int tile, int n_inst, int r) {
  const long long work = kStages * stage_bytes(tile, n_inst) + sort_bytes(tile, n_inst);
  const long long lists = 8LL * r * kThreads;
  return round16(work > lists ? work : lists) + 4LL * kThreads;
}

struct Args {
  const uint32_t* part32;
  long long n_rows;
  const uint32_t* inst32;
  long long n_slots;
  int n_inst;
  const int32_t* weights;
  const uint8_t* active;
  const int32_t* cols;
  long long n_cols;
  const int32_t* prior;
  int32_t* out;
  int log2_tile;
  int slices;
  int col_split;
  long long col_tiles;
  long long stage;
  long long floors_at;  // the rows' floors
};

__device__ __forceinline__ uint32_t mix32(uint32_t a, uint32_t b) {
  uint32_t h = (a ^ b) * 0x85EBCA6Bu;
  h ^= h >> 15;
  h *= 0xC2B2AE35u;
  h ^= h >> 13;
  return h;
}

// insert c into a descending top-R list, dropping the smallest
template <int R>
__device__ __forceinline__ void insert(uint64_t (&top)[R], uint64_t c) {
  if (c <= top[R - 1]) return;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const uint64_t t = top[j];
    const bool take = c > t;
    top[j] = take ? c : t;
    c = take ? t : c;
  }
}

// the least score that may still enter a list whose R-th entry is last: its
// score, plus one when the list is full and a tie cannot win (bump 1: the
// columns come in ascending order, so a tie's column index is larger). A
// wrap to 0 at score 0xFFFFFFFF only lets every candidate reach insert().
__device__ __forceinline__ uint32_t threshold(uint64_t last, uint32_t bump) {
  return static_cast<uint32_t>(last >> 32) + (last != 0 ? bump : 0u);
}

// admit the scores sv[u] of a group's columns (effective weights e[u] and
// column indices col[u] in shared memory) into the lane's list, in the
// group's order. Called by the whole warp once some lane has a score at or
// above its threshold: the warp walks only the quads of 4 columns where some
// lane has one (a warp-uniform branch a quad), and each lane inserts its own.
template <int R, int U>
__device__ __forceinline__ void admit(uint64_t (&top)[R], uint32_t& thr, const uint32_t (&sv)[U],
                                      const int32_t* e, const int32_t* col, uint32_t bump) {
  unsigned quads = 0;
#pragma unroll
  for (int q = 0; q < U / 4; ++q) {
    const uint32_t best = max(max(sv[4 * q], sv[4 * q + 1]), max(sv[4 * q + 2], sv[4 * q + 3]));
    quads |= best >= thr ? 1u << q : 0u;
  }
  quads = __reduce_or_sync(0xFFFFFFFFu, quads);
#pragma unroll
  for (int q = 0; q < U / 4; ++q) {
    if (!((quads >> q) & 1u)) continue;
#pragma unroll
    for (int u = 4 * q; u < 4 * q + 4; ++u) {
      if (sv[u] >= thr && e[u] >= 0) {
        insert<R>(top, (static_cast<uint64_t>(sv[u]) << 32) |
                           (0xFFFFFFFFu - static_cast<uint32_t>(col[u])));
        thr = max(thr, threshold(top[R - 1], bump));
      }
    }
  }
}

// the largest of a group's scores
template <int U>
__device__ __forceinline__ uint32_t group_max(const uint32_t (&sv)[U]) {
  uint32_t best = sv[0];
#pragma unroll
  for (int u = 1; u < U; ++u) best = max(best, sv[u]);
  return best;
}

// a group's scores over several instance rows: keys[v << log2_tile] holds
// instance v's keys of the group's columns, e[u] the instances column u
// scores (top_w the most); kEven when every column scores top_w
template <bool kEven, int U>
__device__ __forceinline__ void weighted_scores(uint32_t (&sv)[U], const uint32_t* keys,
                                                int log2_tile, const int (&e)[U], int top_w,
                                                uint32_t key) {
#pragma unroll
  for (int u = 0; u < U; ++u) sv[u] = 0;
  for (int v = 0; v < top_w; ++v) {
#pragma unroll
    for (int q = 0; q < U / 4; ++q) {
      const uint4 k4 = *reinterpret_cast<const uint4*>(keys + (v << log2_tile) + 4 * q);
      const uint32_t k[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t h = max(sv[4 * q + u], mix32(key, k[u]));
        sv[4 * q + u] = kEven || v < e[4 * q + u] ? h : sv[4 * q + u];
      }
    }
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int R>
__global__ void __launch_bounds__(kThreads, 2) topr_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  // the block's warps: kWarps / split row groups of 32 rows, each row
  // group's columns split over `split` warps (part = warp % split)
  const int split = a.col_split;
  const int part = warp % split;
  const int tile_rows = kThreads / split;
  const int q_lane = warp / split * 32 + lane;  // the lane's row in the tile
  const long long row0 = static_cast<long long>(blockIdx.x / a.slices) * tile_rows;
  const long long row = row0 + q_lane;
  const int T = 1 << a.log2_tile;
  const int V = a.n_inst;
  const long long n = a.cols != nullptr ? a.n_cols : a.n_slots;
  // this block's slice: column tiles [t_begin, t_end), a partition of them
  const long long t_begin = a.col_tiles * rank / a.slices;
  const int n_here = static_cast<int>(a.col_tiles * (rank + 1) / a.slices - t_begin);
  // columns ascend in a lane's order only on the one-instance active path
  const uint32_t bump = a.cols == nullptr && V <= 1 ? 1u : 0u;

  const uint32_t key = row < a.n_rows ? a.part32[row] : 0u;
  uint32_t thr = 0;
  // merging: a new column below the prior's R-th score cannot enter the
  // row's top-R, so the prior seeds the threshold (it enters the lists only
  // in the cluster's merge)
  if (a.prior != nullptr && row < a.n_rows) {
    const int32_t assign = a.prior[row * 2 * R + R - 1], score = a.prior[row * 2 * R + 2 * R - 1];
    thr = assign >= 0 ? static_cast<uint32_t>(score) : 0u;
  }
  uint64_t top[R];
#pragma unroll
  for (int j = 0; j < R; ++j) top[j] = 0;

  auto keys = [&](int s) { return reinterpret_cast<uint32_t*>(smem + s * a.stage); };
  auto effs = [&](int s) { return reinterpret_cast<int32_t*>(keys(s) + T * V); };
  auto colv = [&](int s) { return effs(s) + T; };
  auto plain = [&](int s) { return colv(s) + T; };
  auto mask = [&](int s) { return reinterpret_cast<uint8_t*>(plain(s) + T / kGroup); };
  // the sort's scratch: the stage after the ring, laid out as one
  uint32_t* x_keys = keys(kStages);
  int32_t* x_eff = reinterpret_cast<int32_t*>(x_keys + T * V);
  int32_t* x_col = x_eff + T;
  int32_t* x_hist = x_col + T;  // [2][V + 2]

  // start the copies of column tile ti into stage s (the active path; the
  // explicit-cols path gathers in convert())
  auto issue = [&](long long ti, int s) {
    if (a.cols != nullptr) return;
    const long long c0 = ti << a.log2_tile;
    const int nt = static_cast<int>(min(static_cast<long long>(T), n - c0));
    uint32_t* sk = keys(s);
    for (int idx = tid; idx < (V << a.log2_tile); idx += kThreads) {
      const int v = idx >> a.log2_tile, j = idx & (T - 1);
      if (j < nt) cp_async4(sk + idx, a.inst32 + v * a.n_slots + c0 + j, 4);
    }
    int32_t* se = effs(s);
    for (int j = tid; j < nt; j += kThreads) cp_async4(se + j, a.weights + c0 + j, 4);
    // the mask's bytes [c0, c0 + nt) as the aligned words that cover them
    const uintptr_t first = reinterpret_cast<uintptr_t>(a.active + c0);
    const uintptr_t base = first & ~static_cast<uintptr_t>(3);
    const uintptr_t end = reinterpret_cast<uintptr_t>(a.active + a.n_slots);
    const int words = static_cast<int>((first + nt - base + 3) >> 2);
    uint32_t* sm = reinterpret_cast<uint32_t*>(mask(s));
    for (int q = tid; q < words; q += kThreads) {
      const uintptr_t src = base + 4 * static_cast<uintptr_t>(q);
      const int bytes = end - src < 4 ? static_cast<int>(end - src) : 4;
      cp_async4(sm + q, reinterpret_cast<const void*>(src), bytes);
    }
  };

  // turn stage s (column tile ti, landed; tile t of the block) into one
  // effective weight a column (-1: no candidate, else the instances it
  // scores) and its column index. One instance row: flag each group of
  // kGroup columns whose columns are all candidates of weight 1 (T is a
  // multiple of 32, so every lane of a warp takes part in the ballot).
  // Several: counting-sort the tile's columns by weight into the scratch
  // stage, keys with them (two block barriers: the histogram, its offsets).
  auto convert = [&](long long ti, int s, int t) {
    const long long c0 = ti << a.log2_tile;
    const int nt = static_cast<int>(min(static_cast<long long>(T), n - c0));
    int32_t* se = effs(s);
    int32_t* sc = colv(s);
    const int o = a.cols == nullptr
                      ? static_cast<int>(reinterpret_cast<uintptr_t>(a.active + c0) & 3) : 0;
    const uint8_t* sm = mask(s);
    int32_t* hist = x_hist + (t & 1) * (V + 2);
    for (int j = tid; j < T; j += kThreads) {
      int e = -1;
      int32_t c = static_cast<int32_t>(c0 + j);
      if (a.cols == nullptr) {
        if (j < nt && sm[o + j]) e = min(max(se[j], 0), V);
      } else {
        c = j < nt ? a.cols[c0 + j] : -1;
        if (c >= 0 && c < a.n_slots) e = min(max(a.weights[c], 0), V);
        if (V <= 1 && e == 1) keys(s)[j] = a.inst32[c];  // the gather
      }
      se[j] = e;
      sc[j] = c;
      if (V <= 1) {
        const unsigned ones = __ballot_sync(0xFFFFFFFFu, e == 1);
        if (lane % kGroup == 0) plain(s)[j / kGroup] = (ones >> lane & 0xFFFFu) == 0xFFFFu;
      } else {
        atomicAdd(hist + e + 1, 1);
      }
    }
    if (V <= 1) return;
    // the other histogram, last read in tile t - 1, for tile t + 1
    for (int b = tid; b < V + 2; b += kThreads) x_hist[((t + 1) & 1) * (V + 2) + b] = 0;
    __syncthreads();
    if (warp == 0) {  // exclusive offsets, 32 bins a step
      int carry = 0;
      for (int b0 = 0; b0 < V + 2; b0 += 32) {
        const int b = b0 + lane;
        const int count = b < V + 2 ? hist[b] : 0;
        int incl = count;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
          if (lane >= d) incl += y;
        }
        if (b < V + 2) hist[b] = carry + incl - count;
        carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
      }
    }
    __syncthreads();
    const uint32_t* sk = keys(s);
    for (int j = tid; j < T; j += kThreads) {
      const int e = se[j];
      const int pos = atomicAdd(hist + e + 1, 1);
      const int32_t c = sc[j];
      x_eff[pos] = e;
      x_col[pos] = c;
      for (int v = 0; v < e; ++v)
        x_keys[(v << a.log2_tile) + pos] =
            a.cols == nullptr ? sk[(v << a.log2_tile) + j] : a.inst32[v * a.n_slots + c];
    }
  };

  // score stage s. One instance row: groups of kGroup columns, dealt to the
  // split's warps in turn. Several: groups of kGroupW columns of the sorted
  // scratch, each scored to its largest weight, instances past a column's
  // own weight masked out (none where the group's weights are equal).
  auto score = [&](long long ti, int s) {
    if (V <= 1) {
      const int nt = static_cast<int>(min(static_cast<long long>(T), n - (ti << a.log2_tile)));
      const uint32_t* sk = keys(s);
      const int32_t* se = effs(s);
      const int32_t* sg = plain(s);
      const int32_t* sc = colv(s);
      for (int j0 = kGroup * part; j0 < nt; j0 += kGroup * split) {
        uint32_t sv[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup / 4; ++q) {
          const uint4 k4 = *reinterpret_cast<const uint4*>(sk + j0 + 4 * q);
          sv[4 * q] = mix32(key, k4.x), sv[4 * q + 1] = mix32(key, k4.y);
          sv[4 * q + 2] = mix32(key, k4.z), sv[4 * q + 3] = mix32(key, k4.w);
        }
        if (!sg[j0 / kGroup]) {  // a non-candidate or a weight of 0 among them
#pragma unroll
          for (int q = 0; q < kGroup / 4; ++q) {
            const int4 e4 = *reinterpret_cast<const int4*>(se + j0 + 4 * q);
            sv[4 * q] = e4.x > 0 ? sv[4 * q] : 0u;
            sv[4 * q + 1] = e4.y > 0 ? sv[4 * q + 1] : 0u;
            sv[4 * q + 2] = e4.z > 0 ? sv[4 * q + 2] : 0u;
            sv[4 * q + 3] = e4.w > 0 ? sv[4 * q + 3] : 0u;
          }
        }
        if (__any_sync(0xFFFFFFFFu, group_max(sv) >= thr))
          admit<R, kGroup>(top, thr, sv, se + j0, sc + j0, bump);
      }
    } else {
      for (int j0 = kGroupW * part; j0 < T; j0 += kGroupW * split) {
        int e[kGroupW];
#pragma unroll
        for (int q = 0; q < kGroupW / 4; ++q) {
          const int4 e4 = *reinterpret_cast<const int4*>(x_eff + j0 + 4 * q);
          e[4 * q] = e4.x, e[4 * q + 1] = e4.y, e[4 * q + 2] = e4.z, e[4 * q + 3] = e4.w;
        }
        int top_w = e[0], low_w = e[0];
#pragma unroll
        for (int u = 1; u < kGroupW; ++u) top_w = max(top_w, e[u]), low_w = min(low_w, e[u]);
        if (top_w < 0) continue;
        uint32_t sv[kGroupW];
        if (low_w == top_w)  // no column of the group stops early
          weighted_scores<true>(sv, x_keys + j0, a.log2_tile, e, top_w, key);
        else
          weighted_scores<false>(sv, x_keys + j0, a.log2_tile, e, top_w, key);
        if (__any_sync(0xFFFFFFFFu, group_max(sv) >= thr))
          admit<R, kGroupW>(top, thr, sv, x_eff + j0, x_col + j0, bump);
      }
    }
  };

  // the rows' floors: every part of a row (the warps of its split, the
  // blocks of the cluster) raises rank 0's floor to its own R-th best score
  // at each tile, and takes the floor into its threshold. The R-th best of
  // any part's columns is a lower bound of the row's, and a tie may still
  // win by its column, so the floor is the raw score. Not in the merge,
  // whose prior seeds every part's threshold from the start.
  uint32_t* floors = reinterpret_cast<uint32_t*>(smem + a.floors_at);
  uint32_t* lead = cluster.map_shared_rank(floors, 0) + q_lane;
  const bool share = a.prior == nullptr && a.slices * split > 1;
  uint32_t published = 0;
  if (share) {
    for (int q = tid; q < tile_rows; q += kThreads) floors[q] = 0;
    cluster.sync();  // rank 0's floors are zero before any part raises them
  }
  for (int b = tid; V > 1 && b < 2 * (V + 2); b += kThreads) x_hist[b] = 0;

  // the ring: tile t is scored while tiles t + 1 .. t + kStages - 1 land
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_here) issue(t_begin + s, s);
    cp_async_commit();
  }
  for (int t = 0; t < n_here; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t visible to all; every warp done with tile t - 1
    const int next = t + kStages - 1;
    if (next < n_here) issue(t_begin + next, next % kStages);
    cp_async_commit();
    uint32_t floor = 0;
    if (share && t > 0) {
      const uint32_t mine = static_cast<uint32_t>(top[R - 1] >> 32);
      if (top[R - 1] != 0 && mine > published) {  // a remote atomic only on a rise
        atomicMax(lead, mine);
        published = mine;
      }
      floor = *lead;
    }
    convert(t_begin + t, t % kStages, t);
    __syncthreads();
    thr = max(thr, floor);
    score(t_begin + t, t % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();

  // each lane's list into the block's [split][R][tile_rows] over the ring
  uint64_t* bl = reinterpret_cast<uint64_t*>(smem);
#pragma unroll
  for (int j = 0; j < R; ++j) bl[(part * R + j) * tile_rows + q_lane] = top[j];

  // the cluster's merge: block `rank` finishes rows rank, rank + S, ... of
  // the tile from every part's list, then writes them
  cluster.sync();
  for (int q = rank + tid * a.slices; q < tile_rows; q += kThreads * a.slices) {
    const long long r_out = row0 + q;
    if (r_out >= a.n_rows) break;
    uint64_t m[R];
#pragma unroll
    for (int j = 0; j < R; ++j) m[j] = 0;
    for (int s = 0; s < a.slices; ++s) {
      const uint64_t* b = cluster.map_shared_rank(bl, s);
      for (int p = 0; p < split; ++p) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const uint64_t c = b[(p * R + j) * tile_rows + q];
          if (c <= m[R - 1]) break;  // each list is descending: no later entry enters
          insert<R>(m, c);
        }
      }
    }
    if (a.prior != nullptr) {  // once a row, here and in no part
      const int32_t* p = a.prior + r_out * 2 * R;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (p[j] >= 0)
          insert<R>(m, (static_cast<uint64_t>(static_cast<uint32_t>(p[R + j])) << 32) |
                           (0xFFFFFFFFu - static_cast<uint32_t>(p[j])));
      }
    }
    int32_t* o = a.out + r_out * 2 * R;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      o[j] = m[j] == 0 ? -1
                       : static_cast<int32_t>(0xFFFFFFFFu - static_cast<uint32_t>(m[j]));
      o[R + j] = static_cast<int32_t>(static_cast<uint32_t>(m[j] >> 32));
    }
  }
  cluster.sync();  // no block leaves while another may still read its lists
}

template <int R>
int launch(const Args& a, long long row_tiles, int smem, cudaStream_t stream) {
  static_assert(R >= 1 && R <= kMaxR, "R outside [1, kMaxR]");
  static_assert(smem_need(kMinTile, 0, R) <= kMaxSmem, "lists exceed shared memory");
  auto kernel = topr_kernel<R>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool configured[64] = {};
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(row_tiles * a.slices));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.slices);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part32 [n_rows] and inst32 [n_inst, n_slots] hold uint32 bits; weights
// [n_slots] int32; active [n_slots] bool (read when cols is null); cols
// [n_cols] int32 or null; prior [n_rows, 2R] int32 or null; out [n_rows, 2R].
// The plan: col_split (warps that split a row's columns: 1, 2, 4 or 8),
// slices (S, the cluster size, 1..16), tile_cols (a power of two, 32..512)
// and smem_bytes (at least smem_need, at most 227 KB). Returns a CUDA error
// code: the launch's, or cudaErrorInvalidValue for a plan outside these.
extern "C" int placement_topr(const void* part32, long long n_rows, const void* inst32,
                              long long n_slots, int n_inst, const void* weights,
                              const void* active, const void* cols, long long n_cols,
                              const void* prior, void* out, int replicas, int col_split,
                              int slices, int tile_cols, int smem_bytes, void* stream) {
  if (n_rows <= 0) return 0;
  int log2_tile = 0;
  while ((1 << log2_tile) < tile_cols) ++log2_tile;
  if (replicas < 1 || replicas > kMaxR || col_split < 1 || col_split > kWarps ||
      (col_split & (col_split - 1)) != 0 || slices < 1 || slices > kMaxSlices ||
      tile_cols < kMinTile || tile_cols > kMaxTile || (1 << log2_tile) != tile_cols ||
      n_inst < 0 || smem_bytes > kMaxSmem || smem_need(tile_cols, n_inst, replicas) > smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.part32 = static_cast<const uint32_t*>(part32);
  a.n_rows = n_rows;
  a.inst32 = static_cast<const uint32_t*>(inst32);
  a.n_slots = n_slots;
  a.n_inst = n_inst;
  a.weights = static_cast<const int32_t*>(weights);
  a.active = static_cast<const uint8_t*>(active);
  a.cols = static_cast<const int32_t*>(cols);
  a.n_cols = n_cols;
  a.prior = static_cast<const int32_t*>(prior);
  a.out = static_cast<int32_t*>(out);
  a.log2_tile = log2_tile;
  a.slices = slices;
  a.col_split = col_split;
  const long long n = cols != nullptr ? n_cols : n_slots;
  a.col_tiles = (n + tile_cols - 1) / tile_cols;
  a.stage = stage_bytes(tile_cols, n_inst);
  const long long work = kStages * a.stage + sort_bytes(tile_cols, n_inst);
  const long long lists = 8LL * replicas * kThreads;
  a.floors_at = round16(work > lists ? work : lists);
  const long long tile_rows = kThreads / col_split;
  const long long row_tiles = (n_rows + tile_rows - 1) / tile_rows;
  auto s = static_cast<cudaStream_t>(stream);
#define PLACEMENT_TOPR_CASE(R) \
  case R:                      \
    return launch<R>(a, row_tiles, smem_bytes, s);
  switch (replicas) {
    PLACEMENT_TOPR_CASE(1) PLACEMENT_TOPR_CASE(2) PLACEMENT_TOPR_CASE(3)
    PLACEMENT_TOPR_CASE(4) PLACEMENT_TOPR_CASE(5) PLACEMENT_TOPR_CASE(6)
    PLACEMENT_TOPR_CASE(7) PLACEMENT_TOPR_CASE(8) PLACEMENT_TOPR_CASE(9)
    PLACEMENT_TOPR_CASE(10) PLACEMENT_TOPR_CASE(11) PLACEMENT_TOPR_CASE(12)
    PLACEMENT_TOPR_CASE(13) PLACEMENT_TOPR_CASE(14) PLACEMENT_TOPR_CASE(15)
    PLACEMENT_TOPR_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PLACEMENT_TOPR_CASE
}
