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
//     all candidates, and each row's prior [rows, 2R] (assign | scores) is
//     merged in as composites (prior != nullptr).
//
// What bounds it: integer operations. Each (row, column) pair takes, per
// virtual instance, the xor, two multiplies, two shifts and two xors of
// mix32 and a max, then one 64-bit compare against the thread's R-th best
// (9 ops a pair at one instance). At [8192, 100000], V = 1, that is 819.2 M
// pairs, 7.4 G ops, 0.44 ms at the H100's INT32 rate (132 SMs x 64 lanes x
// 1.98 GHz = 16.7 T ops/s); the compulsory bytes (keys, weights, mask in,
// the [8192, 6] int32 map out, about 1.1 MB) take 0.3 us at 3.35 TB/s.
//
// Design: nothing is materialised. A block of 256 threads owns ROWS rows
// (more rows when R is small, so one load of a column's key, weight and
// mask serves several rows and the block's L2 traffic shrinks); each thread
// strides over the columns keeping, per row, its own descending top-R of
// composites in registers (R is a template parameter, so the arrays stay in
// registers; a candidate that does not beat the R-th best costs one
// compare). The block then merges its 256 lists pairwise through shared
// memory in log2(256) steps, and R threads write the row's result.
// Composites are unique per column, so the order is total and the result is
// numpy's bit for bit. R is capped at kMaxR (16); the wrapper raises above.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 16;

constexpr int rows_per_block(int r) { return r <= 2 ? 8 : (16 / r > 1 ? 16 / r : 1); }

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

template <int R, int ROWS>
__global__ void __launch_bounds__(kThreads)
topr_kernel(const uint32_t* __restrict__ part32, int64_t n_rows,
            const uint32_t* __restrict__ inst32, int64_t n_slots, int n_inst,
            const int32_t* __restrict__ weights, const uint8_t* __restrict__ active,
            const int32_t* __restrict__ cols, int64_t n_cols,
            const int32_t* __restrict__ prior, int32_t* __restrict__ out) {
  __shared__ uint64_t lists[ROWS][R][kThreads];
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ROWS;
  uint32_t key[ROWS];
  uint64_t top[ROWS][R];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    key[r] = row0 + r < n_rows ? part32[row0 + r] : 0u;
#pragma unroll
    for (int j = 0; j < R; ++j) top[r][j] = 0;
  }
  if (prior != nullptr && tid < R) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (row0 + r >= n_rows) break;
      const int32_t* row = prior + (row0 + r) * 2 * R;
      const int32_t a = row[tid];
      if (a >= 0) {
        const uint32_t s = static_cast<uint32_t>(row[R + tid]);
        insert<R>(top[r], (static_cast<uint64_t>(s) << 32) |
                              (0xFFFFFFFFu - static_cast<uint32_t>(a)));
      }
    }
  }
  const int64_t n = cols != nullptr ? n_cols : n_slots;
  for (int64_t i = tid; i < n; i += kThreads) {
    const int32_t c = cols != nullptr ? cols[i] : static_cast<int32_t>(i);
    // an explicit column outside [0, n_slots) is never read: no candidate
    if (cols != nullptr ? (c < 0 || c >= n_slots) : !active[c]) continue;
    const int w = min(weights[c], n_inst);
    const uint64_t rev = 0xFFFFFFFFu - static_cast<uint32_t>(c);
    if (w == 1) {
      const uint32_t ik = inst32[c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        insert<R>(top[r], (static_cast<uint64_t>(mix32(key[r], ik)) << 32) | rev);
    } else {
      uint32_t best[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) best[r] = 0;
      for (int v = 0; v < w; ++v) {
        const uint32_t ik = inst32[static_cast<int64_t>(v) * n_slots + c];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) best[r] = max(best[r], mix32(key[r], ik));
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        insert<R>(top[r], (static_cast<uint64_t>(best[r]) << 32) | rev);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < R; ++j) lists[r][j][tid] = top[r][j];
  __syncthreads();
  // pairwise merge: at each step thread t < stride merges lists t and
  // t + stride (both descending, R long) into list t
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        uint64_t merged[R];
        int ia = 0, ib = 0;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const uint64_t av = lists[r][ia][tid];
          const uint64_t bv = lists[r][ib][tid + stride];
          const bool from_a = av >= bv;
          merged[k] = from_a ? av : bv;
          ia += from_a;
          ib += !from_a;
        }
#pragma unroll
        for (int k = 0; k < R; ++k) lists[r][k][tid] = merged[k];
      }
    }
    __syncthreads();
  }
  if (tid < R) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (row0 + r >= n_rows) break;
      const uint64_t c = lists[r][tid][0];
      int32_t* row = out + (row0 + r) * 2 * R;
      row[tid] = c == 0 ? -1
                        : static_cast<int32_t>(0xFFFFFFFFu - static_cast<uint32_t>(c));
      row[R + tid] = static_cast<int32_t>(static_cast<uint32_t>(c >> 32));
    }
  }
}

template <int R>
int launch(const void* part32, long long n_rows, const void* inst32, long long n_slots,
           int n_inst, const void* weights, const void* active, const void* cols,
           long long n_cols, const void* prior, void* out, cudaStream_t stream) {
  static_assert(R >= 1 && R <= kMaxR, "R outside [1, kMaxR]");
  constexpr int kRows = rows_per_block(R);
  static_assert(kRows * R * kThreads * sizeof(uint64_t) <= 48 * 1024,
                "the block's lists must fit static shared memory");
  const long long blocks = (n_rows + kRows - 1) / kRows;
  topr_kernel<R, kRows><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(part32), n_rows, static_cast<const uint32_t*>(inst32),
      n_slots, n_inst, static_cast<const int32_t*>(weights),
      static_cast<const uint8_t*>(active), static_cast<const int32_t*>(cols), n_cols,
      static_cast<const int32_t*>(prior), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part32 [n_rows] and inst32 [n_inst, n_slots] hold uint32 bits; weights
// [n_slots] int32; active [n_slots] bool (read when cols is null); cols
// [n_cols] int32 or null; prior [n_rows, 2R] int32 or null; out [n_rows, 2R].
extern "C" int placement_topr(const void* part32, long long n_rows, const void* inst32,
                              long long n_slots, int n_inst, const void* weights,
                              const void* active, const void* cols, long long n_cols,
                              const void* prior, void* out, int replicas, void* stream) {
  if (n_rows <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
#define PLACEMENT_TOPR_CASE(R)                                                       \
  case R:                                                                            \
    return launch<R>(part32, n_rows, inst32, n_slots, n_inst, weights, active, cols, \
                     n_cols, prior, out, s);
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
