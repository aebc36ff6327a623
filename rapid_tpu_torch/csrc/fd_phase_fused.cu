// The whole failure-detector phase of one scan round, fused, for Hopper
// (sm_90a): probe evaluation, the policy's per-edge state (the saturating
// counter and the gray streak path, or the window of the last W probes), the
// alert latch, and the destination-indexed alert gather.
//
// Replaces rapid_tpu/sim/pallas_kernels.py::_fd_phase_kernel (wrapper
// fd_phase) together with the jnp ops around it in
// rapid_tpu/sim/engine.py::_fd_phase (565-655), both FD policies, and the
// window rule of rapid_tpu/sim/engine.py::window_step and windowed_fd_phase
// (521-562). For node n, observer o, ring k and subject s = subjects[o, k]:
//
//   alive[n]       = alive_in[n] & active[n]
//   watching(o,k)  = active[o] & active[s] & alive[o] & turn(o)
//   probe_ok(o,k)  = alive[s] & ~probe_drop[o,k] & ~(draw(o,k) < drop_prob[s])
//   fail           = watching & ~probe_ok
//   fd_fail       += fail                (uint8, stops at 255)
//   new_down       = watching & fd_fail >= threshold & ~alerted
//   gray (confirm > 0): ok = watching & probe_ok; streak += fail (stops at
//     255), streak = 0 where ok; fd_ok += ok (stops at 255);
//     new_down |= fail & streak >= confirm & fd_ok_before >= warmup & ~alerted
//   windowed policy (W > 0; in place of the counter and the gray path):
//     where watching: hist = ((hist << 1) | fail) & (2^W - 1),
//                     seen = min(uint8(seen + 1), W)
//     new_down = watching & seen >= W & popcount(hist) >= t & ~alerted,
//     with t = ceil(threshold fraction * W) computed once on the host;
//     fd_fail is neither read nor written
//   alerted       |= new_down
//   down_arrivals[d,k] = (new_down[observers[d,k], k] | down_reports[d,k])
//                        & active[d]
//
// turn(o) is the staggered FD phase: (uint32(o) * 2654435761) mod rpi ==
// round mod rpi, with the round read from device memory (no host sync).
//
// Random loss. Every call also advances the state's random key as the JAX
// engine's round does (jax.random.split: the new key, kept as it came when
// the halt flag is set, and the probe key), and with random loss on
// (drop_prob given) draw(o,k) is JAX's uniform draw of edge e = o*K + k under
// the probe key: the bits of threefry.cuh, the words threefry.cu's
// threefry_draw writes as a block. Threefry is counter-based, so the edge
// pass makes an edge's word in registers, and only where it can change the
// outcome: the observer probes, the subject is alive and lossy (drop_prob >
// 0; draws lie in [0, 1)), the probe is not dropped, and drop_prob is below
// 1 (at 1 or more the probe is lost without a draw).
//
// What bounds it. The compulsory traffic is bytes: at K=10 with random loss
// on and the gray path off, an edge reads subjects and observers (4 B each)
// and probe_drop, fd_fail, alerted and down_reports (1 B each), and writes
// fd_fail, alerted and down_arrivals (1 B each): 15 B, plus 7 B per node
// (active, alive, drop_prob in; alive out), 0.7 B per edge. The gray path
// adds 4 B per edge; the window swaps the counter's 2 B for the int32
// history and the uint8 probe count, in and out (10 B); a round with no new
// alert needs no observers. The draws add threefry's integer operations on
// the edges that draw, which bound the call only when most subjects are
// lossy (threefry.cu's header counts them).
// The other arithmetic is a few integer operations per edge. What holds the
// kernel above that bound on an H100 is the two random reads per edge that
// the function implies, each waiting on a streamed load before it can issue:
// the subject's state (indexed by subjects[o, k]) and the observer edge's
// new_down (indexed by observers[d, k]). PERF.md has the measurements.
//
// What the design does about it:
// - Every [C,K] stream is walked as slots of 16 consecutive edges of the flat
//   C*K index space, one slot per thread step: byte streams as one 16-byte
//   load or store, int32 and float32 streams as four, with the streaming
//   cache hint, so they do not evict the small random-access tables from
//   L2. When the streams are aligned differently, every slot takes scalar
//   accesses; otherwise only the first and last slots do.
// - Pass 1 (node_pass) packs what the subject side needs into 2 bits per
//   node, as two bit planes per 32 nodes made with warp ballots: inactive,
//   active, alive, alive and lossy (drop_prob > 0). So an edge makes one
//   random 8-byte read into a table of C/4 bytes (25 KB at 100k nodes, 250
//   KB at 1M: it stays in L1 and L2), and reads drop_prob[subject] only for
//   a lossy live subject.
// - The destination gather needs new_down of other threads' edges, so it
//   cannot run in the pass that writes new_down without a grid-wide barrier.
//   Pass 2 (observer_pass) writes the observer-indexed outputs and new_down
//   as bits (16 a slot: 125 KB at 100k nodes, 1.25 MB at 1M, in L2), and
//   flags whether any bit is set. Pass 3 (gather_pass) gathers one bit per
//   destination edge, vectorised over destinations; when no bit is set, as
//   in most rounds of a scan, it reads neither the observers nor the bits.
// - The policy is a compile-time choice (kGray, kWindow), so each
//   instantiation reads and writes only its own per-edge planes, and random
//   loss another (kRandom).
// - The key's split takes no pass of its own: in block 0 of the node pass,
//   one thread writes the new key (out of place, so the call can sit in a
//   CUDA graph) and one thread a probe key writes it into the node table's
//   scratch, which every block of the observer pass reads once, after the
//   node pass has ended. A thread draws the edges of its slot that need a
//   word in a loop over their bits, so a warp takes as many steps as its
//   busiest lane needs (with 1% of subjects lossy, about one a slot).
// - PERF.md lists the designs tried and measured on the card that this one
//   beat, among them recomputing new_down in the destination thread.
//
// The multi-device round (rapid_tpu_torch/shard/engine.py, the counterpart
// of rapid_tpu/shard/engine.py::_sharded_round) row-shards the per-edge
// state by observer, so the destination gather needs other shards' bits and
// cannot run until they have been exchanged. Two more entry points run the
// same passes on either side of that exchange:
// - fd_phase_rows: one call a device a round, over every shard the device
//   holds (up to kMaxShards a call). The node pass runs once over all C
//   nodes, then one observer launch covers every shard: blockIdx.y picks the
//   shard from a table passed as a __grid_constant__ parameter, and
//   blockIdx.x strides over its rows [row0, row0 + rows), on the shard's own
//   [rows, K] tensors (subject ids global). Each shard's new_down bits go to
//   its segment of a per-shard bitset: ceil(rows * K / 32) words, local edge
//   e at bit e, then one word that is non-zero iff a bit is set. Slots start
//   at local edge 0 (16-byte accesses when every stream is aligned there,
//   scalar ones otherwise), and the last data word is written whole, so the
//   segment holds no stale bit. A halt flag, read on the device as the round
//   is, stops every observer's probe: the planes come out as they went in,
//   the segments hold no bit and the key as it came is the new key (the
//   mesh masks the rounds after its decision this way). Each shard draws as
//   the JAX engine's sharded round does: edge e of its [rows, K] block
//   (local row times K plus k) under the probe key folded with the shard's
//   global index (threefry.cuh), a fold the node pass makes once a call for
//   every shard.
// - fd_gather: the gather pass over all [C, K] destinations, from the
//   segments of every shard laid end to end; observer o's bit is bit
//   (o - s * rows) * K + k of segment s = o / rows, the division a multiply
//   by a reciprocal the host computes. It reads neither the observers nor
//   the bits when no segment's flag is set.
// Their bound is bytes too: fd_phase_rows moves its rows' streams (9 B an
// edge) plus 6 B of every one of the C nodes, once a call;
// fd_gather 6 B an edge plus the segments. What holds them above it on an
// H100 is the observer pass's dependent reads, as in the fused call; and a
// shard of few rows gives few slots. So both take blocks of kSplitThreads
// threads over a grid sized to the card (its SMs times the kernel's
// occupancy, queried once): a shard of 12 500 rows spreads over 123 blocks,
// not 16 of 512 threads.
//
// The kernel allocates nothing: the wrapper passes the outputs, the node
// table, the new_down bits and the stream. Every launch is checked with
// cudaGetLastError().

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kVec = 16;  // edges per slot: one 16-byte access per byte stream
constexpr int kThreads = 512;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr long long kMaxBlocks = 132 * 16;
constexpr int kSplitThreads = 64;  // block size of fd_phase_rows' observer pass and fd_gather
constexpr int kMaxShards = 16;     // shards of one fd_phase_rows call
constexpr int kMaxDevices = 64;
constexpr uint32_t kNoTurn = 0xffffffffu;  // the turn of a halted round: nobody's
constexpr int kKeyThread = 32;  // the node pass's thread that writes the new key
// fd_phase_rows' observer pass is a programmatic dependent launch of its
// node pass (rows_pass)
constexpr bool kDependentLaunch = true;

struct Params {
  // node state, 2 bits per node as two bit planes per 32 nodes: 0 inactive,
  // 1 active, 2 alive, 3 alive and lossy
  const uint2* node;
  const uint32_t* bits;  // bit e + shift is edge e's new_down
  uint32_t* any_down;    // some edge has new_down set
  const int32_t* round;
  const uint8_t* halt;   // null, or a flag that, when set, stops every probe
  int rpi;
  const float* drop_prob;  // null: random loss off
  const uint2* probe;      // the round's probe key (fd_phase_rows: its shard's, folded)
  const int32_t* subjects;
  const int32_t* observers;
  const uint8_t* probe_drop;
  const uint8_t* down_reports;
  const uint8_t* fd_fail;
  const uint8_t* alerted;
  const uint8_t* streak;
  const uint8_t* fd_ok;
  const int32_t* hist;
  const uint8_t* seen;
  const uint8_t* active;
  uint8_t* fd_fail_out;
  uint8_t* alerted_out;
  uint8_t* streak_out;
  uint8_t* fd_ok_out;
  int32_t* hist_out;
  uint8_t* seen_out;
  uint8_t* down_arrivals;
  uint16_t* new_down;  // the words of `bits`, written a slot at a time
  int64_t n;           // edges of the [C, K] (or [rows, K]) streams
  int64_t row0;        // global id of the streams' first observer row
  int64_t slots;       // slot j holds edges [16j - shift, 16j - shift + 16)
  int shift;
  uint32_t shard_rows;  // fd_gather: rows of each shard's segment
  uint32_t row_magic;   // fd_gather: o / shard_rows = umulhi(2o, row_magic) >> row_shift
  int row_shift;
  int32_t n_shards;
  uint32_t seg_words;   // fd_gather: words of one segment, its flag included
  bool vec_ok;  // every stream is 16-byte aligned at slot starts
  int k;
  int threshold;
  int confirm;
  int warmup;
  int window;            // W, 0 under the cumulative policy
  int window_fire;       // t: failures in a full window that fire
  uint32_t window_mask;  // 2^W - 1
};

union Bytes16 {
  uint4 v;
  uint8_t b[kVec];
};
union Ints16 {
  int4 v[kVec / 4];
  int32_t i[kVec];
};

__device__ __forceinline__ uint32_t node_state(const Params& p, int64_t node) {
  const uint2 planes = __ldg(p.node + (node >> 5));
  const int b = static_cast<int>(node & 31);
  return ((planes.x >> b) & 1u) | (((planes.y >> b) & 1u) << 1);
}

// Round-robin probe turn of this round (round mod rpi), read on the device.
__device__ __forceinline__ uint32_t this_turn(const Params& p) {
  if (p.rpi <= 1) return 0;
  int r = *p.round % p.rpi;  // the round is >= 0; floor-mod all the same
  if (r < 0) r += p.rpi;
  return static_cast<uint32_t>(r);
}

// The observer probes this round: it is alive and the round is its turn.
__device__ __forceinline__ bool probing(const Params& p, int64_t o, uint32_t turn) {
  return node_state(p, o) >= 2 &&
         (p.rpi <= 1 ||
          (static_cast<uint32_t>(o) * 2654435761u) % static_cast<uint32_t>(p.rpi) == turn);
}

// The any_down words that a node pass clears: the call's own, or one a
// shard of a per-device fd_phase_rows call.
struct Flags {
  uint32_t* word[kMaxShards];
  int n;
};

// The round's keys: the state's key in, the new key out (out of place), the
// halt flag that keeps the key (null: never halted), and the probe keys the
// edge passes read: fd_phase_fused's one, or one a shard of an
// fd_phase_rows call, folded with the shard's global index.
struct Keys {
  const int64_t* in;
  int64_t* out;
  const uint8_t* halt;
  uint2* probe;
  int n;
  uint32_t shard[kMaxShards];
};

// Pass 1: the alive output (none when alive_out is null) and the node state
// planes, a node a thread (a warp's ballots make the two plane words of its
// 32 nodes); clears the flags: fd_phase_fused's one word, or with kShards
// each shard's, and then it lets the observer pass launched after it as a
// dependent (kDependentLaunch) start at once. In block 0, thread s < n
// writes probe key s (with kShards folded with shard s's index) and thread
// kKeyThread, in another warp, the new key: two threefry calls on the
// longest thread, beside the nodes' work.
template <bool kShards>
__global__ void __launch_bounds__(kThreads) node_pass(const uint8_t* __restrict__ active,
                                                      const uint8_t* __restrict__ alive_in,
                                                      const float* __restrict__ drop_prob,
                                                      int64_t c, uint8_t* __restrict__ alive_out,
                                                      uint2* __restrict__ node, const Flags flags,
                                                      const __grid_constant__ Keys keys) {
  if (kShards && kDependentLaunch) asm volatile("griddepcontrol.launch_dependents;");
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kShards ? tid < flags.n : tid == 0) *flags.word[kShards ? tid : 0] = 0;
  if (tid < keys.n)
    keys.probe[tid] = jax_threefry::probe_key(keys.in, kShards, keys.shard[tid]);
  else if (tid == kKeyThread)
    jax_threefry::write_new_key(keys.in, keys.out, keys.halt);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t padded = (c + 31) / 32 * 32;  // whole warps take every step
  for (int64_t i = tid; i < padded; i += stride) {
    uint32_t st = 0;
    if (i < c) {
      const bool a = active[i] != 0;
      const bool up = a && alive_in[i] != 0;
      // draw < p can hold only for p > 0 (draws lie in [0, 1))
      const bool lossy = drop_prob != nullptr && drop_prob[i] > 0.0f;
      st = !a ? 0u : !up ? 1u : lossy ? 3u : 2u;
      if (alive_out != nullptr) alive_out[i] = up;
    }
    const uint32_t low = __ballot_sync(kFullMask, st & 1u);
    const uint32_t high = __ballot_sync(kFullMask, st >> 1);
    if ((threadIdx.x & 31) == 0) node[i >> 5] = make_uint2(low, high);
  }
}

struct Edge {
  uint8_t fd, alerted, down, streak, ok, seen;
  uint32_t hist;
};

// Whether the probe of edge e is lost to random loss, for an edge whose
// observer probes a live lossy subject past probe_drop: at a drop
// probability of 1 or more without a draw (draws lie in [0, 1)), else when
// the edge's word under the round's probe key, at counter e (the edge's
// index in the call's [C, K] streams, or in its shard's [rows, K] block),
// lies below it.
__device__ __forceinline__ bool lost_probe(const Params& p, uint2 key, int64_t e) {
  const float prob = __ldg(p.drop_prob + __ldg(p.subjects + e));
  return prob >= 1.0f || jax_threefry::uniform(key, e) < prob;
}

// One edge's FD step from whether its observer probes, its subject's state,
// whether random loss took the probe, and its own per-edge values.
template <bool kGray, bool kWindow>
__device__ __forceinline__ Edge edge_step(const Params& p, bool obs_probing,
                                          uint32_t subj_state, uint8_t drop, bool lost,
                                          uint8_t fd, uint8_t alerted, uint8_t streak,
                                          uint8_t ok_count, uint32_t hist, uint8_t seen) {
  const bool watching = obs_probing && subj_state != 0;
  const bool ok = subj_state >= 2 && !drop && !lost;
  const bool fail = watching && !ok;
  Edge e;
  e.hist = hist;
  e.seen = seen;
  if (kWindow) {
    // a probed edge shifts its outcome into the window and counts the probe
    // (the uint8 count wraps before the clamp, as the engine's plane does)
    if (watching) {
      e.hist = ((hist << 1) | (fail ? 1u : 0u)) & p.window_mask;
      const uint8_t next = static_cast<uint8_t>(seen + 1);
      e.seen = next < p.window ? next : static_cast<uint8_t>(p.window);
    }
    e.fd = fd;
    e.streak = streak;
    e.ok = ok_count;
    const bool down = watching && e.seen >= p.window &&
                      __popc(e.hist) >= p.window_fire && !alerted;
    e.down = down;
    e.alerted = alerted || down;
    return e;
  }
  e.fd = fd + ((fail && fd < 255) ? 1 : 0);
  bool down = watching && e.fd >= p.threshold && !alerted;
  e.streak = streak;
  e.ok = ok_count;
  if (kGray) {
    const bool ok_event = watching && ok;
    e.streak = ok_event ? 0 : streak + ((fail && streak < 255) ? 1 : 0);
    e.ok = ok_count + ((ok_event && ok_count < 255) ? 1 : 0);
    down = down || (fail && e.streak >= p.confirm && ok_count >= p.warmup && !alerted);
  }
  e.down = down;
  e.alerted = alerted || down;
  return e;
}

__device__ __forceinline__ int64_t slot_first(const Params& p, int64_t j) {
  return j * kVec - p.shift;
}

__device__ __forceinline__ bool slot_vector(const Params& p, int64_t first) {
  return p.vec_ok && first >= 0 && first + kVec <= p.n;
}

// Observer-indexed outputs of slot j and its 16 new_down bits, under the
// round's probe key `key`. A slot inside the aligned range moves each stream
// as 16-byte accesses; the first and last slots take scalar accesses.
template <bool kRandom, bool kGray, bool kWindow>
__device__ __forceinline__ void observer_slot(const Params& p, uint32_t turn, uint2 key,
                                              int64_t j) {
  const int64_t first = slot_first(p, j);
  const bool vec = slot_vector(p, first);
  Ints16 subj, hist;
  Bytes16 drop, fd, al, st, okc, seen;
  bool up[kVec];
  if (vec) {
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      subj.v[q] = __ldcs(reinterpret_cast<const int4*>(p.subjects + first) + q);
      if (kWindow) hist.v[q] = __ldcs(reinterpret_cast<const int4*>(p.hist + first) + q);
    }
    drop.v = __ldcs(reinterpret_cast<const uint4*>(p.probe_drop + first));
    if (!kWindow) fd.v = __ldcs(reinterpret_cast<const uint4*>(p.fd_fail + first));
    al.v = __ldcs(reinterpret_cast<const uint4*>(p.alerted + first));
    if (kGray) {
      st.v = __ldcs(reinterpret_cast<const uint4*>(p.streak + first));
      okc.v = __ldcs(reinterpret_cast<const uint4*>(p.fd_ok + first));
    }
    if (kWindow) seen.v = __ldcs(reinterpret_cast<const uint4*>(p.seen + first));
    const int64_t row = first / p.k;
    int kk = static_cast<int>(first - row * p.k);
    int64_t o = p.row0 + row;
    bool u = probing(p, o, turn);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      up[i] = u;
      if (i + 1 < kVec && ++kk == p.k) {
        kk = 0;
        u = probing(p, ++o, turn);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int64_t e = first + i;
      const bool in = e >= 0 && e < p.n;  // lanes outside [0, n) watch nothing
      subj.i[i] = in ? __ldg(p.subjects + e) : 0;
      drop.b[i] = in ? __ldg(p.probe_drop + e) : 0;
      fd.b[i] = !kWindow && in ? __ldg(p.fd_fail + e) : 0;
      al.b[i] = in ? __ldg(p.alerted + e) : 0;
      st.b[i] = kGray && in ? __ldg(p.streak + e) : 0;
      okc.b[i] = kGray && in ? __ldg(p.fd_ok + e) : 0;
      hist.i[i] = kWindow && in ? __ldg(p.hist + e) : 0;
      seen.b[i] = kWindow && in ? __ldg(p.seen + e) : 0;
      up[i] = in && probing(p, p.row0 + e / p.k, turn);
    }
  }
  uint32_t ss[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) ss[i] = node_state(p, subj.i[i]);
  // Random loss, only on the edges where it can change the outcome: those
  // whose observer probes a live lossy subject past probe_drop. A lane loops
  // over its own such edges, so a warp makes as many draws as its busiest
  // lane needs.
  uint32_t lost = 0;
  if (kRandom) {
    uint32_t need = 0;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      need |= static_cast<uint32_t>(up[i] && ss[i] == 3u && !drop.b[i]) << i;
    for (; need != 0; need &= need - 1) {
      const int i = __ffs(need) - 1;
      lost |= static_cast<uint32_t>(lost_probe(p, key, first + i)) << i;
    }
  }

  Bytes16 fd_o, al_o, st_o, ok_o, seen_o;
  Ints16 hist_o;
  uint32_t down_bits = 0;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const Edge r = edge_step<kGray, kWindow>(
        p, up[i], ss[i], drop.b[i], (lost >> i) & 1u, fd.b[i], al.b[i], st.b[i], okc.b[i],
        static_cast<uint32_t>(hist.i[i]), seen.b[i]);
    fd_o.b[i] = r.fd;
    al_o.b[i] = r.alerted;
    st_o.b[i] = r.streak;
    ok_o.b[i] = r.ok;
    hist_o.i[i] = static_cast<int32_t>(r.hist);
    seen_o.b[i] = r.seen;
    down_bits |= static_cast<uint32_t>(r.down) << i;
  }
  if (vec) {
    if (!kWindow) __stcs(reinterpret_cast<uint4*>(p.fd_fail_out + first), fd_o.v);
    __stcs(reinterpret_cast<uint4*>(p.alerted_out + first), al_o.v);
    if (kGray) {
      __stcs(reinterpret_cast<uint4*>(p.streak_out + first), st_o.v);
      __stcs(reinterpret_cast<uint4*>(p.fd_ok_out + first), ok_o.v);
    }
    if (kWindow) {
#pragma unroll
      for (int q = 0; q < kVec / 4; ++q)
        __stcs(reinterpret_cast<int4*>(p.hist_out + first) + q, hist_o.v[q]);
      __stcs(reinterpret_cast<uint4*>(p.seen_out + first), seen_o.v);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int64_t e = first + i;
      if (e < 0 || e >= p.n) continue;
      if (!kWindow) p.fd_fail_out[e] = fd_o.b[i];
      p.alerted_out[e] = al_o.b[i];
      if (kGray) {
        p.streak_out[e] = st_o.b[i];
        p.fd_ok_out[e] = ok_o.b[i];
      }
      if (kWindow) {
        p.hist_out[e] = hist_o.i[i];
        p.seen_out[e] = seen_o.b[i];
      }
    }
  }
  p.new_down[j] = static_cast<uint16_t>(down_bits);
  // one store of the flag per warp that raised an alert
  const unsigned active_lanes = __activemask();
  if (__any_sync(active_lanes, down_bits != 0) &&
      (threadIdx.x & 31) == static_cast<unsigned>(__ffs(active_lanes) - 1))
    *p.any_down = 1;
}

// new_down of the observer edge (o, kk): from the flat bits of one call
// (kShards false), or from shard o / rows's segment (kShards true). The
// shard is a multiply-high and a shift (exact for 0 <= o < 2^31), and every
// index fits 32 bits: the wrapper bounds C * K by 2^31 and the bitset by
// 2^32 words.
template <bool kShards>
__device__ __forceinline__ uint8_t observer_down(const Params& p, int32_t o, int kk) {
  if (kShards) {
    const uint32_t u = static_cast<uint32_t>(o);
    const uint32_t s = __umulhi(u << 1, p.row_magic) >> p.row_shift;
    const uint32_t b = (u - s * p.shard_rows) * static_cast<uint32_t>(p.k) + kk;
    return (__ldg(p.bits + (s * p.seg_words + (b >> 5))) >> (b & 31)) & 1u;
  }
  const int64_t b = static_cast<int64_t>(o) * p.k + kk + p.shift;
  return (__ldg(p.bits + (b >> 5)) >> (b & 31)) & 1u;
}

// down_arrivals of the destination edges of slot j. With `gather` false no
// edge has new_down set, so the observers are not read.
template <bool kShards>
__device__ __forceinline__ void destination_slot(const Params& p, bool gather, int64_t j) {
  const int64_t first = slot_first(p, j);
  const bool vec = slot_vector(p, first);
  Ints16 obs;
  Bytes16 dr, out;
  int ring[kVec];
  uint8_t act[kVec];
  if (vec) {
    if (gather) {
#pragma unroll
      for (int q = 0; q < kVec / 4; ++q)
        obs.v[q] = __ldcs(reinterpret_cast<const int4*>(p.observers + first) + q);
    }
    dr.v = __ldcs(reinterpret_cast<const uint4*>(p.down_reports + first));
    int64_t d = first / p.k;
    int kk = static_cast<int>(first - d * p.k);
    uint8_t a = __ldg(p.active + d);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      ring[i] = kk;
      act[i] = a;
      if (i + 1 < kVec && ++kk == p.k) {
        kk = 0;
        a = __ldg(p.active + ++d);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int64_t e = first + i;
      const bool in = e >= 0 && e < p.n;
      const int64_t d = in ? e / p.k : 0;
      obs.i[i] = in && gather ? __ldg(p.observers + e) : 0;
      dr.b[i] = in ? __ldg(p.down_reports + e) : 0;
      ring[i] = in ? static_cast<int>(e - d * p.k) : 0;
      act[i] = in ? __ldg(p.active + d) : 0;
    }
  }
  uint8_t got[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    got[i] = gather ? observer_down<kShards>(p, obs.i[i], ring[i]) : uint8_t(0);
#pragma unroll
  for (int i = 0; i < kVec; ++i) out.b[i] = (got[i] | dr.b[i]) & act[i];
  if (vec) {
    __stcs(reinterpret_cast<uint4*>(p.down_arrivals + first), out.v);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int64_t e = first + i;
      if (e >= 0 && e < p.n) p.down_arrivals[e] = out.b[i];
    }
  }
}

// Pass 2: observer-indexed outputs and the new_down bits.
template <bool kRandom, bool kGray, bool kWindow>
__global__ void __launch_bounds__(kThreads) observer_pass(Params p) {
  const uint32_t turn = this_turn(p);
  const uint2 key = kRandom ? *p.probe : make_uint2(0u, 0u);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < p.slots; j += stride)
    observer_slot<kRandom, kGray, kWindow>(p, turn, key, j);
}

// What differs between the shards of a per-device fd_phase_rows call: the
// streams of the shard's [rows, K] blocks, its bitset segment (the data
// words, then the any_down word) and its slot layout.
struct Shard {
  const int32_t* subjects;
  const uint8_t* probe_drop;
  const uint8_t* fd_fail;
  const uint8_t* alerted;
  const uint8_t* streak;
  const uint8_t* fd_ok;
  const int32_t* hist;
  const uint8_t* seen;
  uint8_t* fd_fail_out;
  uint8_t* alerted_out;
  uint8_t* streak_out;
  uint8_t* fd_ok_out;
  int32_t* hist_out;
  uint8_t* seen_out;
  uint32_t* bits;
  uint32_t* any_down;
  int64_t n;
  int64_t row0;
  int64_t slots;
  bool vec_ok;
};

// The observer pass's parameter: what the shards share (the per-shard
// fields of `p` are shard 0's) and each shard. It fits the classic 4 KB of
// kernel parameters.
struct ShardTable {
  Params p;
  Shard shard[kMaxShards];
};
static_assert(sizeof(ShardTable) <= 4096, "the shard table must fit 4 KB of kernel parameters");

Shard shard_of(const Params& p) {
  return Shard{p.subjects,   p.probe_drop,  p.fd_fail,   p.alerted,     p.streak,
               p.fd_ok,      p.hist,        p.seen,      p.fd_fail_out, p.alerted_out,
               p.streak_out, p.fd_ok_out,   p.hist_out,  p.seen_out,
               const_cast<uint32_t*>(p.bits), p.any_down, p.n,       p.row0,
               p.slots,      p.vec_ok};
}

__device__ __forceinline__ Params shard_params(const ShardTable& t, int s) {
  const Shard& h = t.shard[s];
  Params p = t.p;
  p.subjects = h.subjects;
  p.probe_drop = h.probe_drop;
  p.fd_fail = h.fd_fail;
  p.alerted = h.alerted;
  p.streak = h.streak;
  p.fd_ok = h.fd_ok;
  p.hist = h.hist;
  p.seen = h.seen;
  p.fd_fail_out = h.fd_fail_out;
  p.alerted_out = h.alerted_out;
  p.streak_out = h.streak_out;
  p.fd_ok_out = h.fd_ok_out;
  p.hist_out = h.hist_out;
  p.seen_out = h.seen_out;
  p.bits = h.bits;
  p.new_down = reinterpret_cast<uint16_t*>(h.bits);
  p.any_down = h.any_down;
  p.n = h.n;
  p.row0 = h.row0;
  p.slots = h.slots;
  p.probe += s;
  p.shift = 0;
  p.vec_ok = h.vec_ok;
  return p;
}

// Pulls the lines of the first and last edge in [0, n) of the slot that
// starts at `first` into L2, in every stream the observer pass reads.
template <bool kRandom, bool kGray, bool kWindow>
__device__ __forceinline__ void prefetch_slot(const Params& p, int64_t first) {
  const int64_t lo = first < 0 ? 0 : first;
  const int64_t hi = (first + kVec < p.n ? first + kVec : p.n) - 1;
  if (lo > hi) return;
  const auto pull = [lo, hi](const void* stream, int size) {
    const char* base = static_cast<const char*>(stream);
    asm volatile("prefetch.global.L2 [%0];" ::"l"(base + lo * size));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(base + hi * size));
  };
  pull(p.subjects, 4);
  pull(p.probe_drop, 1);
  pull(p.alerted, 1);
  if (!kWindow) pull(p.fd_fail, 1);
  if (kGray) {
    pull(p.streak, 1);
    pull(p.fd_ok, 1);
  }
  if (kWindow) {
    pull(p.hist, 4);
    pull(p.seen, 1);
  }
}

// Pass 2 of a per-device fd_phase_rows call: shard blockIdx.y of the table,
// its slots strided over blockIdx.x. Launched as a dependent of the node
// pass, it starts while that pass runs: it pulls its first slot's streams
// into L2 and reads the round and the halt flag (all written before the node
// pass), then waits for the node pass to end (griddepcontrol.wait, which
// returns at once for a pass launched the usual way) before it reads the
// node table and its shard's probe key, or writes. A halted round is
// nobody's turn: with rpi at least 2 no observer's phase equals kNoTurn, so
// no observer probes.
template <bool kRandom, bool kGray, bool kWindow>
__global__ void __launch_bounds__(kSplitThreads) rows_pass(const __grid_constant__ ShardTable t) {
  Params p = shard_params(t, blockIdx.y);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j0 < p.slots) prefetch_slot<kRandom, kGray, kWindow>(p, slot_first(p, j0));
  const bool halted = p.halt != nullptr && *p.halt != 0;
  const uint32_t due = this_turn(p);
  const uint32_t turn = halted ? kNoTurn : due;
  p.rpi = halted && p.rpi < 2 ? 2 : p.rpi;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const uint2 key = kRandom ? *p.probe : make_uint2(0u, 0u);
  for (int64_t j = j0; j < p.slots; j += stride)
    observer_slot<kRandom, kGray, kWindow>(p, turn, key, j);
}

// Pass 3: the destination gather from the new_down bits, skipped when no
// edge raised an alert: the any_down flag of the call (kShards false), or
// the OR of every shard segment's flag (kShards true).
template <bool kShards>
__global__ void __launch_bounds__(kThreads) gather_pass(Params p) {
  bool gather;
  if (kShards) {
    int any = 0;
    for (int s = threadIdx.x; s < p.n_shards; s += blockDim.x)
      any |= __ldg(p.bits + (static_cast<int64_t>(s) + 1) * p.seg_words - 1) != 0u;
    gather = __syncthreads_or(any) != 0;
  } else {
    gather = *p.any_down != 0;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < p.slots; j += stride)
    destination_slot<kShards>(p, gather, j);
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Edge h of a stream the instantiation uses, null for one it does not.
template <class T>
const void* at(const T* stream, int64_t h) {
  return stream ? stream + h : nullptr;
}

// The first edge of a byte stream at a 16-byte boundary.
int64_t first_boundary(const void* bytes) {
  return (16 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(bytes) % 16)) % 16;
}

// Slot layout: when every stream reaches a 16-byte boundary at edge h,
// slots start at h (the slot before it holds edges [0, h)); otherwise every
// slot takes the scalar path.
void set_slots(Params& p, int64_t h) {
  const void* streams[] = {
      at(p.subjects, h),    at(p.observers, h),   at(p.probe_drop, h),
      at(p.down_reports, h), at(p.fd_fail, h),     at(p.alerted, h),
      at(p.streak, h),      at(p.fd_ok, h),       at(p.hist, h),
      at(p.seen, h),        at(p.fd_fail_out, h), at(p.alerted_out, h),
      at(p.streak_out, h),  at(p.fd_ok_out, h),   at(p.hist_out, h),
      at(p.seen_out, h),    at(p.down_arrivals, h),
  };
  p.vec_ok = h < p.n;
  for (const void* s : streams) p.vec_ok = p.vec_ok && aligned16(s);
  p.shift = p.vec_ok ? static_cast<int>((kVec - h) % kVec) : 0;
  p.slots = (p.n + p.shift + kVec - 1) / kVec;
}

int blocks_for(int64_t work) {
  const long long need = (work + kThreads - 1) / kThreads;
  return static_cast<int>(need < 1 ? 1 : (need < kMaxBlocks ? need : kMaxBlocks));
}

// Blocks of kSplitThreads threads of kKernel that the current card runs at
// once: its SM count times the kernel's occupancy, queried once a card.
template <auto kKernel>
int resident_blocks(int* blocks) {
  static int known[kMaxDevices] = {};
  int dev = 0;
  int err = cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (known[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == 0) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel,
                                                                      kSplitThreads, 0);
    if (err != 0) return err;
    known[dev] = std::max(1, sms * per_sm);
  }
  *blocks = known[dev];
  return 0;
}

// Blocks along x for `slots` slots, a slot a thread, at most `cap`.
unsigned split_blocks(int64_t slots, int cap) {
  const int64_t need = (slots + kSplitThreads - 1) / kSplitThreads;
  return static_cast<unsigned>(std::max<int64_t>(1, std::min<int64_t>(need, std::max(cap, 1))));
}

bool bad_policy(int window, bool gray) { return window < 0 || window > 16 || (window > 0 && gray); }

// The probe keys in a node table of `c` nodes: after its two plane words a
// 32 nodes.
uint2* probe_keys(void* node_table, long long c) {
  return static_cast<uint2*>(node_table) + (c + 31) / 32;
}

// The key half of the node pass's parameters: `n` probe keys into the node
// table, an fd_phase_rows call's folded with its shards' global indices
// (`shards`, null for fd_phase_fused).
Keys round_keys(const void* key_in, void* key_out, const void* halt, void* node_table,
                long long c, int n, const long long* shards) {
  Keys keys{};
  keys.in = static_cast<const int64_t*>(key_in);
  keys.out = static_cast<int64_t*>(key_out);
  keys.halt = static_cast<const uint8_t*>(halt);
  keys.probe = probe_keys(node_table, c);
  keys.n = n;
  for (int s = 0; shards != nullptr && s < n; ++s) keys.shard[s] = static_cast<uint32_t>(shards[s]);
  return keys;
}

// Pass 1 of either call, on `stream`.
template <bool kShards>
int launch_nodes(const void* active, const void* alive, const void* drop_prob, long long c,
                 void* alive_out, void* node_table, const Flags& flags, const Keys& keys,
                 cudaStream_t stream) {
  node_pass<kShards><<<blocks_for(c), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(active), static_cast<const uint8_t*>(alive),
      static_cast<const float*>(drop_prob), c, static_cast<uint8_t*>(alive_out),
      static_cast<uint2*>(node_table), flags, keys);
  return static_cast<int>(cudaGetLastError());
}

// The observer pass's parameters from the state pointers; the policy picks
// which per-edge planes it reads and writes. The caller adds the gather's
// streams and the slot layout.
Params edge_params(const void* node_table, const void* drop_prob, const void* subjects,
                   const void* probe_drop, const void* fd_fail,
                   const void* alerted, const void* fd_streak, const void* fd_ok,
                   const void* fd_hist, const void* fd_seen, const void* round,
                   void* fd_fail_out, void* alerted_out, void* fd_streak_out,
                   void* fd_ok_out, void* fd_hist_out, void* fd_seen_out, void* new_down,
                   uint32_t* any_down, int64_t n, int k, int threshold, int gray_confirm,
                   int gray_warmup, int rounds_per_interval, int window, int window_fire) {
  const bool gray = gray_confirm > 0;
  const bool windowed = window > 0;
  Params p{};
  p.node = static_cast<const uint2*>(node_table);
  p.bits = static_cast<const uint32_t*>(new_down);
  p.any_down = any_down;
  p.round = static_cast<const int32_t*>(round);
  p.rpi = rounds_per_interval;
  p.drop_prob = static_cast<const float*>(drop_prob);
  p.subjects = static_cast<const int32_t*>(subjects);
  p.probe_drop = static_cast<const uint8_t*>(probe_drop);
  p.fd_fail = windowed ? nullptr : static_cast<const uint8_t*>(fd_fail);
  p.alerted = static_cast<const uint8_t*>(alerted);
  p.streak = gray ? static_cast<const uint8_t*>(fd_streak) : nullptr;
  p.fd_ok = gray ? static_cast<const uint8_t*>(fd_ok) : nullptr;
  p.hist = windowed ? static_cast<const int32_t*>(fd_hist) : nullptr;
  p.seen = windowed ? static_cast<const uint8_t*>(fd_seen) : nullptr;
  p.fd_fail_out = windowed ? nullptr : static_cast<uint8_t*>(fd_fail_out);
  p.alerted_out = static_cast<uint8_t*>(alerted_out);
  p.streak_out = gray ? static_cast<uint8_t*>(fd_streak_out) : nullptr;
  p.fd_ok_out = gray ? static_cast<uint8_t*>(fd_ok_out) : nullptr;
  p.hist_out = windowed ? static_cast<int32_t*>(fd_hist_out) : nullptr;
  p.seen_out = windowed ? static_cast<uint8_t*>(fd_seen_out) : nullptr;
  p.new_down = static_cast<uint16_t*>(new_down);
  p.n = n;
  p.k = k;
  p.threshold = threshold;
  p.confirm = gray_confirm;
  p.warmup = gray_warmup;
  p.window = window;
  p.window_fire = window_fire;
  p.window_mask = windowed ? (1u << window) - 1u : 0u;
  return p;
}


// Launch<kRandom, kGray, kWindow>::run(args...) in the instantiation of the
// loss model (random loss on when drop_prob is given) and policy of `p`.
template <template <bool, bool, bool> class Launch, class... Args>
int by_policy(const Params& p, const Args&... args) {
  const bool random = p.drop_prob != nullptr;
  if (p.window > 0) {
    return random ? Launch<true, false, true>::run(args...)
                  : Launch<false, false, true>::run(args...);
  }
  if (random) {
    return p.confirm > 0 ? Launch<true, true, false>::run(args...)
                         : Launch<true, false, false>::run(args...);
  }
  return p.confirm > 0 ? Launch<false, true, false>::run(args...)
                       : Launch<false, false, false>::run(args...);
}

// Pass 2 of fd_phase_fused.
template <bool kRandom, bool kGray, bool kWindow>
struct ObserverLaunch {
  static int run(const Params& p, cudaStream_t stream) {
    observer_pass<kRandom, kGray, kWindow><<<blocks_for(p.slots), kThreads, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
};

// Pass 2 of fd_phase_rows: a row of blocks a shard, as long as the largest
// shard's slots need (a slot a thread), all rows together at most what the
// card runs at once.
template <bool kRandom, bool kGray, bool kWindow>
struct RowsLaunch {
  static int run(const ShardTable& t, int n_shards, int64_t slots, cudaStream_t stream) {
    int resident = 0;
    const int err = resident_blocks<rows_pass<kRandom, kGray, kWindow>>(&resident);
    if (err != 0) return err;
    cudaLaunchAttribute dependent{};
    dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    dependent.val.programmaticStreamSerializationAllowed = kDependentLaunch ? 1 : 0;
    cudaLaunchConfig_t config{};
    config.gridDim = dim3(split_blocks(slots, resident / n_shards), n_shards);
    config.blockDim = dim3(kSplitThreads);
    config.stream = stream;
    config.attrs = &dependent;
    config.numAttrs = 1;
    const int launched = cudaLaunchKernelEx(&config, rows_pass<kRandom, kGray, kWindow>, t);
    return launched != 0 ? launched : static_cast<int>(cudaGetLastError());
  }
};

// The reciprocal of d that observer_down applies, for 1 <= d <= 2^31:
// shift = ceil(log2 d) and magic = ceil(2^(31 + shift) / d), below 2^32.
// Then o / d = floor(2o * magic / 2^(32 + shift)) for every 0 <= o < 2^31
// (kernels.row_reciprocal computes them and shows why).
bool is_reciprocal(long long d, unsigned magic, int shift) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  return shift == l && magic == ((1ULL << (31 + l)) + d - 1) / d;
}

// A row of the host table that fd_phase_rows takes, one a shard: the
// pointers of the shard's [rows, K] blocks and of their outputs (0 for a
// stream the call does not use), of its bitset segment, then row0, rows and
// the shard's global index (what the fold takes).
enum ShardField {
  kSubjects, kProbeDrop, kFdFail, kAlerted, kStreak, kFdOk, kHist, kSeen,
  kFdFailOut, kAlertedOut, kStreakOut, kFdOkOut, kHistOut, kSeenOut, kBits, kRow0, kRows,
  kShard, kShardFields
};

}  // namespace

// Plain C interface for ctypes. Device pointers; drop_prob is null when
// random loss is off, the streak/fd_ok pointers when gray_confirm is 0,
// the fd_hist/fd_seen pointers under the cumulative policy (window 0), and
// the fd_fail pointers under the windowed one (window in [1, 16], with
// window_fire the failures in a full window that fire; no gray path).
// key is the state's int64 [2] key and key_out a fresh one, which takes the
// split's new key, or key as it came when the bool halt (null: never
// halted) is set; the halt flag changes nothing else.
// The wrapper allocates the kernel's scratch:
// node_table of 2 * ceil(C / 32) + 3 words (the node state planes, the
// probe key, then the any_down flag) and new_down of ceil((C*K + 32) / 32)
// words. Returns the first non-zero cudaGetLastError() after a launch (0 =
// all launched), or cudaErrorInvalidValue for a window out of range or
// beside the gray path. A call with no edge launches the node pass alone.
extern "C" int fd_phase_fused(
    const void* active, const void* alive, const void* drop_prob,
    const void* subjects, const void* observers, const void* probe_drop,
    const void* down_reports, const void* key, const void* halt, const void* fd_fail,
    const void* alerted, const void* fd_streak, const void* fd_ok,
    const void* fd_hist, const void* fd_seen, const void* round,
    void* key_out, void* alive_out, void* fd_fail_out, void* alerted_out, void* fd_streak_out,
    void* fd_ok_out, void* fd_hist_out, void* fd_seen_out, void* down_arrivals,
    void* node_table, void* new_down, long long c, int k, int threshold,
    int gray_confirm, int gray_warmup, int rounds_per_interval, int window,
    int window_fire, void* stream) {
  if (c < 0 || k < 0 || bad_policy(window, gray_confirm > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Flags flags{};
  flags.word[0] = reinterpret_cast<uint32_t*>(probe_keys(node_table, c) + 1);
  flags.n = 1;
  int err = launch_nodes<false>(active, alive, drop_prob, c, alive_out, node_table, flags,
                                round_keys(key, key_out, halt, node_table, c, 1, nullptr), st);
  if (err != 0 || c * k == 0) return err;

  Params p = edge_params(node_table, drop_prob, subjects, probe_drop, fd_fail, alerted,
                         fd_streak, fd_ok, fd_hist, fd_seen, round, fd_fail_out, alerted_out,
                         fd_streak_out, fd_ok_out, fd_hist_out, fd_seen_out, new_down,
                         flags.word[0], static_cast<int64_t>(c) * k, k, threshold, gray_confirm,
                         gray_warmup, rounds_per_interval, window, window_fire);
  p.probe = probe_keys(node_table, c);
  p.observers = static_cast<const int32_t*>(observers);
  p.down_reports = static_cast<const uint8_t*>(down_reports);
  p.active = static_cast<const uint8_t*>(active);
  p.down_arrivals = static_cast<uint8_t*>(down_arrivals);
  set_slots(p, first_boundary(p.alerted));
  err = by_policy<ObserverLaunch>(p, p, st);
  if (err != 0) return err;
  gather_pass<false><<<blocks_for(p.slots), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The FD phase's observer side over the shards one device holds: the node
// pass over all C nodes once, then the observer pass over every shard's
// rows [row0, row0 + rows) in one launch. `shards` is a host table of
// n_shards rows of kShardFields values (ShardField), at most kMaxShards,
// each of at least one row; the [rows, K] pointers are the shard's own
// blocks, its segment ceil(rows * K / 32) + 1 words (see the note at the
// top), written whole. active, alive and drop_prob are [C] (drop_prob null:
// random loss off); round is the int32 round and halt a bool flag (null:
// never halted), both read on the device. key and key_out as in
// fd_phase_fused; each shard draws under the probe key folded with its
// global index, over its local edges. node_table holds 2 * ceil(C / 32) + 2 * kMaxShards
// words of scratch. Returns as fd_phase_fused does, and
// cudaErrorInvalidValue for a table it cannot take.
extern "C" int fd_phase_rows(
    const void* active, const void* alive, const void* drop_prob, const void* round,
    const void* halt, const void* key, void* key_out, const long long* shards, int n_shards,
    void* node_table, long long c, int k, int threshold, int gray_confirm, int gray_warmup,
    int rounds_per_interval, int window, int window_fire, void* stream) {
  if (c < 0 || k < 0 || bad_policy(window, gray_confirm > 0) || n_shards < 1 ||
      n_shards > kMaxShards)
    return static_cast<int>(cudaErrorInvalidValue);
  ShardTable t{};
  Flags flags{};
  long long index[kMaxShards] = {};
  int64_t slots = 0;
  for (int s = 0; s < n_shards; ++s) {
    const long long* f = shards + static_cast<int64_t>(s) * kShardFields;
    if (f[kRow0] < 0 || f[kRows] < 1 || f[kRow0] + f[kRows] > c || f[kShard] < 0 ||
        f[kShard] > 0xffffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    const auto at = [f](int i) { return reinterpret_cast<void*>(f[i]); };
    const int64_t n = f[kRows] * k;
    const int64_t data_words = (n + 31) / 32;
    uint32_t* bits = static_cast<uint32_t*>(at(kBits));
    Params p = edge_params(node_table, drop_prob, at(kSubjects), at(kProbeDrop), at(kFdFail),
                           at(kAlerted), at(kStreak), at(kFdOk), at(kHist), at(kSeen), round,
                           at(kFdFailOut), at(kAlertedOut), at(kStreakOut), at(kFdOkOut),
                           at(kHistOut), at(kSeenOut), bits, bits + data_words, n, k, threshold,
                           gray_confirm, gray_warmup, rounds_per_interval, window, window_fire);
    p.row0 = f[kRow0];
    p.halt = static_cast<const uint8_t*>(halt);
    p.probe = probe_keys(node_table, c);
    // slots from local edge 0, so local edge e is bit e of the segment; two
    // slots a word, the last word's lanes past n writing zeros
    set_slots(p, 0);
    p.slots = data_words * 2;
    if (s == 0) t.p = p;
    t.shard[s] = shard_of(p);
    flags.word[s] = p.any_down;
    index[s] = f[kShard];
    slots = std::max(slots, p.slots);
  }
  flags.n = n_shards;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_nodes<true>(
      active, alive, drop_prob, c, nullptr, node_table, flags,
      round_keys(key, key_out, halt, node_table, c, n_shards, index), st);
  if (err != 0) return err;
  return by_policy<RowsLaunch>(t.p, t, n_shards, slots, st);
}

// The destination gather over all [C, K] edges from the bitset segments of
// C / shard_rows shards, each of seg_words words, laid end to end; row_magic
// and row_shift are the reciprocal of shard_rows (is_reciprocal). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue when the
// shards do not tile C, C * K exceeds 2^31 or the bitset 2^32 words.
extern "C" int fd_gather(const void* active, const void* observers, const void* down_reports,
                         const void* bits, void* down_arrivals, long long c, int k,
                         long long shard_rows, long long seg_words, unsigned row_magic,
                         int row_shift, void* stream) {
  if (c <= 0 || k <= 0) return 0;
  if (shard_rows <= 0 || c % shard_rows != 0 || c * k > (1LL << 31) ||
      seg_words != (shard_rows * k + 31) / 32 + 1 || c / shard_rows * seg_words > 0xffffffffLL ||
      !is_reciprocal(shard_rows, row_magic, row_shift))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.active = static_cast<const uint8_t*>(active);
  p.observers = static_cast<const int32_t*>(observers);
  p.down_reports = static_cast<const uint8_t*>(down_reports);
  p.down_arrivals = static_cast<uint8_t*>(down_arrivals);
  p.bits = static_cast<const uint32_t*>(bits);
  p.n = static_cast<int64_t>(c) * k;
  p.k = k;
  p.shard_rows = static_cast<uint32_t>(shard_rows);
  p.row_magic = row_magic;
  p.row_shift = row_shift;
  p.n_shards = static_cast<int32_t>(c / shard_rows);
  p.seg_words = static_cast<uint32_t>(seg_words);
  set_slots(p, first_boundary(p.down_arrivals));
  int resident = 0;
  const int err = resident_blocks<gather_pass<true>>(&resident);
  if (err != 0) return err;
  gather_pass<true><<<split_blocks(p.slots, resident), kSplitThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
