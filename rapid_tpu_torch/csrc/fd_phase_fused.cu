// The whole failure-detector phase of one scan round, fused, for Hopper
// (sm_90a): probe evaluation, the saturating counter, the gray streak path,
// the alert latch, and the destination-indexed alert gather.
//
// Replaces rapid_tpu/sim/pallas_kernels.py::_fd_phase_kernel (wrapper
// fd_phase) together with the jnp ops around it in
// rapid_tpu/sim/engine.py::_fd_phase (574-653), cumulative policy. For node
// n, observer o, ring k and subject s = subjects[o, k]:
//
//   alive[n]       = alive_in[n] & active[n]
//   watching(o,k)  = active[o] & active[s] & alive[o] & turn(o)
//   probe_ok(o,k)  = alive[s] & ~probe_drop[o,k] & ~(draw[o,k] < drop_prob[s])
//   fail           = watching & ~probe_ok
//   fd_fail       += fail                (uint8, stops at 255)
//   new_down       = watching & fd_fail >= threshold & ~alerted
//   gray (confirm > 0): ok = watching & probe_ok; streak += fail (stops at
//     255), streak = 0 where ok; fd_ok += ok (stops at 255);
//     new_down |= fail & streak >= confirm & fd_ok_before >= warmup & ~alerted
//   alerted       |= new_down
//   down_arrivals[d,k] = (new_down[observers[d,k], k] | down_reports[d,k])
//                        & active[d]
//
// turn(o) is the staggered FD phase: (uint32(o) * 2654435761) mod rpi ==
// round mod rpi, with the round read from device memory (no host sync).
// The draw term is present only when a draw is given (random loss on).
//
// What bounds it. The compulsory traffic is bytes: at K=10 with random loss
// on and the gray path off, an edge reads subjects, observers and the draw
// (4 B each) and probe_drop, fd_fail, alerted and down_reports (1 B each),
// and writes fd_fail, alerted and down_arrivals (1 B each): 19 B, plus 7 B
// per node (active, alive, drop_prob in; alive out), 0.7 B per edge. The
// gray path adds 4 B per edge; a round with no new alert needs no observers.
// The arithmetic is a few integer operations per edge. What holds the kernel
// above that bound on an H100 is the two random reads per edge that the
// function implies, each waiting on a streamed load before it can issue: the
// subject's state (indexed by subjects[o, k]) and the observer edge's
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
// - PERF.md lists the designs tried and measured on the card that this one
//   beat, among them recomputing new_down in the destination thread.
//
// The kernel allocates nothing: the wrapper passes the outputs, the node
// table, the new_down bits and the stream. Every launch is checked with
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 16;  // edges per slot: one 16-byte access per byte stream
constexpr int kThreads = 512;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr long long kMaxBlocks = 132 * 16;

struct Params {
  // node state, 2 bits per node as two bit planes per 32 nodes: 0 inactive,
  // 1 active, 2 alive, 3 alive and lossy
  const uint2* node;
  const uint32_t* bits;  // bit e + shift is edge e's new_down
  uint32_t* any_down;    // some edge has new_down set
  const int32_t* round;
  int rpi;
  const float* drop_prob;
  const int32_t* subjects;
  const int32_t* observers;
  const uint8_t* probe_drop;
  const uint8_t* down_reports;
  const float* draw;  // null: random loss off
  const uint8_t* fd_fail;
  const uint8_t* alerted;
  const uint8_t* streak;
  const uint8_t* fd_ok;
  const uint8_t* active;
  uint8_t* fd_fail_out;
  uint8_t* alerted_out;
  uint8_t* streak_out;
  uint8_t* fd_ok_out;
  uint8_t* down_arrivals;
  uint16_t* new_down;  // the words of `bits`, written a slot at a time
  int64_t n;           // C * K edges
  int64_t slots;       // slot j holds edges [16j - shift, 16j - shift + 16)
  int shift;
  bool vec_ok;  // every stream is 16-byte aligned at slot starts
  int k;
  int threshold;
  int confirm;
  int warmup;
};

union Bytes16 {
  uint4 v;
  uint8_t b[kVec];
};
union Ints16 {
  int4 v[kVec / 4];
  int32_t i[kVec];
};
union Floats16 {
  float4 v[kVec / 4];
  float f[kVec];
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

// Pass 1: the alive output and the node state planes, a node a thread (a
// warp's ballots make the two plane words of its 32 nodes); clears any_down.
__global__ void node_pass(const uint8_t* __restrict__ active,
                          const uint8_t* __restrict__ alive_in,
                          const float* __restrict__ drop_prob, int64_t c,
                          uint8_t* __restrict__ alive_out, uint2* __restrict__ node,
                          uint32_t* __restrict__ any_down) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid == 0) *any_down = 0;
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
      alive_out[i] = up;
    }
    const uint32_t low = __ballot_sync(kFullMask, st & 1u);
    const uint32_t high = __ballot_sync(kFullMask, st >> 1);
    if ((threadIdx.x & 31) == 0) node[i >> 5] = make_uint2(low, high);
  }
}

struct Edge {
  uint8_t fd, alerted, down, streak, ok;
};

// One edge's FD step from whether its observer probes, its subject's state
// and its own per-edge values. drop_prob[subject] is read only for a lossy
// live subject.
template <bool kRandom, bool kGray>
__device__ __forceinline__ Edge edge_step(const Params& p, bool obs_probing,
                                          uint32_t subj_state, int32_t subject,
                                          uint8_t drop, float draw, uint8_t fd,
                                          uint8_t alerted, uint8_t streak,
                                          uint8_t ok_count) {
  const bool watching = obs_probing && subj_state != 0;
  bool ok = subj_state >= 2 && !drop;
  if (kRandom && ok && subj_state == 3) ok = !(draw < __ldg(p.drop_prob + subject));
  const bool fail = watching && !ok;
  Edge e;
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

// Observer-indexed outputs of slot j and its 16 new_down bits. A slot inside
// the aligned range moves each stream as 16-byte accesses; the first and
// last slots take scalar accesses.
template <bool kRandom, bool kGray>
__device__ __forceinline__ void observer_slot(const Params& p, uint32_t turn, int64_t j) {
  const int64_t first = slot_first(p, j);
  const bool vec = slot_vector(p, first);
  Ints16 subj;
  Floats16 draw;
  Bytes16 drop, fd, al, st, okc;
  bool up[kVec];
  if (vec) {
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      subj.v[q] = __ldcs(reinterpret_cast<const int4*>(p.subjects + first) + q);
      if (kRandom) draw.v[q] = __ldcs(reinterpret_cast<const float4*>(p.draw + first) + q);
    }
    drop.v = __ldcs(reinterpret_cast<const uint4*>(p.probe_drop + first));
    fd.v = __ldcs(reinterpret_cast<const uint4*>(p.fd_fail + first));
    al.v = __ldcs(reinterpret_cast<const uint4*>(p.alerted + first));
    if (kGray) {
      st.v = __ldcs(reinterpret_cast<const uint4*>(p.streak + first));
      okc.v = __ldcs(reinterpret_cast<const uint4*>(p.fd_ok + first));
    }
    int64_t o = first / p.k;
    int kk = static_cast<int>(first - o * p.k);
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
      draw.f[i] = kRandom && in ? __ldg(p.draw + e) : 0.0f;
      drop.b[i] = in ? __ldg(p.probe_drop + e) : 0;
      fd.b[i] = in ? __ldg(p.fd_fail + e) : 0;
      al.b[i] = in ? __ldg(p.alerted + e) : 0;
      st.b[i] = kGray && in ? __ldg(p.streak + e) : 0;
      okc.b[i] = kGray && in ? __ldg(p.fd_ok + e) : 0;
      up[i] = in && probing(p, e / p.k, turn);
    }
  }
  uint32_t ss[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) ss[i] = node_state(p, subj.i[i]);

  Bytes16 fd_o, al_o, st_o, ok_o;
  uint32_t down_bits = 0;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const Edge r = edge_step<kRandom, kGray>(p, up[i], ss[i], subj.i[i], drop.b[i],
                                             draw.f[i], fd.b[i], al.b[i], st.b[i],
                                             okc.b[i]);
    fd_o.b[i] = r.fd;
    al_o.b[i] = r.alerted;
    st_o.b[i] = r.streak;
    ok_o.b[i] = r.ok;
    down_bits |= static_cast<uint32_t>(r.down) << i;
  }
  if (vec) {
    __stcs(reinterpret_cast<uint4*>(p.fd_fail_out + first), fd_o.v);
    __stcs(reinterpret_cast<uint4*>(p.alerted_out + first), al_o.v);
    if (kGray) {
      __stcs(reinterpret_cast<uint4*>(p.streak_out + first), st_o.v);
      __stcs(reinterpret_cast<uint4*>(p.fd_ok_out + first), ok_o.v);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int64_t e = first + i;
      if (e < 0 || e >= p.n) continue;
      p.fd_fail_out[e] = fd_o.b[i];
      p.alerted_out[e] = al_o.b[i];
      if (kGray) {
        p.streak_out[e] = st_o.b[i];
        p.fd_ok_out[e] = ok_o.b[i];
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

// new_down of the observer edge (o, kk).
__device__ __forceinline__ uint8_t observer_down(const Params& p, int32_t o, int kk) {
  const int64_t b = static_cast<int64_t>(o) * p.k + kk + p.shift;
  return (__ldg(p.bits + (b >> 5)) >> (b & 31)) & 1u;
}

// down_arrivals of the destination edges of slot j. With `gather` false no
// edge has new_down set, so the observers are not read.
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
    got[i] = gather ? observer_down(p, obs.i[i], ring[i]) : uint8_t(0);
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
template <bool kRandom, bool kGray>
__global__ void __launch_bounds__(kThreads) observer_pass(Params p) {
  const uint32_t turn = this_turn(p);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < p.slots; j += stride)
    observer_slot<kRandom, kGray>(p, turn, j);
}

// Pass 3: the destination gather from the new_down bits, skipped when no
// edge raised an alert.
__global__ void __launch_bounds__(kThreads) gather_pass(Params p) {
  const bool gather = *p.any_down != 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < p.slots; j += stride)
    destination_slot(p, gather, j);
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Slot layout: when every [C,K] stream reaches a 16-byte boundary at the
// same edge h, slots start at h (the slot before it holds edges [0, h));
// otherwise every slot takes the scalar path.
void set_slots(Params& p) {
  const int64_t h = (16 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(p.fd_fail) % 16)) % 16;
  const void* streams[] = {
      p.subjects + h,     p.observers + h,    p.probe_drop + h,
      p.down_reports + h, p.draw ? p.draw + h : nullptr,
      p.fd_fail + h,      p.alerted + h,      p.streak ? p.streak + h : nullptr,
      p.fd_ok ? p.fd_ok + h : nullptr,         p.fd_fail_out + h,
      p.alerted_out + h,  p.streak_out ? p.streak_out + h : nullptr,
      p.fd_ok_out ? p.fd_ok_out + h : nullptr, p.down_arrivals + h,
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

template <bool kRandom, bool kGray>
int launch_edges(const Params& p, cudaStream_t stream) {
  const int blocks = blocks_for(p.slots);
  observer_pass<kRandom, kGray><<<blocks, kThreads, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_pass<<<blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Device pointers; drop_prob and draw are null
// when random loss is off, the streak/fd_ok pointers when gray_confirm is 0.
// The wrapper allocates the kernel's scratch:
// node_table of 2 * ceil(C / 32) + 1 words (the node state planes, then the
// any_down flag) and new_down of ceil((C*K + 32) / 32) words. Returns the
// first non-zero cudaGetLastError() after a launch (0 = all launched).
extern "C" int fd_phase_fused(
    const void* active, const void* alive, const void* drop_prob,
    const void* subjects, const void* observers, const void* probe_drop,
    const void* down_reports, const void* draw, const void* fd_fail,
    const void* alerted, const void* fd_streak, const void* fd_ok,
    const void* round, void* alive_out, void* fd_fail_out, void* alerted_out,
    void* fd_streak_out, void* fd_ok_out, void* down_arrivals, void* node_table,
    void* new_down, long long c, int k, int threshold, int gray_confirm,
    int gray_warmup, int rounds_per_interval, void* stream) {
  if (c <= 0 || k <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool random = draw != nullptr;
  const bool gray = gray_confirm > 0;
  uint2* node = static_cast<uint2*>(node_table);
  uint32_t* any_down = static_cast<uint32_t*>(node_table) + 2 * ((c + 31) / 32);

  node_pass<<<blocks_for(c), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(active), static_cast<const uint8_t*>(alive),
      random ? static_cast<const float*>(drop_prob) : nullptr, c,
      static_cast<uint8_t*>(alive_out), node, any_down);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  Params p;
  p.node = node;
  p.bits = static_cast<const uint32_t*>(new_down);
  p.any_down = any_down;
  p.round = static_cast<const int32_t*>(round);
  p.rpi = rounds_per_interval;
  p.drop_prob = static_cast<const float*>(drop_prob);
  p.subjects = static_cast<const int32_t*>(subjects);
  p.observers = static_cast<const int32_t*>(observers);
  p.probe_drop = static_cast<const uint8_t*>(probe_drop);
  p.down_reports = static_cast<const uint8_t*>(down_reports);
  p.draw = static_cast<const float*>(draw);
  p.fd_fail = static_cast<const uint8_t*>(fd_fail);
  p.alerted = static_cast<const uint8_t*>(alerted);
  p.streak = gray ? static_cast<const uint8_t*>(fd_streak) : nullptr;
  p.fd_ok = gray ? static_cast<const uint8_t*>(fd_ok) : nullptr;
  p.active = static_cast<const uint8_t*>(active);
  p.fd_fail_out = static_cast<uint8_t*>(fd_fail_out);
  p.alerted_out = static_cast<uint8_t*>(alerted_out);
  p.streak_out = gray ? static_cast<uint8_t*>(fd_streak_out) : nullptr;
  p.fd_ok_out = gray ? static_cast<uint8_t*>(fd_ok_out) : nullptr;
  p.down_arrivals = static_cast<uint8_t*>(down_arrivals);
  p.new_down = static_cast<uint16_t*>(new_down);
  p.n = static_cast<int64_t>(c) * k;
  p.k = k;
  p.threshold = threshold;
  p.confirm = gray_confirm;
  p.warmup = gray_warmup;
  set_slots(p);

  if (random) {
    return gray ? launch_edges<true, true>(p, st)
                : launch_edges<true, false>(p, st);
  }
  return gray ? launch_edges<false, true>(p, st)
              : launch_edges<false, false>(p, st);
}
