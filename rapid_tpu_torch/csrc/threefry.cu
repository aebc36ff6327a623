// One round's random ingress-loss draw: JAX's threefry key split and uniform
// block, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX engine draws a round's loss with
// jax.random inside its round program, which XLA compiles to a threefry pass:
// rapid_tpu/sim/engine.py::_fd_phase (split, then uniform over [C, K]) and
// rapid_tpu/shard/engine.py::_sharded_round (split, fold_in of the shard's
// linear index, uniform over the shard's [C / n, K] rows). This kernel gives
// the same bits, so a lossy run of the port matches the JAX package round for
// round. With JAX's jax_threefry_partitionable (its default) and 32-bit
// integers:
//
//   threefry(k, (x0, x1)) = Random123's threefry2x32_20 of the counter pair
//   (new key, probe key)  = (threefry(key, (0, 0)), threefry(key, (0, 1)))
//   probe key on a mesh   = threefry(probe key, (0, shard))
//   draw[i]               = bitcast<float>((b >> 9) | 0x3F800000) - 1,
//                           b = y0 ^ y1, (y0, y1) = threefry(probe key,
//                           (i >> 32, i & 0xFFFFFFFF)), i the flat index
//
// rapid_tpu_torch/sim/threefry.py is the plain version of the same words.
//
// What bounds it: integer operations, counted by the pipe that can issue
// them, as the loop's SASS issues them (cuobjdump -sass, sm_90a). Each
// element takes the threefry body (2 key adds; 20 rounds of add, rotate and
// xor; 5 key injections of 2 adds, their constants hoisted out of the loop)
// and the float's xor, shift, or and subtract. The 20 rotates (SHF), the 21
// xors (LOP3) and the shift-and-or (one LEA.HI: the or of the exponent
// adds into bits the shift cleared) run only on the ALU pipe, 64 lanes a
// clock an SM: 42 operations. The 32 adds (27 after IADD3 fuses pairs) run
// on the ALU or, as IMAD, on the FMA pipe, so all 70 operations share the
// 128 lanes a clock an SM of the two pipes together. The bound is the larger
// of the two times: 42 ALU operations at 132 SMs x 64 lanes x 1.98 GHz
// (16.7 T/s) against 70 at twice that rate. At [1M, 10] that is 25.1 us,
// against 11.9 us for the 40 MB of stores at 3.35 TB/s. The inputs are the
// two key words and the halt flag.
//
// Design. Elements are independent (the counter is the flat index), so the
// draw is a grid-stride loop of one element a thread a step, and the stores
// of a warp are 128 contiguous bytes. Thread 0 of each block derives the
// split, and on a mesh its shard's fold, once into shared memory; block 0
// writes the new key (the key as it came in a halted round), out of place,
// so no block races the read of the key and the kernel can sit in a CUDA
// graph. The draw does not depend on the halt flag. Shards of one device's
// call are the grid's y dimension (up to kMaxShards), each with its block of
// rows. The rotations are compile-time funnel shifts. A call with no rows
// still launches one block, to split the key.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShards = 16;  // kernels.MAX_SHARDS_PER_CALL
constexpr uint32_t kParity = 0x1BD11BDAu;

struct ShardTable {
  uint32_t index[kMaxShards];  // global shard index folded into each y block
};

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R);
  x1 ^= x0;
}

template <int A, int B, int C, int D>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  mix<A>(x0, x1);
  mix<B>(x0, x1);
  mix<C>(x0, x1);
  mix<D>(x0, x1);
}

// threefry2x32 with 20 rounds of the counter (x0, x1) under the key (k0, k1),
// in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
}

__global__ void __launch_bounds__(kThreads)
    threefry_draw_kernel(const int64_t* __restrict__ key_in, int64_t* __restrict__ key_out,
                         const bool* __restrict__ halt, float* __restrict__ draw,
                         int64_t per_shard, bool fold, ShardTable shards) {
  __shared__ uint32_t probe[2];
  if (threadIdx.x == 0) {
    const uint32_t k0 = static_cast<uint32_t>(key_in[0]);
    const uint32_t k1 = static_cast<uint32_t>(key_in[1]);
    uint32_t p0 = 0u, p1 = 1u;
    threefry(k0, k1, p0, p1);
    if (blockIdx.x == 0 && blockIdx.y == 0) {
      // a halted round keeps its key, as the masked round of the JAX engine
      uint32_t n0 = k0, n1 = k1;
      if (halt == nullptr || !*halt) {
        n0 = 0u;
        n1 = 0u;
        threefry(k0, k1, n0, n1);
      }
      key_out[0] = n0;
      key_out[1] = n1;
    }
    if (fold) {
      uint32_t f0 = 0u, f1 = shards.index[blockIdx.y];
      threefry(p0, p1, f0, f1);
      p0 = f0;
      p1 = f1;
    }
    probe[0] = p0;
    probe[1] = p1;
  }
  __syncthreads();
  const uint32_t k0 = probe[0], k1 = probe[1];
  float* out = draw + static_cast<int64_t>(blockIdx.y) * per_shard;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < per_shard;
       i += stride) {
    uint32_t x0 = static_cast<uint32_t>(i >> 32), x1 = static_cast<uint32_t>(i);
    threefry(k0, k1, x0, x1);
    out[i] = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
  }
}

}  // namespace

// Plain C interface for ctypes. key_in and key_out are device int64 [2] (the
// key's two uint32 words), halt a device bool read before the split (null:
// never halted; true: key_out = key_in), draw a device float32 buffer of
// max(n_shards, 1) * per_shard elements (null when per_shard is 0); shards
// lists n_shards global shard indices on the host (n_shards 0: no fold).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int threefry_draw(const void* key_in, void* key_out, const void* halt, void* draw,
                             long long per_shard, const int* shards, int n_shards,
                             void* stream) {
  if (per_shard < 0 || n_shards < 0 || n_shards > kMaxShards ||
      (per_shard > 0 && draw == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ShardTable table{};
  for (int s = 0; s < n_shards; ++s) {
    if (shards[s] < 0) return static_cast<int>(cudaErrorInvalidValue);
    table.index[s] = static_cast<uint32_t>(shards[s]);
  }
  const unsigned y = n_shards > 0 ? static_cast<unsigned>(n_shards) : 1u;
  // enough blocks to cover a shard once, capped so the grid-stride loop takes
  // over past ~1M elements (about 30 blocks of 256 on each of the 132 SMs in
  // all); at least one block, which splits the key
  const long long needed = (per_shard + kThreads - 1) / kThreads;
  const long long cap = 4096 / y;
  const unsigned x = static_cast<unsigned>(needed < 1 ? 1 : (needed < cap ? needed : cap));
  threefry_draw_kernel<<<dim3(x, y), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(key_in), static_cast<int64_t*>(key_out),
      static_cast<const bool*>(halt), static_cast<float*>(draw), static_cast<int64_t>(per_shard), n_shards > 0, table);
  return static_cast<int>(cudaGetLastError());
}
