// One round's random ingress-loss draw: JAX's threefry key split and uniform
// block, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX engine draws a round's loss with
// jax.random inside its round program, which XLA compiles to a threefry pass:
// rapid_tpu/sim/engine.py::_fd_phase (split, then uniform over [C, K]) and
// rapid_tpu/shard/engine.py::_sharded_round (split, fold_in of the shard's
// linear index, uniform over the shard's [C / n, K] rows). This kernel gives
// the same bits (threefry.cuh defines them, for this kernel and for the FD
// kernels of fd_phase_fused.cu, which draw each lossy edge's word where they
// read it). No round path launches it: it is the draw as a block, which the
// tests and chip_smoke.py hold to JAX's golden vectors.
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
// rows. A call with no rows still launches one block, to split the key.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShards = 16;  // kernels.MAX_SHARDS_PER_CALL

struct ShardTable {
  uint32_t index[kMaxShards];  // global shard index folded into each y block
};

__global__ void __launch_bounds__(kThreads)
    threefry_draw_kernel(const int64_t* __restrict__ key_in, int64_t* __restrict__ key_out,
                         const uint8_t* __restrict__ halt, float* __restrict__ draw,
                         int64_t per_shard, bool fold, ShardTable shards) {
  __shared__ uint2 probe;
  if (threadIdx.x == 0) {
    if (blockIdx.x == 0 && blockIdx.y == 0)
      jax_threefry::write_new_key(key_in, key_out, halt);
    probe = jax_threefry::probe_key(key_in, fold, shards.index[blockIdx.y]);
  }
  __syncthreads();
  const uint2 key = probe;
  float* out = draw + static_cast<int64_t>(blockIdx.y) * per_shard;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < per_shard;
       i += stride)
    out[i] = jax_threefry::uniform(key, i);
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
      static_cast<const uint8_t*>(halt), static_cast<float*>(draw),
      static_cast<int64_t>(per_shard), n_shards > 0, table);
  return static_cast<int>(cudaGetLastError());
}
