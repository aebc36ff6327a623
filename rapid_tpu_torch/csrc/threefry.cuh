// JAX's threefry bits for Hopper (sm_90a), one source for every kernel that
// makes them: threefry.cu's draw and the FD kernels of fd_phase_fused.cu.
// With JAX's jax_threefry_partitionable (its default) and 32-bit integers:
//
//   threefry(k, (x0, x1)) = Random123's threefry2x32_20 of the counter pair
//   (new key, probe key)  = (threefry(key, (0, 0)), threefry(key, (0, 1)))
//   probe key on a mesh   = threefry(probe key, (0, shard))
//   draw[i]               = bitcast<float>((b >> 9) | 0x3F800000) - 1,
//                           b = y0 ^ y1, (y0, y1) = threefry(probe key,
//                           (i >> 32, i & 0xFFFFFFFF)), i the flat index
//
// rapid_tpu_torch/sim/threefry.py is the plain version of the same words.
// The rotations are compile-time funnel shifts.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace jax_threefry {

constexpr uint32_t kParity = 0x1BD11BDAu;

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

// The key (k0, k1) with the counter (0, c) applied: the split's new key (c
// 0), its probe key (c 1), or a shard's fold (c the shard).
__device__ __forceinline__ uint2 derive(uint32_t k0, uint32_t k1, uint32_t c) {
  uint32_t x0 = 0u, x1 = c;
  threefry(k0, k1, x0, x1);
  return make_uint2(x0, x1);
}

// The round's new key, out of place: the key as it came when the halt flag
// (null: never halted) is set, as the masked round of the JAX engine keeps
// it. key_in and key_out hold the two uint32 words in int64.
__device__ __forceinline__ void write_new_key(const int64_t* key_in, int64_t* key_out,
                                              const uint8_t* halt) {
  const uint32_t k0 = static_cast<uint32_t>(key_in[0]);
  const uint32_t k1 = static_cast<uint32_t>(key_in[1]);
  uint2 next = make_uint2(k0, k1);
  if (halt == nullptr || *halt == 0) next = derive(k0, k1, 0u);
  key_out[0] = next.x;
  key_out[1] = next.y;
}

// The round's probe key from the state's key, folded with `shard` when
// `fold` is set.
__device__ __forceinline__ uint2 probe_key(const int64_t* key_in, bool fold, uint32_t shard) {
  const uint2 probe =
      derive(static_cast<uint32_t>(key_in[0]), static_cast<uint32_t>(key_in[1]), 1u);
  return fold ? derive(probe.x, probe.y, shard) : probe;
}

// The uniform float32 in [0, 1) at flat index i under the key.
__device__ __forceinline__ float uniform(uint2 key, int64_t i) {
  uint32_t x0 = static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32);
  uint32_t x1 = static_cast<uint32_t>(i);
  threefry(key.x, key.y, x0, x1);
  return __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace jax_threefry
