// Native host-side control plane for rapid-tpu.
//
// The reference's runtime is JVM-native (Netty event loops, zero-allocation
// xxHash); rapid-tpu's host control plane equivalent lives here: batched
// XXH64 endpoint hashing and K-ring adjacency construction for up to 100k+
// virtual nodes, called between device steps whenever the membership
// changes. Exposed as a plain C ABI for ctypes (rapid_tpu_torch/native.py), with a
// numpy fallback when the library is not built.
//
// The XXH64 implementation follows the public xxHash specification and is
// bit-identical to rapid_tpu_torch.hashing.xxh64 (held against it in
// tests/test_torch_native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t round_(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}

inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  return (acc ^ round_(0, val)) * P1 + P4;
}

inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // little-endian hosts only (x86/ARM)
  return v;
}

inline uint64_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

uint64_t xxh64(const uint8_t* data, size_t n, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  uint64_t acc;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2;
    uint64_t v2 = seed + P2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round_(v1, read64(p));
      v2 = round_(v2, read64(p + 8));
      v3 = round_(v3, read64(p + 16));
      v4 = round_(v4, read64(p + 24));
      p += 32;
    } while (p <= limit);
    acc = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    acc = merge_round(acc, v1);
    acc = merge_round(acc, v2);
    acc = merge_round(acc, v3);
    acc = merge_round(acc, v4);
  } else {
    acc = seed + P5;
  }
  acc += static_cast<uint64_t>(n);
  while (p + 8 <= end) {
    acc = rotl(acc ^ round_(0, read64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    acc = rotl(acc ^ (read32(p) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    acc = rotl(acc ^ (*p * P5), 11) * P1;
    ++p;
  }
  acc ^= acc >> 33;
  acc *= P2;
  acc ^= acc >> 29;
  acc *= P3;
  acc ^= acc >> 32;
  return acc;
}

}  // namespace

extern "C" {

// Hash N byte rows (zero-padded to max_len; true lengths given) with `seed`.
void rapid_xxh64_batch(const uint8_t* data, int64_t n_rows, int64_t max_len,
                       const int64_t* lengths, uint64_t seed, uint64_t* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    out[i] = xxh64(data + i * max_len, static_cast<size_t>(lengths[i]), seed);
  }
}

// Endpoint ring keys for one seed: xx(hostname)*31 + xx(4 LE port bytes)
// (Utils.AddressComparator.computeHash, Utils.java:227-230).
void rapid_endpoint_hash_batch(const uint8_t* hostnames, int64_t n_rows,
                               int64_t max_len, const int64_t* lengths,
                               const int64_t* ports, uint64_t seed,
                               uint64_t* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    uint64_t host_h =
        xxh64(hostnames + i * max_len, static_cast<size_t>(lengths[i]), seed);
    uint32_t port = static_cast<uint32_t>(ports[i]);
    uint8_t port_bytes[4];
    std::memcpy(port_bytes, &port, 4);
    out[i] = host_h * 31 + xxh64(port_bytes, 4, seed);
  }
}

// All K ring hashes at once: out[k * n_rows + i].
void rapid_ring_hashes(const uint8_t* hostnames, int64_t n_rows,
                       int64_t max_len, const int64_t* lengths,
                       const int64_t* ports, int64_t k, uint64_t* out) {
  for (int64_t ring = 0; ring < k; ++ring) {
    rapid_endpoint_hash_batch(hostnames, n_rows, max_len, lengths, ports,
                              static_cast<uint64_t>(ring), out + ring * n_rows);
  }
}

// Build subjects/observers adjacency over the active membership.
// ring_hashes: [K, C] (as produced by rapid_ring_hashes); active: [C] uint8;
// subjects/observers: [C, K] int32, pre-filled by the caller with self-ids.
// Ordering is by SIGNED hash (Long.compare domain, Utils.java:216-221).
void rapid_build_adjacency(const uint64_t* ring_hashes, const uint8_t* active,
                           int64_t capacity, int64_t k, int32_t* subjects,
                           int32_t* observers) {
  std::vector<int32_t> active_idx;
  active_idx.reserve(capacity);
  for (int64_t i = 0; i < capacity; ++i) {
    if (active[i]) active_idx.push_back(static_cast<int32_t>(i));
  }
  const int64_t n = static_cast<int64_t>(active_idx.size());
  if (n <= 1) return;
  std::vector<int32_t> order(active_idx);
  for (int64_t ring = 0; ring < k; ++ring) {
    const uint64_t* h = ring_hashes + ring * capacity;
    std::sort(order.begin(), order.end(), [h](int32_t a, int32_t b) {
      return static_cast<int64_t>(h[a]) < static_cast<int64_t>(h[b]);
    });
    for (int64_t t = 0; t < n; ++t) {
      int32_t node = order[t];
      subjects[node * k + ring] = order[(t - 1 + n) % n];
      observers[node * k + ring] = order[(t + 1) % n];
    }
  }
}

// Chained configuration-id fold: h=1; h = h*37 + x_i (mod 2^64).
uint64_t rapid_config_fold(const uint64_t* xs, int64_t n) {
  uint64_t h = 1;
  for (int64_t i = 0; i < n; ++i) h = h * 37 + xs[i];
  return h;
}

}  // extern "C"
