// Fused failure-detector phase of one protocol round, for Hopper (sm_90a).
//
// Replaces rapid_tpu/sim/pallas_kernels.py::_fd_phase_kernel (wrapper
// fd_phase), the Pallas TPU kernel that walks [C, K] row tiles in VMEM with
// the threshold in SMEM. Per monitoring edge:
//
//   fail      = edge_live & observer_up & ~probe_ok
//   fd_fail  += fail                  (i32: no saturation; u8: stops at 255)
//   new_down  = edge_live & observer_up & (fd_fail >= threshold) & ~alerted
//   alerted  |= new_down
//
// Two instantiations of one template: fd_phase_i32 is the Pallas contract
// (int32 counter), fd_phase_u8 is what the engine state holds (uint8 counter
// saturating at 255, rapid_tpu/sim/engine.py:178-181, 607-618) and what the
// port's scan path launches every round.
//
// What bounds it: bytes. Each edge reads four bool bytes plus its counter and
// writes its counter plus two bool bytes: 8 B/edge for u8, 14 B/edge for i32.
// At C=100k, K=10 that is 8 MB and 14 MB, about 2.4 us and 4.2 us at the
// H100's 3.35 TB/s, so at that size launch latency dominates. The operations
// (a handful of integer ops per edge) are far below the bytes' time.
//
// Design: the TPU grid walked row tiles in order; here the C*K edges are one
// flat index space (the arrays are contiguous), walked by a grid-stride loop
// with one edge per thread per step, so K=10 wastes no lanes. The threshold is
// a kernel argument. The kernel allocates nothing: the wrapper allocates the
// outputs and passes the stream. Later work: 16-byte vectorised loads, and
// fusing the dst-indexed gather new_down[observers, cols]
// (rapid_tpu/sim/engine.py:650-653), which Mosaic could not lower
// (pallas_kernels.py:28-33) but a CUDA kernel can.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename Counter, bool kSaturate>
__global__ void fd_phase_kernel(const uint8_t* __restrict__ edge_live,
                                const uint8_t* __restrict__ observer_up,
                                const uint8_t* __restrict__ probe_ok,
                                const Counter* __restrict__ fd_fail_in,
                                const uint8_t* __restrict__ alerted_in,
                                Counter* __restrict__ fd_fail_out,
                                uint8_t* __restrict__ alerted_out,
                                uint8_t* __restrict__ new_down_out,
                                int64_t n, int threshold) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const bool watching = edge_live[i] && observer_up[i];
    const bool fail = watching && !probe_ok[i];
    Counter count = fd_fail_in[i];
    if (kSaturate) {
      if (fail && count < static_cast<Counter>(255)) count += 1;
    } else if (fail) {
      // int32 wraps like the Pallas kernel's add; done unsigned to stay
      // defined behaviour in C++
      count = static_cast<Counter>(static_cast<uint32_t>(count) + 1u);
    }
    const bool alerted = alerted_in[i];
    const bool down =
        watching && static_cast<int>(count) >= threshold && !alerted;
    fd_fail_out[i] = count;
    alerted_out[i] = alerted || down;
    new_down_out[i] = down;
  }
}

template <typename Counter, bool kSaturate>
int launch(const void* edge_live, const void* observer_up, const void* probe_ok,
           const void* fd_fail_in, const void* alerted_in, void* fd_fail_out,
           void* alerted_out, void* new_down_out, long long n, int threshold,
           void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  // enough blocks to cover the edges once, capped so the grid-stride loop
  // takes over past ~1M edges (8 resident blocks of 256 on each of 132 SMs
  // would be 1056; 4096 keeps every SM busy with room for tail imbalance)
  const long long blocks_needed = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(blocks_needed < 4096 ? blocks_needed : 4096);
  fd_phase_kernel<Counter, kSaturate>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(edge_live),
          static_cast<const uint8_t*>(observer_up),
          static_cast<const uint8_t*>(probe_ok),
          static_cast<const Counter*>(fd_fail_in),
          static_cast<const uint8_t*>(alerted_in),
          static_cast<Counter*>(fd_fail_out),
          static_cast<uint8_t*>(alerted_out),
          static_cast<uint8_t*>(new_down_out), static_cast<int64_t>(n),
          threshold);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes: device pointers, the edge count, the
// threshold and the cudaStream_t. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int fd_phase_i32(const void* edge_live, const void* observer_up,
                            const void* probe_ok, const void* fd_fail_in,
                            const void* alerted_in, void* fd_fail_out,
                            void* alerted_out, void* new_down_out, long long n,
                            int threshold, void* stream) {
  return launch<int32_t, false>(edge_live, observer_up, probe_ok, fd_fail_in,
                                alerted_in, fd_fail_out, alerted_out,
                                new_down_out, n, threshold, stream);
}

extern "C" int fd_phase_u8(const void* edge_live, const void* observer_up,
                           const void* probe_ok, const void* fd_fail_in,
                           const void* alerted_in, void* fd_fail_out,
                           void* alerted_out, void* new_down_out, long long n,
                           int threshold, void* stream) {
  return launch<uint8_t, true>(edge_live, observer_up, probe_ok, fd_fail_in,
                               alerted_in, fd_fail_out, alerted_out,
                               new_down_out, n, threshold, stream);
}
