// One-to-many row fan-out (Multi-RowCopy, paper §6), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rowcopy/kernel.py, fanout_pallas (body
// fanout_kernel).
//
// Computes: out[f, p] = src[p] for f < fanout, p < words: one source
// image broadcast to `fanout` destinations.
//
// Bound on this card: device-memory bytes, (1 + fanout) * words * 4 —
// there is no arithmetic at all.
//
// Design: one thread per source word (grid-stride).  Each thread loads
// its word once and stores it `fanout` times, so device memory sees the
// source exactly once, as the TPU kernel's pinned source block did.
// Neighbouring threads take neighbouring words, so the load and each of
// the `fanout` stores are coalesced.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void fanout_kernel(const uint32_t* __restrict__ src,
                              uint32_t* __restrict__ out, int fanout,
                              long long words) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < words; p += stride) {
    const uint32_t v = __ldg(src + p);
    for (int f = 0; f < fanout; ++f) out[(long long)f * words + p] = v;
  }
}

}  // namespace

// src: (words,) int32, contiguous; out: (fanout, words).
extern "C" int fanout_launch(const void* src, void* out, int fanout,
                             long long words, int blocks, int threads,
                             void* stream) {
  if (words > 0 && fanout > 0) {
    fanout_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)src, (uint32_t*)out, fanout, words);
  }
  return (int)cudaGetLastError();
}
