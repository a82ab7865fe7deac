// Bulk bitwise MAJX over packed bit-planes, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/majx/kernel.py, majx_pallas (body
// majx_kernel, with _csa_accumulate and _ge_threshold).
//
// Computes: for each of `batch` independent votes, the (P,) majority of
// n operand planes of P words: out[b, p] = MAJ_n(in[b, 0, p] ..
// in[b, n-1, p]) bitwise, n odd.  Words are int32 in PyTorch and
// uint32_t here; the bits are the same.
//
// Bound on this card: device-memory bytes.  Each output word reads n
// words and writes one, (n + 1) * 4 bytes, against ~3 * n *
// digits_for(n) integer operations — far below the compute rate at any
// arity the backends use.
//
// Design: one thread per output word (grid-stride), looping over the n
// planes with the carry-save digits in registers (bitslice.cuh).
// Neighbouring threads take neighbouring words, so every plane read and
// the output write are fully coalesced; each input word is read exactly
// once.  The batch dimension of majx_batch is part of the flat index, so
// a whole batch is one launch.  No shared memory is needed: nothing is
// reused across threads.
#include <cuda_runtime.h>

#include <cstdint>

#include "bitslice.cuh"

namespace {

__global__ void majx_kernel(const uint32_t* __restrict__ planes,
                            uint32_t* __restrict__ out, long long batch,
                            int n, long long words, int n_digits,
                            unsigned thresh) {
  const long long total = batch * words;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long b = i / words;
    const long long p = i - b * words;
    const uint32_t* src = planes + b * n * words + p;
    bitslice::Counter c;
    c.clear();
    for (int k = 0; k < n; ++k) c.add(__ldg(src + (long long)k * words),
                                      n_digits);
    out[i] = c.ge(thresh, n_digits);
  }
}

}  // namespace

// planes: (batch, n, words) int32, contiguous; out: (batch, words).
extern "C" int majx_launch(const void* planes, void* out, long long batch,
                           int n, long long words, int blocks, int threads,
                           void* stream) {
  if (batch * words > 0) {
    majx_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)planes, (uint32_t*)out, batch, n, words,
        bitslice::digits_for(n), (unsigned)((n + 1) / 2));
  }
  return (int)cudaGetLastError();
}
