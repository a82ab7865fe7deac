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
// words and writes one, (n + 1) * 4 bytes, against ~2 * n *
// digits_for(n) + 3 * digits_for(n) logic operations — far below the
// compute rate at any arity the backends use.
//
// Design: a thread owns four neighbouring words (16-byte loads) where
// P is a multiple of 4 and the pointers are 16-byte aligned, else one
// word, with the same template.  A load that the counter consumes at
// once leaves one load in flight a thread, and the card then waits on
// latency, not bandwidth; so for each group of kGroup planes the thread
// issues every load before the first reaches the carry-save counter
// (bitslice.cuh), as bitserial.cu does with its carry chain.  The last
// group is predicated, so any n works and nothing is padded.  The
// counter's digit count is a template argument picked at launch
// (bitslice::with_digits), so its loops unroll to exactly the digits n
// needs.  Neighbouring threads take neighbouring words, so every plane
// read and the output write are coalesced, and each input word is read
// once.  The batch is part of the flat index, so a whole majx_batch is
// one launch.  No shared memory: nothing is reused across threads.
#include <cuda_runtime.h>

#include <cstdint>

#include "bitslice.cuh"

namespace {

// Planes fetched ahead of the counter.
constexpr int kGroup = 8;

// W is uint32_t (one word a thread) or uint4 (four); cols counts W.
template <int D, typename W>
__global__ void majx_kernel(const W* __restrict__ planes,
                            W* __restrict__ out, long long batch, int n,
                            long long cols, unsigned thresh) {
  const long long total = batch * cols;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long b = i / cols;
    const long long p = i - b * cols;
    const W* src = planes + b * n * cols + p;
    bitslice::Counter<D, W> c;
    c.clear();
    for (int k0 = 0; k0 < n; k0 += kGroup) {
      W v[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (k0 + j < n) v[j] = __ldg(src + (long long)(k0 + j) * cols);
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (k0 + j < n) c.add(v[j]);
      }
    }
    out[i] = c.ge(thresh);
  }
}

struct Launch {
  const void* planes;
  void* out;
  long long batch;
  int n;
  long long words;
  bool vec;
  int blocks, threads;
  cudaStream_t stream;

  template <int D>
  int operator()() const {
    const unsigned thresh = (unsigned)(n / 2 + 1);
    if (vec) {
      majx_kernel<D, uint4><<<blocks, threads, 0, stream>>>(
          (const uint4*)planes, (uint4*)out, batch, n, words >> 2, thresh);
    } else {
      majx_kernel<D, uint32_t><<<blocks, threads, 0, stream>>>(
          (const uint32_t*)planes, (uint32_t*)out, batch, n, words, thresh);
    }
    return (int)cudaGetLastError();
  }
};

}  // namespace

// planes: (batch, n, words) int32, contiguous; out: (batch, words).
// vec != 0 takes the 16-byte path (words a multiple of 4, both pointers
// 16-byte aligned; refused with cudaErrorInvalidValue otherwise), and
// blocks then covers batch * words / 4 threads.
extern "C" int majx_launch(const void* planes, void* out, long long batch,
                           int n, long long words, int vec, int blocks,
                           int threads, void* stream) {
  if (vec && ((words & 3) != 0 ||
              (((uintptr_t)planes | (uintptr_t)out) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  if (batch * words <= 0) return (int)cudaGetLastError();
  const Launch launch{planes, out, batch, n, words, vec != 0,
                      blocks, threads, (cudaStream_t)stream};
  return bitslice::with_digits(bitslice::digits_for(n), launch);
}
