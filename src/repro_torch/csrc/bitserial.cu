// Bit-serial ripple-carry adder over packed bit-planes, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/bitserial/kernel.py, bitserial_add_pallas
// (body bitserial_add_kernel).
//
// Computes: for two stacks of nbits planes of P words each, LSB plane
// first, the sum planes out[i, p] = a[i, p] ^ b[i, p] ^ c with the
// carry c' = MAJ3(a[i, p], b[i, p], c) — the paper's majority carry —
// starting from c = 0; the carry out of the top plane is dropped
// (fixed-width wraparound).  Words are int32 in PyTorch and uint32_t
// here; the bits are the same.
//
// Bound on this card: device-memory bytes, 3 * nbits * P * 4 (each
// operand word read once, each sum word written once), against five
// logic operations a word.
//
// Design: one thread owns one word column (four neighbouring columns
// with 16-byte loads) and walks the planes with the carry in a register.
// The carry chain is ALU only and no load depends on it, so a thread
// fetches a group of kGroup planes of both operands before it consumes
// any: 2 * kGroup independent loads in flight a thread, where a loop
// that consumed each plane as it arrived would wait on one at a time.
// Neighbouring threads take neighbouring columns, so every plane's load
// and store is coalesced.  The 16-byte path needs P to be a multiple of
// four and all three pointers 16-byte aligned; otherwise the same loop
// runs on single words.  Columns are covered by a grid-stride loop whose
// bound masks the ragged edge, and a predicate masks the planes past
// nbits in the last group, so nothing is padded and any nbits >= 1 is
// taken.  The TPU kernel's (8, 256) VMEM tiles have no counterpart: a
// column needs nothing from its neighbours.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Planes fetched ahead of the carry chain (per operand).
constexpr int kGroup = 8;

__device__ __forceinline__ uint32_t sum3(uint32_t a, uint32_t b,
                                         uint32_t c) {
  return a ^ b ^ c;
}

__device__ __forceinline__ uint32_t maj3(uint32_t a, uint32_t b,
                                         uint32_t c) {
  return (a & b) | (c & (a | b));
}

__device__ __forceinline__ uint4 sum3(uint4 a, uint4 b, uint4 c) {
  return make_uint4(sum3(a.x, b.x, c.x), sum3(a.y, b.y, c.y),
                    sum3(a.z, b.z, c.z), sum3(a.w, b.w, c.w));
}

__device__ __forceinline__ uint4 maj3(uint4 a, uint4 b, uint4 c) {
  return make_uint4(maj3(a.x, b.x, c.x), maj3(a.y, b.y, c.y),
                    maj3(a.z, b.z, c.z), maj3(a.w, b.w, c.w));
}

template <typename W>
__device__ __forceinline__ W zero_word();

template <>
__device__ __forceinline__ uint32_t zero_word<uint32_t>() {
  return 0u;
}

template <>
__device__ __forceinline__ uint4 zero_word<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// W is uint32_t (one column a thread) or uint4 (four); cols counts W.
template <typename W>
__global__ void bitserial_add_kernel(const W* __restrict__ a,
                                     const W* __restrict__ b,
                                     W* __restrict__ out, int nbits,
                                     long long cols) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < cols; p += stride) {
    W carry = zero_word<W>();
    for (int i0 = 0; i0 < nbits; i0 += kGroup) {
      W av[kGroup], bv[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (i0 + j < nbits) {
          const long long at = (long long)(i0 + j) * cols + p;
          av[j] = __ldg(a + at);
          bv[j] = __ldg(b + at);
        }
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (i0 + j < nbits) {
          out[(long long)(i0 + j) * cols + p] = sum3(av[j], bv[j], carry);
          carry = maj3(av[j], bv[j], carry);
        }
      }
    }
  }
}

}  // namespace

// a, b, out: (nbits, words) int32, contiguous.  vec != 0 takes the
// 16-byte path (words a multiple of 4, pointers 16-byte aligned; refused
// with cudaErrorInvalidValue otherwise), and blocks then covers words / 4
// threads.  threads is a multiple of 32, at most 1024.
extern "C" int bitserial_add_launch(const void* a, const void* b, void* out,
                                    int nbits, long long words, int vec,
                                    int blocks, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    const uintptr_t ptrs =
        (uintptr_t)a | (uintptr_t)b | (uintptr_t)out;
    if ((words & 3) != 0 || (ptrs & 15) != 0)
      return (int)cudaErrorInvalidValue;
    bitserial_add_kernel<uint4><<<blocks, threads, 0, s>>>(
        (const uint4*)a, (const uint4*)b, (uint4*)out, nbits, words >> 2);
  } else {
    bitserial_add_kernel<uint32_t><<<blocks, threads, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, nbits,
        words);
  }
  return (int)cudaGetLastError();
}
