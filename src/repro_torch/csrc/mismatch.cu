// Mismatch count (the success-rate counter), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mismatch/kernel.py, mismatch_pallas (body
// mismatch_kernel).
//
// Computes: the number of bits that differ between two packed-word
// arrays of n words, sum over p < n of popcount(a[p] ^ b[p]), into one
// unsigned 64-bit accumulator.  The wrapper reads its low 32 bits as the
// two's-complement int32 the reference's int32 accumulator gives; the
// count itself is exact up to 2^64.
//
// Bound on this card: device-memory bytes, 2 * n * 4 read, against one
// XOR, one popcount and one add a word.
//
// Design: the TPU kernel carries the sum through a sequential grid; here
// blocks run in parallel, so each thread sums its own words (a
// grid-stride loop of 16-byte loads where both operands are 16-byte
// aligned, and single words for the ragged tail), a warp reduces with
// __shfl_down_sync, the warps' sums meet in shared memory, and one
// atomicAdd a block lands on the accumulator.  The entry point zeroes
// the accumulator on the same stream before the launch, so one call is
// one kernel launch.  Integer addition is associative, so the result
// does not depend on the order the blocks finish in.  Nothing is padded:
// the loop bounds mask the ragged edge.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ unsigned popc4(uint4 x, uint4 y) {
  return __popc(x.x ^ y.x) + __popc(x.y ^ y.y) + __popc(x.z ^ y.z) +
         __popc(x.w ^ y.w);
}

template <bool kVec>
__global__ void mismatch_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                long long n,
                                unsigned long long* __restrict__ acc) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  unsigned long long count = 0;
  long long head = 0;  // words covered by the 16-byte loop
  if (kVec) {
    const long long n4 = n >> 2;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    for (long long i = tid; i < n4; i += stride)
      count += popc4(__ldg(a4 + i), __ldg(b4 + i));
    head = n4 << 2;
  }
  for (long long i = head + tid; i < n; i += stride)
    count += __popc(__ldg(a + i) ^ __ldg(b + i));

  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  __shared__ unsigned long long warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (warp == 0) {
    count = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0ull;
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_down_sync(0xffffffffu, count, off);
    if (lane == 0) atomicAdd(acc, count);
  }
}

}  // namespace

// a, b: (n,) int32, contiguous; acc: one unsigned 64-bit word on the
// card, zeroed here.  threads is a multiple of 32, at most 1024.
extern "C" int mismatch_launch(const void* a, const void* b, void* acc,
                               long long n, int blocks, int threads,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  const bool vec = ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
  if (vec) {
    mismatch_kernel<true><<<blocks, threads, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, n,
        (unsigned long long*)acc);
  } else {
    mismatch_kernel<false><<<blocks, threads, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, n,
        (unsigned long long*)acc);
  }
  return (int)cudaGetLastError();
}
