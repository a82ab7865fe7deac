// A whole lowered Schedule in ONE launch, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/megakernel/kernel.py, schedule_pallas
// (body schedule_kernel); host wrapper src/repro/kernels/megakernel/
// ops.py, run_lowering.
//
// Computes: for each level l of the (L, W, X) src and (L, W) dst / inv
// tables, against the augmented (rows, words) image (rows 0/1/2 are the
// constant zero, one and trash rows):
//   1. gather the X operand rows of each of the W slots from the
//      level-entry image,
//   2. take the bitwise majority over X (bitslice.cuh),
//   3. complement the vote where inv is 1,
//   4. scatter the W votes to their dst rows.
//
// Bound on this card: device-memory bytes.  The least traffic is the
// image read once and written once, 2 * rows * words * 4 bytes.  This
// design reads L * W * X operand words and writes 2 * L * W words per
// column (votes through the scratch, then the scatter), so it moves
// more than that bound; PERF.md records the gap.
//
// Design: word columns are independent (every op is bitwise per word),
// so one thread owns one column for the whole schedule and no thread
// ever waits for another — no barriers, no atomics, one launch.  The
// image stays in device memory in the output buffer, updated in place.
// Level-entry semantics: the scheduler allows WAR inside a level (a slot
// may overwrite a row that another slot of the same level reads), so
// each thread first computes all W votes of the level into the
// (W, words) scratch, and only then scatters them.  Inert padding slots
// read the zero row and all write the trash row, which nobody reads.
// Table entries are the same for every thread, so each table read is a
// broadcast through the read-only cache.  Neighbouring threads take
// neighbouring columns, so every row access is coalesced.
#include <cuda_runtime.h>

#include <cstdint>

#include "bitslice.cuh"

namespace {

__global__ void megakernel(uint32_t* __restrict__ image,
                           uint32_t* __restrict__ scratch,
                           const int* __restrict__ src,
                           const int* __restrict__ dst,
                           const int* __restrict__ inv, int levels,
                           int width, int arity, long long words,
                           int n_digits, unsigned thresh) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < words; c += stride) {
    for (int l = 0; l < levels; ++l) {
      const int* lsrc = src + (long long)l * width * arity;
      for (int w = 0; w < width; ++w) {
        bitslice::Counter cnt;
        cnt.clear();
        for (int x = 0; x < arity; ++x) {
          const long long row = __ldg(lsrc + w * arity + x);
          cnt.add(image[row * words + c], n_digits);
        }
        uint32_t v = cnt.ge(thresh, n_digits);
        if (__ldg(inv + (long long)l * width + w)) v = ~v;
        scratch[(long long)w * words + c] = v;
      }
      for (int w = 0; w < width; ++w) {
        const long long row = __ldg(dst + (long long)l * width + w);
        image[row * words + c] = scratch[(long long)w * words + c];
      }
    }
  }
}

}  // namespace

// image: (rows, words) int32, updated in place; scratch: (width, words);
// src: (levels, width, arity) int32; dst, inv: (levels, width) int32.
extern "C" int megakernel_launch(void* image, void* scratch,
                                 const void* src, const void* dst,
                                 const void* inv, int levels, int width,
                                 int arity, long long words, int blocks,
                                 int threads, void* stream) {
  if (levels > 0 && width > 0 && words > 0) {
    megakernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)image, (uint32_t*)scratch, (const int*)src,
        (const int*)dst, (const int*)inv, levels, width, arity, words,
        bitslice::digits_for(arity), (unsigned)((arity + 1) / 2));
  }
  return (int)cudaGetLastError();
}
