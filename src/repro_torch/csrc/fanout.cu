// One-to-many row fan-out (Multi-RowCopy, paper §6), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rowcopy/kernel.py, fanout_pallas (body
// fanout_kernel).
//
// Computes: out[f, p] = src[p] for f < fanout, p < words: one source
// image broadcast to `fanout` destinations.
//
// Bound on this card: device-memory bytes, (1 + fanout) * words * 4 —
// there is no arithmetic at all, and fanout / (1 + fanout) of the bytes
// are stores, so the kernel is a store stream.
//
// Design: a thread owns four neighbouring words (one 16-byte load, then
// 16-byte stores) where `words` is a multiple of 4 and both pointers are
// 16-byte aligned, else one word, with the same template: a 4-byte store
// moves a quarter of what a 16-byte one moves a warp instruction.  A
// thread keeps its source column in a register and stores it to a group
// of kDests destinations, with plain stores: evict-first ones (__stcs)
// slowed the gather that reads the copies next.  The grid is (window,
// groups, windows) and blocks start x-fastest: consecutive blocks take
// the column chunks of one window (ops.WINDOW_COLS columns, 1 MiB of
// 16-byte ones) for one group, then the same chunks for the next group,
// then the next window.  So a
// window's source comes from device memory once and the later groups
// re-read it from L2 (what the TPU kernel's pinned source block does),
// and the card writes a few destination rows at a time in long runs.
// Of the orders measured at the serve shape, the groups of one chunk
// together (every row written at once) and whole rows before the next
// group (every group re-reading the source from device memory) were
// slower, as were 8 to 32 destinations a block for 16-byte columns
// (PERF.md §6).  Offsets are 64-bit; a grid-stride loop covers windows
// past grid z's limit.  Grid y, one group a block, holds at most 65535
// groups (ops.MAX_FANOUT; a loop over groups slowed the 4-byte path by
// 3 %).  Neighbouring threads take neighbouring columns, so the load and
// every store are coalesced.
//
// TMA bulk copies lost (a tile loaded once into shared memory, then one
// bulk store a destination by one thread): slower at the path and serve
// shapes, and a small source fills few blocks.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Destinations a block stores: one grid-y step.
template <typename W>
constexpr int kDests = 8;
template <>
constexpr int kDests<uint4> = 4;

// W is uint32_t (one word a thread) or uint4 (four); cols counts W.
// Grid x times grid z is below 2**27 (ops.geometry), so a block's chunk
// index is 32-bit; n >= 1 (grid y covers the fan-out), so the store loop
// runs at least once and nothing holds the load back.
template <typename W>
__global__ void fanout_kernel(const W* __restrict__ src,
                              W* __restrict__ out, int fanout,
                              long long cols) {
  const long long step = (long long)gridDim.z * gridDim.x * blockDim.x;
  for (long long p = (long long)(blockIdx.z * gridDim.x + blockIdx.x) *
                         blockDim.x + threadIdx.x;
       p < cols; p += step) {
    const W v = __ldg(src + p);
    const int f0 = blockIdx.y * kDests<W>;
    const int n = min(kDests<W>, fanout - f0);
    W* o = out + (long long)f0 * cols + p;
    int j = 0;
    do {
      o[j * cols] = v;
    } while (++j < n);
  }
}

template <typename W>
int launch(const void* src, void* out, int fanout, long long cols,
           int window, int windows, int threads, cudaStream_t s) {
  const dim3 grid(window, (fanout + kDests<W> - 1) / kDests<W>, windows);
  fanout_kernel<W><<<grid, threads, 0, s>>>((const W*)src, (W*)out,
                                            fanout, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// src: (words,) int32, contiguous; out: (fanout, words).  vec != 0
// takes the 16-byte path (words a multiple of 4, both pointers 16-byte
// aligned; refused with cudaErrorInvalidValue otherwise).  Grid x is
// `window` column chunks of `threads` columns, grid z `windows` windows
// (a grid-stride loop covers the rest), grid y the destination groups
// (at most 65535: fanout <= ops.MAX_FANOUT); ops.geometry computes x and
// z.
extern "C" int fanout_launch(const void* src, void* out, int fanout,
                             long long words, int vec, int window,
                             int windows, int threads, void* stream) {
  if (vec && ((words & 3) != 0 ||
              (((uintptr_t)src | (uintptr_t)out) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  if (words <= 0 || fanout <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch<uint4>(src, out, fanout, words >> 2, window, windows,
                             threads, s)
             : launch<uint32_t>(src, out, fanout, words, window, windows,
                                threads, s);
}
