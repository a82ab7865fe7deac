// Bit-plane transpose of uint32 elements, both ways, for Hopper (sm_90a).
//
// Replaces: no TPU kernel.  The reference computes
// src/repro/core/bitplanes.py pack_uint_elements / unpack_uint_elements
// in plain jnp and leaves the transpose to XLA's fusion.  The port's
// plain PyTorch version (kernels/bitplanes/ref.py) has no fusion: it
// makes one pass over the whole input a plane, with three or four
// full-size temporaries each, ~130 launches a call.  In the benchmark's
// arith8.megakernel cell those passes took ~87 % of the card's busy time
// and ran at ~0.52 % of their bytes bound (PERF.md §5-§6); every §8.1
// request packs two operands and unpacks its result through them.
//
// Computes, for a batch of rows of k elements (int32 in PyTorch, uint32
// here; the bits are the same) and W = ceil(k / 32) words a plane:
//   pack:   planes[b, i, j] bit t = bit i of x[b, 32 j + t]  (i < n_bits;
//           0 for lanes past k and for planes past the 32nd);
//   unpack: out[b, e] bit i = bit (e % 32) of planes[b, i, e / 32]
//           (i < min(n_planes, 32); missing planes read as 0).
//
// Bound on this card: device-memory bytes, 8 B a lane a call (each
// element or plane word read once, each written once): 0.16 ms at 2**26
// lanes.  The transpose itself is a few integer operations a lane.
//
// Design: a warp owns a tile of 32 plane words x 32 lanes a word (1024
// elements, 4 KiB each way), one word column j = j0 + lane a thread.  The
// tile's elements arrive with coalesced loads (16 B a thread where k is a
// multiple of 4 and the row pointer is 16-byte aligned, else 4 B) and are
// staged in shared memory, one 36-word row a column: 16-byte stores and
// the column reads that follow are free of bank conflicts.  Each thread
// then holds its column's 32 elements in registers and transposes the
// 32 x 32 bit block there (Hacker's Delight transpose32: five stages of
// 16 masked swaps, ~400 integer operations a column, about half the warp
// instructions of a shuffle butterfly, which moves one word across lanes
// for each 32 elements of every stage); register i is then plane i's word
// of column j, and a warp's 32 threads store each plane's 32 words as one
// 128 B store.  The unpack runs the same tile backwards (the transpose is
// its own inverse): coalesced 4 B plane loads, the transpose, the staged
// tile, coalesced element stores.  A warp keeps its whole 4 KiB tile of
// loads in flight (8 16-byte or 32 4-byte loads a thread), and 32 warps
// an SM (64 registers a thread allow four 256-thread blocks) keep far
// more bytes in flight than the card's latency needs: the kernels run
// within ~6 % of a plain device-to-device copy of the same bytes.  Lanes
// past k, words past W, planes past n_bits and the zero planes past the
// 32nd are masked in the kernel: nothing is padded and the output needs
// no zeroing.  Offsets are 64-bit; a grid-stride loop covers tiles past
// the grid's limit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;     // warps a block: 256 threads (ops.THREADS)
constexpr int kRow = 36;      // staged words a column: 32 + 4 of padding
constexpr int kTile = 1024;   // elements a tile: 32 columns of 32

// One stage of transpose32, for J = 16, 8, 4, 2, 1: swap the bits of
// a[k] whose index has bit J set with the bits of a[k + J] whose index
// has it clear, for every k with bit J clear.  The mask holds the bits
// whose index has bit J clear (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F,
// 0x33333333, 0x55555555).  A template, so every index is a constant
// and the 32 words stay in registers.
template <int J>
__device__ __forceinline__ void swap_stage(uint32_t (&a)[32]) {
  constexpr uint32_t m = 0xFFFFFFFFu / ((1u << J) + 1u);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if ((k & J) == 0) {
      const uint32_t t = ((a[k] >> J) ^ a[k + J]) & m;
      a[k + J] ^= t;
      a[k] ^= t << J;
    }
  }
}

// In place: bit i of a[e] becomes bit e of a[i].  The five stages
// together exchange every row index with every bit index.
__device__ __forceinline__ void transpose32(uint32_t (&a)[32]) {
  swap_stage<16>(a);
  swap_stage<8>(a);
  swap_stage<4>(a);
  swap_stage<2>(a);
  swap_stage<1>(a);
}

// x: (batch, k) elements; out: (batch, n_bits, words), words =
// ceil(k / 32).  kVec: 16-byte loads (k % 4 == 0, x 16-byte aligned).
template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    pack_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                long long batch, long long k, int n_bits) {
  __shared__ __align__(16) uint32_t stage[kWarps][32 * kRow];
  const int lane = threadIdx.x & 31;
  uint32_t* s = stage[threadIdx.x >> 5];
  const long long words = (k + 31) / 32;
  const long long row_tiles = (k + kTile - 1) / kTile;
  const long long tiles = batch * row_tiles;
  const long long step = (long long)gridDim.x * kWarps;
  const int n = n_bits < 32 ? n_bits : 32;
  for (long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < tiles; t += step) {
    const long long b = t / row_tiles;
    const long long e0 = (t - b * row_tiles) * kTile;
    const uint32_t* src = x + b * k + e0;
    const long long left = k - e0;   // elements of the row from e0 on
    // Element f of the tile (column f / 32, lane f % 32) goes to
    // s[(f / 32) * kRow + f % 32].
    if (kVec) {
#pragma unroll
      for (int q = 0; q < kTile / 128; ++q) {
        const int f = q * 128 + lane * 4;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (f < left) v = __ldg(reinterpret_cast<const uint4*>(src + f));
        *reinterpret_cast<uint4*>(s + (f >> 5) * kRow + (f & 31)) = v;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int f = q * 32 + lane;
        s[q * kRow + lane] = f < left ? __ldg(src + f) : 0u;
      }
    }
    __syncwarp();
    uint32_t a[32];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 v = *reinterpret_cast<const uint4*>(s + lane * kRow + 4 * q);
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
    __syncwarp();   // the next tile restages s
    transpose32(a);
    const long long j = e0 / 32 + lane;
    if (j < words) {
      uint32_t* dst = out + b * n_bits * words + j;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i < n) dst[i * words] = a[i];
      }
      for (int i = 32; i < n_bits; ++i) dst[i * words] = 0u;
    }
  }
}

// planes: (batch, n_planes, words); out: (batch, k), k <= 32 * words.
// kVec: 16-byte stores (k % 4 == 0, out 16-byte aligned).
template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    unpack_kernel(const uint32_t* __restrict__ planes,
                  uint32_t* __restrict__ out, long long batch, long long k,
                  long long words, int n_planes) {
  __shared__ __align__(16) uint32_t stage[kWarps][32 * kRow];
  const int lane = threadIdx.x & 31;
  uint32_t* s = stage[threadIdx.x >> 5];
  const long long row_tiles = (k + kTile - 1) / kTile;
  const long long tiles = batch * row_tiles;
  const long long step = (long long)gridDim.x * kWarps;
  const int n = n_planes < 32 ? n_planes : 32;
  for (long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < tiles; t += step) {
    const long long b = t / row_tiles;
    const long long e0 = (t - b * row_tiles) * kTile;
    const long long j = e0 / 32 + lane;
    const bool live = j * 32 < k;   // the column holds an element of the row
    const uint32_t* src = planes + b * n_planes * words + j;
    uint32_t a[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      a[i] = live && i < n ? __ldg(src + i * words) : 0u;
    }
    transpose32(a);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      *reinterpret_cast<uint4*>(s + lane * kRow + 4 * q) =
          make_uint4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
    }
    __syncwarp();
    uint32_t* dst = out + b * k + e0;
    const long long left = k - e0;
    if (kVec) {
#pragma unroll
      for (int q = 0; q < kTile / 128; ++q) {
        const int f = q * 128 + lane * 4;
        if (f < left) {
          *reinterpret_cast<uint4*>(dst + f) =
              *reinterpret_cast<const uint4*>(s + (f >> 5) * kRow + (f & 31));
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int f = q * 32 + lane;
        if (f < left) dst[f] = s[q * kRow + lane];
      }
    }
    __syncwarp();   // the next tile restages s
  }
}

}  // namespace

// x: (batch, k) int32, contiguous; out: (batch, n_bits, ceil(k / 32))
// int32, contiguous, filled completely.  vec != 0 takes 16-byte loads
// (k a multiple of 4, x 16-byte aligned; refused with
// cudaErrorInvalidValue otherwise).  blocks of 256 threads, one tile of
// 1024 elements a warp.
extern "C" int pack_uint_elements_launch(const void* x, void* out,
                                         long long batch, long long k,
                                         int n_bits, int vec, int blocks,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    if ((k & 3) != 0 || ((uintptr_t)x & 15) != 0)
      return (int)cudaErrorInvalidValue;
    pack_kernel<true><<<blocks, kWarps * 32, 0, s>>>(
        (const uint32_t*)x, (uint32_t*)out, batch, k, n_bits);
  } else {
    pack_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
        (const uint32_t*)x, (uint32_t*)out, batch, k, n_bits);
  }
  return (int)cudaGetLastError();
}

// planes: (batch, n_planes, words) int32, contiguous, k <= 32 * words;
// out: (batch, k) int32, contiguous, filled completely.  vec != 0 takes
// 16-byte stores (k a multiple of 4, out 16-byte aligned; refused with
// cudaErrorInvalidValue otherwise).
extern "C" int unpack_uint_elements_launch(const void* planes, void* out,
                                           long long batch, long long k,
                                           long long words, int n_planes,
                                           int vec, int blocks,
                                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    if ((k & 3) != 0 || ((uintptr_t)out & 15) != 0)
      return (int)cudaErrorInvalidValue;
    unpack_kernel<true><<<blocks, kWarps * 32, 0, s>>>(
        (const uint32_t*)planes, (uint32_t*)out, batch, k, words, n_planes);
  } else {
    unpack_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
        (const uint32_t*)planes, (uint32_t*)out, batch, k, words, n_planes);
  }
  return (int)cudaGetLastError();
}
