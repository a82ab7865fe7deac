// A whole lowered Schedule in ONE launch, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/megakernel/kernel.py, schedule_pallas
// (body schedule_kernel); host wrapper src/repro/kernels/megakernel/
// ops.py, run_lowering.
//
// Computes: the lowering's level tables, level by level, against the
// augmented (rows + 3, words) image (rows 0/1/2 are the constant zero,
// one and trash rows): every write slot of a level takes the bitwise
// majority of its operand rows as they were when the level began,
// complements it where its flag says so, and writes its destination
// row.  The kernel walks the execution plan of the tables
// (kernels/megakernel/plan.py), not the padded tables: per level only
// the slots whose writes can be observed, each with its real arity, as
// 16-byte records [op_begin, arity, dst, inv] over a flat operand list;
// levels are [slot_begin, n_plain, n_hazard, 0].  The plan lists a
// level's plain slots first, then its hazard slots, whose destination
// another slot of the level reads.
//
// Bound on this card: device-memory bytes, the image read once and
// written once (2 * rows * words * 4).  Resident, the kernel moves just
// that.  Streaming, every kept operand and destination word moves
// between the SMs and L2 (or HBM).  Either way a level costs a block a
// chain of dependent steps and a barrier whatever its width, so with
// hundreds or thousands of levels that latency, times the strips an SM
// must run in turn, sets the floor rather than the bytes (PERF.md).
//
// Design: word columns are independent (every op is bitwise per word),
// so a block owns a strip of `strip` columns and runs all levels on it;
// blocks never wait for one another and the whole schedule stays one
// launch.  The block's threads share each level's slots, one (slot,
// four columns) item at a time with 16-byte accesses where the word
// count and alignment allow (one column otherwise); neighbouring
// threads take neighbouring columns of one slot, so a warp reads a
// row's strip at once.  __syncthreads() separates the levels: every
// item's reads happen before any later level's writes.  A plain slot's
// destination is read by no other slot of its level, so it writes
// straight into the image; hazard votes are held in shared memory and
// written after a second __syncthreads(), once every read of the level
// is done.  Loop bounds come from the plan and are the same for every
// thread, so each barrier is reached by the whole block.  Two regimes,
// chosen on the host from the shapes (plan.py, plan_launch):
//   * resident: the block's strip of the whole augmented image, laid
//     out [row][strip] (a quarter-warp reading one row's 128 bytes is
//     free of bank conflicts), lives in dynamic shared memory.  It is
//     loaded from the program rows once, the constant rows are made in
//     place, all levels run in shared memory, and the program rows are
//     written to the output once;
//   * streaming: too few columns of the image fit an SM; it stays in
//     device memory (the augmented copy, updated in place) and in L2.
//     Image words are read with plain loads, never through the
//     read-only path: the image is written during the launch, and
//     __syncthreads() is what makes one warp's writes visible to the
//     others.  Shared memory holds the hazard votes and the plan.
// A level's plan entries are the same for every thread, and a chain of
// dependent table loads from device memory every level (level record,
// slot record, operand rows, then the image) would add to each level's
// latency: so the block copies a chunk of consecutive levels' entries
// into shared memory at once (the plan's chunks, with every thread's
// loads in flight) and reads its tables from there.  The counter's
// digit count is a template argument (bitslice::with_digits) covering
// the plan's widest slot; a slot's threshold is arity / 2 + 1.
#include <cuda_runtime.h>

#include <cstdint>

#include "bitslice.cuh"

namespace {

// Operand words fetched ahead of the counter (the plans' slots are
// mostly of arity 1, 3 and 5).
constexpr int kGroup = 4;
// Loads in flight a thread while a resident strip or a chunk of the
// plan is copied into shared memory.
constexpr int kLoads = 4;

using bitslice::operator~;

// One item: the vote of slot `rec` on one column (W = uint32_t) or four
// (W = uint4).  get(row) reads the level-entry word(s) of augmented row
// `row` in this item's columns.  Operands go kGroup at a time, with no
// branch between the loads: past the slot's arity a lane re-reads its
// last operand (same address) and adds a zero word, so all of a group's
// loads are in flight before the counter takes the first.
template <int D, typename W, typename Get>
__device__ __forceinline__ W vote(const int4 rec, const int* ops, Get get) {
  bitslice::Counter<D, W> cnt;
  cnt.clear();
  const int last = rec.x + rec.y - 1;
  for (int k0 = 0; k0 < rec.y; k0 += kGroup) {
    int row[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) row[j] = ops[min(rec.x + k0 + j, last)];
    W v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) v[j] = get(row[j]);
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      cnt.add(k0 + j < rec.y ? v[j] : bitslice::splat<W>(0u));
  }
  const W out = cnt.ge((unsigned)(rec.y / 2 + 1));
  return rec.w ? ~out : out;
}

// The plan's tables for one chunk of levels, indexed by global level,
// slot and operand numbers: in shared memory when the chunk is staged,
// else the device-memory tables themselves.
struct Tables {
  const int4* levels;
  const int4* slots;
  const int* ops;
};

// The block's strip of the image in shared memory, [row][strip]; q
// counts W a row (strip / 4 for uint4).
template <typename W>
struct SharedImage {
  W* img;
  int q;
  __device__ __forceinline__ W get(int row, int c) const {
    return img[row * q + c];
  }
  __device__ __forceinline__ void put(int row, int c, W v) const {
    img[row * q + c] = v;
  }
};

// The augmented image in device memory, from the strip's first column;
// `stride` counts W a row.  Plain loads: the image is written during
// the launch.
template <typename W>
struct GlobalImage {
  W* base;
  long long stride;
  __device__ __forceinline__ W get(int row, int c) const {
    return base[(long long)row * stride + c];
  }
  __device__ __forceinline__ void put(int row, int c, W v) const {
    base[(long long)row * stride + c] = v;
  }
};

// dst[0:n] = src[0:n] by the whole block, kLoads loads in flight a
// thread before any reaches shared memory.
template <typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* __restrict__ src,
                                           int n) {
  const int nt = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += kLoads * nt) {
    T v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (i0 + j * nt < n) v[j] = __ldg(src + i0 + j * nt);
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (i0 + j * nt < n) dst[i0 + j * nt] = v[j];
    }
  }
}

// Stage each chunk of the plan (all threads), then run its levels on
// the image: q items a slot (W each; q a power of two), the first
// `valid` of them inside the word axis.  Every barrier is reached by
// the whole block: the bounds come from the plan.  The last barrier of
// a level also ends every read of the stage, so the next chunk may
// overwrite it.
template <int D, typename W, typename Image>
__device__ __forceinline__ void run_chunks(
    const int4* __restrict__ chunks, int n_chunks,
    const int4* __restrict__ levels, const int4* __restrict__ slots,
    const int* __restrict__ ops, int4* st_levels, int4* st_slots,
    int* st_ops, W* held, int q, int valid, Image image) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int qs = __ffs(q) - 1;  // q is a power of two
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int4 a = __ldg(chunks + 2 * ch);      // levels, slots
    const int4 b = __ldg(chunks + 2 * ch + 1);  // operands, staged
    Tables t{levels, slots, ops};
    if (b.z) {
      stage_copy(st_levels, levels + a.x, a.y - a.x);
      stage_copy(st_slots, slots + a.z, a.w - a.z);
      stage_copy(st_ops, ops + b.x, b.y - b.x);
      __syncthreads();
      t = Tables{st_levels - a.x, st_slots - a.z, st_ops - b.x};
    }
    for (int l = a.x; l < a.y; ++l) {
      const int4 lv = t.levels[l];  // slot_begin, n_plain, n_hazard
      const int items = (lv.y + lv.z) * q;
      for (int i = tid; i < items; i += nt) {
        const int s = i >> qs, c = i & (q - 1);
        if (c >= valid) continue;
        const int4 rec = t.slots[lv.x + s];
        const W v = vote<D, W>(rec, t.ops,
                               [&](int row) { return image.get(row, c); });
        if (s < lv.y) {
          image.put(rec.z, c, v);
        } else {
          held[i - lv.y * q] = v;
        }
      }
      if (lv.z) {
        __syncthreads();
        for (int i = tid; i < lv.z * q; i += nt) {
          const int s = i >> qs, c = i & (q - 1);
          if (c < valid) image.put(t.slots[lv.x + lv.y + s].z, c, held[i]);
        }
      }
      __syncthreads();
    }
  }
}

// Shared memory: [image strip (resident)][held votes] at 0, the stage
// at `stage` words (16-byte aligned): levels, slots, operands.
struct Smem {
  uint32_t* img;
  uint32_t* held;
  int4* st_levels;
  int4* st_slots;
  int* st_ops;
};

__device__ __forceinline__ Smem carve(uint32_t* smem, int image_words,
                                      int stage, int stage_levels,
                                      int stage_slots) {
  int4* st = (int4*)(smem + stage);
  return Smem{smem, smem + image_words, st, st + stage_levels,
              (int*)(st + stage_levels + stage_slots)};
}

// W = uint4 needs words and strip multiples of 4 and 16-byte aligned
// image pointers (the host checks); the strip's ragged edge is then a
// whole number of uint4.
template <int D, typename W>
__global__ void megakernel_resident(
    const uint32_t* __restrict__ state, uint32_t* __restrict__ out,
    const int4* __restrict__ chunks, int n_chunks,
    const int4* __restrict__ levels, const int4* __restrict__ slots,
    const int* __restrict__ ops, int rows_aug, long long words, int strip,
    int stage, int stage_levels, int stage_slots) {
  constexpr int kPer = sizeof(W) / 4;  // words a W
  extern __shared__ __align__(16) uint32_t smem[];
  const Smem sm =
      carve(smem, rows_aug * strip, stage, stage_levels, stage_slots);
  const int rows = rows_aug - 3;
  const int q = strip / kPer;  // a power of two, as strip is
  const int qs = __ffs(q) - 1;
  W* img = (W*)sm.img;  // [rows_aug][q]
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long n_strips = (words + strip - 1) / strip;
  for (long long sb = blockIdx.x; sb < n_strips; sb += gridDim.x) {
    const long long col0 = sb * strip;
    const int ncols = (int)min((long long)strip, words - col0);
    const int valid = (ncols + kPer - 1) / kPer;
    const W* src = (const W*)(state + col0);
    W* dst = (W*)(out + col0);
    const long long stride = words / kPer;
    // Constant rows: zero, one, trash (starts at zero).
    for (int i = tid; i < 3 * q; i += nt)
      img[i] = bitslice::splat<W>((i >> qs) == 1 ? 0xFFFFFFFFu : 0u);
    // kLoads loads in flight a thread before any reaches shared memory.
    const int n = rows * q;
    for (int i0 = tid; i0 < n; i0 += kLoads * nt) {
      W v[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int i = i0 + j * nt, r = i >> qs, c = i & (q - 1);
        v[j] = (i < n && c < valid) ? __ldg(src + r * stride + c)
                                    : bitslice::splat<W>(0u);
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        if (i0 + j * nt < n) img[3 * q + i0 + j * nt] = v[j];
      }
    }
    __syncthreads();
    run_chunks<D, W>(chunks, n_chunks, levels, slots, ops, sm.st_levels,
                     sm.st_slots, sm.st_ops, (W*)sm.held, q, valid,
                     SharedImage<W>{img, q});
    for (int i = tid; i < n; i += nt) {
      const int r = i >> qs, c = i & (q - 1);
      if (c < valid) dst[r * stride + c] = img[3 * q + i];
    }
    __syncthreads();  // the next strip reuses the shared memory
  }
}

template <int D, typename W>
__global__ void megakernel_streaming(
    uint32_t* image, const int4* __restrict__ chunks, int n_chunks,
    const int4* __restrict__ levels, const int4* __restrict__ slots,
    const int* __restrict__ ops, long long words, int strip, int stage,
    int stage_levels, int stage_slots) {
  constexpr int kPer = sizeof(W) / 4;
  extern __shared__ __align__(16) uint32_t smem[];
  const Smem sm = carve(smem, 0, stage, stage_levels, stage_slots);
  const long long n_strips = (words + strip - 1) / strip;
  for (long long sb = blockIdx.x; sb < n_strips; sb += gridDim.x) {
    const long long col0 = sb * strip;
    const int ncols = (int)min((long long)strip, words - col0);
    run_chunks<D, W>(chunks, n_chunks, levels, slots, ops, sm.st_levels,
                     sm.st_slots, sm.st_ops, (W*)sm.held, strip / kPer,
                     (ncols + kPer - 1) / kPer,
                     GlobalImage<W>{(W*)(image + col0), words / kPer});
  }
}

struct Launch {
  const void* state;
  void* out;
  const void *chunks, *levels, *slots, *ops;
  int n_chunks, rows_aug;
  long long words;
  int resident, strip, vec, smem, stage, stage_levels, stage_slots;
  int blocks, threads;
  cudaStream_t stream;

  template <int D, typename W>
  int go() const {
    const int4* c = (const int4*)chunks;
    const int4* l = (const int4*)levels;
    const int4* s = (const int4*)slots;
    const int* o = (const int*)ops;
    cudaError_t err;
    if (resident) {
      err = cudaFuncSetAttribute(megakernel_resident<D, W>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      megakernel_resident<D, W><<<blocks, threads, smem, stream>>>(
          (const uint32_t*)state, (uint32_t*)out, c, n_chunks, l, s, o,
          rows_aug, words, strip, stage, stage_levels, stage_slots);
    } else {
      err = cudaFuncSetAttribute(megakernel_streaming<D, W>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      megakernel_streaming<D, W><<<blocks, threads, smem, stream>>>(
          (uint32_t*)out, c, n_chunks, l, s, o, words, strip, stage,
          stage_levels, stage_slots);
    }
    return (int)cudaGetLastError();
  }

  template <int D>
  int operator()() const {
    return vec ? go<D, uint4>() : go<D, uint32_t>();
  }
};

}  // namespace

// Resident (resident != 0): state is the (rows_aug - 3, words) program
// rows, read once; out is a (rows_aug - 3, words) output, written once.
// Streaming: state is unused and out is the augmented (rows_aug, words)
// image, updated in place.  chunks: (n_chunks, 8) int32; levels:
// (n_levels, 4) int32; slots: (n_slots, 4) int32; ops: flat int32
// operand rows.  max_arity sizes the counter.  smem is the dynamic
// shared memory of a block in bytes; the stage starts `stage` words in
// and holds stage_levels level records, then stage_slots slot records,
// then the operands.  vec != 0 makes an item four neighbouring columns
// with 16-byte accesses (words and strip multiples of 4, state and out
// 16-byte aligned; refused with cudaErrorInvalidValue otherwise).
extern "C" int megakernel_launch(const void* state, void* out,
                                 const void* chunks, const void* levels,
                                 const void* slots, const void* ops,
                                 int n_chunks, int rows_aug, long long words,
                                 int max_arity, int resident, int strip,
                                 int vec, int smem, int stage,
                                 int stage_levels, int stage_slots,
                                 int blocks, int threads, void* stream) {
  if (vec && ((words & 3) != 0 || (strip & 3) != 0 ||
              (((uintptr_t)state | (uintptr_t)out) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  if (words <= 0) return (int)cudaGetLastError();
  const Launch launch{state,       out,      chunks,   levels, slots,
                      ops,         n_chunks, rows_aug, words,  resident,
                      strip,       vec,      smem,     stage,  stage_levels,
                      stage_slots, blocks,   threads,  (cudaStream_t)stream};
  return bitslice::with_digits(bitslice::digits_for(max_arity), launch);
}
