// Bit-sliced majority on packed 32-bit words: the device functions that
// the MAJX kernel (majx.cu) and the megakernel (megakernel.cu) share.
//
// Counterpart of _csa_accumulate / _ge_threshold in
// src/repro/kernels/majx/kernel.py.  A word holds 32 independent
// bitlines, so one vote over N operand words is a carry-save counter of
// digits_for(N) digit words (digit i holds bit i of every bitline's
// count), then a magnitude comparison of the counter against the
// threshold N / 2 + 1 (strict majority; (N + 1) / 2 for odd N), both in
// AND/XOR/OR only: 32 bitlines per instruction, the same bulk geometry
// as the DRAM subarray.
//
// Counter<D, W> holds D digits of W, one word (uint32_t) or four
// (uint4, for 16-byte loads).  D is a compile-time constant, so every
// loop unrolls to exactly D steps, the digits live in registers, and a
// vote costs 2 * D logic operations an operand; with_digits() maps a
// run-time digit count to the smallest instantiated D that holds it.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace bitslice {

// 20 digits count up to 2^20 - 1 operands, covering every arity the
// backends accept (Capabilities.max_majx is 1e6).
constexpr int kMaxDigits = 20;

// Number of counter digits for n operands: the bit length of n.
__host__ __device__ inline int digits_for(long long n) {
  int d = 0;
  while (n > 0) {
    ++d;
    n >>= 1;
  }
  return d;
}

// Logic on four words at once, so one template serves both widths.
__device__ __forceinline__ uint4 operator&(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint4 operator|(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint4 operator^(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint4 operator~(uint4 a) {
  return make_uint4(~a.x, ~a.y, ~a.z, ~a.w);
}

template <typename W>
__device__ __forceinline__ W splat(uint32_t v);
template <>
__device__ __forceinline__ uint32_t splat<uint32_t>(uint32_t v) {
  return v;
}
template <>
__device__ __forceinline__ uint4 splat<uint4>(uint32_t v) {
  return make_uint4(v, v, v, v);
}

template <int D, typename W = uint32_t>
struct Counter {
  W d[D];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < D; ++i) d[i] = splat<W>(0u);
  }

  // Add one operand word to every bitline's count (ripple carry).  D
  // digits hold any count below 2^D, so no carry leaves the top digit.
  __device__ __forceinline__ void add(W w) {
    W carry = w;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const W next = d[i] & carry;
      d[i] = d[i] ^ carry;
      carry = next;
    }
  }

  // Bitwise (count >= thresh), MSB first with greater-so-far /
  // equal-so-far accumulators; branch-free, since thresh may differ
  // between the threads of a warp (the megakernel's slots).
  __device__ __forceinline__ W ge(unsigned thresh) const {
    W gt = splat<W>(0u), eq = splat<W>(0xFFFFFFFFu);
#pragma unroll
    for (int i = D - 1; i >= 0; --i) {
      const W bit = splat<W>(0u - ((thresh >> i) & 1u));
      gt = gt | (eq & d[i] & ~bit);
      eq = eq & ~(d[i] ^ bit);
    }
    return gt | eq;
  }
};

// Calls f.template operator()<D>() with the smallest instantiated digit
// count D >= n_digits (1..6 exactly, then 10, then kMaxDigits).
template <typename F>
inline int with_digits(int n_digits, F&& f) {
  switch (n_digits) {
    case 0:
    case 1:
      return f.template operator()<1>();
    case 2:
      return f.template operator()<2>();
    case 3:
      return f.template operator()<3>();
    case 4:
      return f.template operator()<4>();
    case 5:
      return f.template operator()<5>();
    case 6:
      return f.template operator()<6>();
    default:
      if (n_digits <= 10) return f.template operator()<10>();
      return f.template operator()<kMaxDigits>();
  }
}

}  // namespace bitslice
