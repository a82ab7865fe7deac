// Bit-sliced majority on packed 32-bit words: the device functions that
// the MAJX kernel (majx.cu) and the megakernel (megakernel.cu) share.
//
// Counterpart of _csa_accumulate / _ge_threshold in
// src/repro/kernels/majx/kernel.py.  A word holds 32 independent
// bitlines, so one vote over N operand words is a carry-save counter of
// ceil(log2(N+1)) digit words (digit i holds bit i of every bitline's
// count), then a magnitude comparison of the counter against the
// threshold (N+1)/2, both in AND/XOR/OR only: 32 bitlines per
// instruction, the same bulk geometry as the DRAM subarray.
//
// The digits live in a fixed register array.  Loops run over the full
// array with the live-digit count as a predicate, so every index is a
// compile-time constant after unrolling and the array never spills to
// local memory.
#pragma once

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

struct Counter {
  uint32_t d[kMaxDigits];

  __device__ inline void clear() {
#pragma unroll
    for (int i = 0; i < kMaxDigits; ++i) d[i] = 0u;
  }

  // Add one operand word to every bitline's count (ripple carry).
  // n_digits = digits_for(N) holds any count <= N, so no carry leaves
  // the top digit.
  __device__ inline void add(uint32_t w, int n_digits) {
    uint32_t carry = w;
#pragma unroll
    for (int i = 0; i < kMaxDigits; ++i) {
      if (i < n_digits) {
        const uint32_t next = d[i] & carry;
        d[i] ^= carry;
        carry = next;
      }
    }
  }

  // Bitwise (count >= thresh), scanning the digits MSB first with
  // greater-so-far / equal-so-far accumulators.
  __device__ inline uint32_t ge(unsigned thresh, int n_digits) const {
    uint32_t gt = 0u, eq = 0xFFFFFFFFu;
#pragma unroll
    for (int i = kMaxDigits - 1; i >= 0; --i) {
      if (i < n_digits) {
        if ((thresh >> i) & 1u) {
          eq &= d[i];
        } else {
          gt |= eq & d[i];
          eq &= ~d[i];
        }
      }
    }
    return gt | eq;
  }
};

}  // namespace bitslice
