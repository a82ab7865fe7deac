"""Packed bit-plane tensors: the digital substrate of the PUD model.

A DRAM row in the paper is a 65,536-bit vector (8KB x8 chip row).  Rows
(and bit-serial operands) are packed 32 bits to a word: a plane of ``n``
logical bits is ``ceil(n/32)`` words, LSB-first within each word.  All
bulk-bitwise PUD ops (MAJX, Multi-RowCopy, the bit-serial arithmetic of
§8.1) operate on these planes; the CUDA kernels in
:mod:`repro_torch.kernels` consume the same layout.

**Storage is ``torch.int32``.**  PyTorch's ``uint32`` lacks ``~``,
shifts and add/sub on the CPU, so a packed word is an ``int32`` tensor
element holding the exact bit pattern of the reference package's
``uint32`` word.  Bitwise AND/OR/XOR/NOT are the same on both types;
``>>`` on ``int32`` sign-extends (``0x80000001 >> 1`` is ``0xC0000000``),
so every right shift here is masked, and arithmetic that must not wrap
is done in ``int64``.  :func:`from_u32` / :func:`to_u32` are the one
boundary between the reference's ``uint32`` numpy arrays and the port's
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs

WORD_BITS = 32
#: All-ones word as stored (the int32 bit pattern of ``0xFFFFFFFF``).
ONES = -1


def from_u32(a, device) -> torch.Tensor:
    """``uint32`` words -> ``int32`` tensor with the same bits.

    Takes whatever ``np.asarray(a, np.uint32)`` takes (arrays of any
    shape, 0-d included, scalars, lists), as the reference's
    ``jnp.asarray(a, jnp.uint32)`` does; a non-contiguous or read-only
    array is copied first, so the tensor never aliases memory it may
    not write.
    """
    a = np.asarray(a, dtype=np.uint32)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """``int32`` tensor -> ``uint32`` numpy array with the same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"packed words are int32 tensors, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """``int64`` values in ``[0, 2**32)`` -> ``int32`` with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def n_words(n_bits: int) -> int:
    """Number of 32-bit words needed for ``n_bits`` logical bits."""
    return -(-n_bits // WORD_BITS)


def _shifts(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _pack_word_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) 0/1 integers (bit ``i`` of each word) -> (...) int32."""
    b = bits.to(torch.int64) << _shifts(WORD_BITS, bits.device)
    return wrap_i32(b.sum(dim=-1))


def _word_bits(words: torch.Tensor) -> torch.Tensor:
    """(...) int32 words -> (..., 32) int32 bits, LSB first.

    The ``& 1`` after the shift discards the sign-extended high bits.
    """
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    return (words[..., None] >> shifts) & 1


def pack(bits: torch.Tensor) -> torch.Tensor:
    """Pack a boolean/0-1 tensor of shape (..., n_bits) into int32 words.

    Returns shape (..., ceil(n_bits/32)), LSB-first.  n_bits is padded
    with zeros to a multiple of 32.
    """
    bits = torch.as_tensor(bits)
    n_bits = bits.shape[-1]
    pad = n_words(n_bits) * WORD_BITS - n_bits
    if pad:
        bits = torch.nn.functional.pad(bits.to(torch.int32), (0, pad))
    return _pack_word_bits(bits.reshape(*bits.shape[:-1], -1, WORD_BITS))


def unpack(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack`; returns a bool tensor (..., n_bits)."""
    bits = _word_bits(words).reshape(*words.shape[:-1], -1)
    return bits[..., :n_bits].to(torch.bool)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count (int32 words in, int32 counts out).

    The SWAR steps run in ``int64`` on the zero-extended word, so no
    shift sign-extends and no product wraps.
    """
    w = words.to(torch.int64) & 0xFFFFFFFF
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return (((w * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def majority(planes: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Bitwise majority across ``planes`` (odd count) along ``axis``.

    Each output bit is 1 iff more than half the stacked bits are 1 — the
    charge-sharing semantics of an N-row activation for odd N.  This is
    the plain version, which expands every word to 32 bit lanes;
    :func:`majority_words` computes the same function word-parallel.
    """
    planes = torch.movedim(planes, axis, 0)
    n = planes.shape[0]
    count = _word_bits(planes).sum(dim=0)
    return _pack_word_bits((2 * count > n).to(torch.int32))


def majority_with_ties(planes: torch.Tensor, tie_value: int,
                       axis: int = 0) -> torch.Tensor:
    """Majority that resolves exact ties (even N) to ``tie_value`` (0/1).

    Models the sense-amp bias of §3.3 fn.5: Mfr M amplifiers are biased to
    a fixed polarity, so an even split resolves deterministically.
    """
    planes = torch.movedim(planes, axis, 0)
    n = planes.shape[0]
    count = _word_bits(planes).sum(dim=0)
    out = torch.where(2 * count == n, int(tie_value) & 1,
                      (2 * count > n).to(torch.int32))
    return _pack_word_bits(out)


def maj3_words(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """Closed-form bitwise MAJ3 on packed words: (a&b)|(b&c)|(a&c)."""
    return (a & b) | (b & c) | (a & c)


def majority_words(planes: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """:func:`majority`, computed on whole words (no bit expansion).

    A bit-sliced carry-save counter, as ``csrc/bitslice.cuh`` runs it on
    the card: digit ``i`` holds bit ``i`` of all 32 bitlines' counts,
    each plane ripples in with AND/XOR, and the digits are compared
    against the threshold ``n // 2 + 1`` most significant first.  Only
    bitwise AND/OR/XOR/NOT touch the words, so the int32 storage needs
    no masking, and the temporaries are a few planes, not 32 lanes a
    word.
    """
    planes = torch.movedim(planes, axis, 0)
    n = planes.shape[0]
    if n == 0:
        return planes.new_zeros(planes.shape[1:])
    n_digits = n.bit_length()   # holds any count <= n
    digits = [torch.zeros_like(planes[0]) for _ in range(n_digits)]
    for plane in planes:
        carry = plane
        for i in range(n_digits):
            digits[i], carry = digits[i] ^ carry, digits[i] & carry
    thresh = n // 2 + 1         # count > n / 2
    gt = torch.zeros_like(planes[0])
    eq = torch.full_like(planes[0], ONES)
    for i in reversed(range(n_digits)):
        if (thresh >> i) & 1:
            eq = eq & digits[i]
        else:
            gt = gt | (eq & digits[i])
            eq = eq & ~digits[i]
    return gt | eq


def weighted_majority(planes: torch.Tensor, weights,
                      axis: int = 0) -> torch.Tensor:
    """Weighted bitwise majority: 1 iff sum(w_i * bit_i) > sum(w) / 2.

    The MAJ-composition identities of §8.1 use it (the two-position carry
    c2 = MAJ7(a1,a1,b1,b1,a0,b0,c0) is the weighted majority (2, 2, 1, 1,
    1) of (a1, b1, a0, b0, c0)).  ``weights`` holds one integer a plane
    along ``axis``.

    Computed on whole words, like :func:`majority_words`: each lane's
    weighted sum is kept bit-sliced in ``k`` two's-complement digit
    words, each plane adds its weight into the lanes where its bit is set
    by a ripple of full adders, then ``sum(w) // 2 + 1`` is subtracted;
    a lane's answer is its clear sign digit.  ``k`` is a few more than
    ``log2(sum |w|)``, so the temporaries are a few planes, never the 32
    lanes a word that the reference expands to.  The planes stay on
    their device.
    """
    planes = torch.movedim(planes, axis, 0)
    w = [int(v) for v in torch.as_tensor(weights).reshape(-1).tolist()]
    if len(w) != planes.shape[0]:
        raise ValueError(f"{len(w)} weights for {planes.shape[0]} planes")
    zero = planes.new_zeros(planes.shape[1:])
    thresh = sum(w) // 2 + 1                    # sum > sum(w) / 2
    k = (sum(map(abs, w)) + abs(thresh)).bit_length() + 1

    def add(digits, bit, value):
        """``digits`` plus ``value`` in the lanes where ``bit`` is set."""
        out, carry = [], zero
        for i, d in enumerate(digits):
            a = bit if (value >> i) & 1 else zero
            out.append(d ^ a ^ carry)
            carry = (d & a) | (carry & (d ^ a))
        return out

    digits = [zero] * k
    for plane, wi in zip(planes, w):
        digits = add(digits, plane, wi)
    return ~add(digits, ~zero, -thresh)[-1]


def pack_uint_elements(x: torch.Tensor, n_bits: int = 32) -> torch.Tensor:
    """Transpose ``k`` unsigned integers into ``n_bits`` bit-planes.

    Input: integer tensor of shape (..., k), read as ``uint32`` (an
    ``int32`` element is its bit pattern; wider integers are taken
    modulo 2**32).  Output: int32 planes of shape
    (..., n_bits, ceil(k/32)) — plane ``i`` holds bit ``i`` of every
    element, the column-parallel layout the §8.1 microbenchmarks
    compute in; lanes past ``k`` are zero, and so are planes past the
    32nd.  A CUDA tensor is transposed by ``csrc/bitplanes.cu`` in one
    launch, a CPU tensor by the plain version, one plane at a time.
    """
    from repro_torch.kernels.bitplanes import ops

    with obs.span("bitplanes.pack"):
        return ops.pack_uint_elements(x, n_bits)


def unpack_uint_elements(planes: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_uint_elements` -> int32 tensor (..., k).

    Each element holds the ``uint32`` bit pattern of the value; planes
    past the 32nd carry no bit of it, and missing ones read as zero.  A
    CUDA tensor is unpacked by ``csrc/bitplanes.cu`` in one launch, a
    CPU tensor by the plain version, one plane at a time.
    """
    from repro_torch.kernels.bitplanes import ops

    with obs.span("bitplanes.unpack"):
        return ops.unpack_uint_elements(planes, k)


def bitcast_to_planes(x: torch.Tensor
                      ) -> tuple[torch.Tensor, tuple, torch.dtype]:
    """View an arbitrary fixed-width tensor as packed int32 words.

    Returns (words, original_shape, original_dtype) so that
    :func:`bitcast_from_planes` can reconstruct it.  Majority voting is
    bitwise, so any dtype can be protected by voting on its raw words.
    Narrow elements pack LSB-first into little-endian words (2 halves or
    4 bytes per word, zero-padded), the reference package's layout; an
    8-byte element (float64, int64) is two words, low word first, so a
    64-bit leaf is voted exactly (the reference narrows it to 32 bits
    when it reads it back with 64-bit types disabled).
    """
    nbytes = x.element_size()
    if nbytes not in (1, 2, 4, 8):
        raise TypeError(f"unsupported itemsize {nbytes} for dtype {x.dtype}")
    flat = x.reshape(-1)
    if flat.dtype == torch.bool:
        flat = flat.view(torch.uint8)
    pad = (-flat.numel()) % max(1, 4 // nbytes)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.contiguous().view(torch.int32), tuple(x.shape), x.dtype


def bitcast_from_planes(words: torch.Tensor, shape: tuple,
                        dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`bitcast_to_planes`."""
    n_elem = int(np.prod(shape)) if shape else 1
    view_dtype = torch.uint8 if dtype == torch.bool else dtype
    if torch.empty((), dtype=view_dtype).element_size() not in (1, 2, 4, 8):
        raise TypeError(f"unsupported dtype {dtype}")
    flat = words.contiguous().view(view_dtype)[:n_elem]
    return flat.view(dtype).reshape(shape)
