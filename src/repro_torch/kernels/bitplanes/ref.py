"""Plain PyTorch version of the bit-plane transpose kernels
(``csrc/bitplanes.cu``): what :mod:`repro_torch.core.bitplanes`
computes on a CPU tensor, and what the kernels are held against on the
card."""

from __future__ import annotations

import torch

from repro_torch.core.bitplanes import (WORD_BITS, _word_bits, n_words,
                                        wrap_i32)


def pack_uint_elements_ref(x: torch.Tensor, n_bits: int = 32
                           ) -> torch.Tensor:
    """(..., k) integers, read as ``uint32`` -> (..., n_bits,
    ceil(k/32)) int32 planes.  One plane is built at a time in int32, so
    the temporaries are about the size of the input; planes past the
    32nd are zero."""
    x = torch.as_tensor(x)
    if x.dtype != torch.int32:
        x = wrap_i32(x.to(torch.int64) & 0xFFFFFFFF)
    pad = n_words(x.shape[-1]) * WORD_BITS - x.shape[-1]
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    lanes = x.reshape(*x.shape[:-1], -1, WORD_BITS)
    shifts = torch.arange(WORD_BITS, dtype=torch.int32,
                          device=x.device)
    # Disjoint bits: the int32 sum of a word's lanes is their OR.
    planes = [(((lanes >> i) & 1) << shifts).sum(-1, dtype=torch.int32)
              if i < WORD_BITS else lanes.new_zeros(lanes.shape[:-1])
              for i in range(n_bits)]
    return torch.stack(planes, dim=-2)


def unpack_uint_elements_ref(planes: torch.Tensor, k: int) -> torch.Tensor:
    """(..., n_planes, words) int32 planes -> (..., k) int32 elements.
    Planes past the 32nd carry no bit of an element.  One plane is
    unpacked at a time."""
    out = planes.new_zeros((*planes.shape[:-2], k))
    for i in range(min(planes.shape[-2], WORD_BITS)):
        bits = _word_bits(planes[..., i, :]).reshape(
            *planes.shape[:-2], -1)
        out |= bits[..., :k] << i
    return out
