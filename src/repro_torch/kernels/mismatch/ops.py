"""Mismatch count and success rate: the CUDA kernel's wrapper.

On CUDA tensors :func:`mismatch_count` launches ``csrc/mismatch.cu``;
on CPU tensors it computes the same count with :func:`~repro_torch.
kernels.mismatch.ref.mismatch_count_ref`.  ``launches`` counts kernel
launches, and nothing else.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import launch
from repro_torch.kernels.mismatch.ref import mismatch_count_ref

#: Kernel launches made by this module since the count was last zeroed.
launches = 0

#: Words each thread sums (four 16-byte loads of each operand): sizes
#: the grid so that a launch issues one atomic add per block of that
#: many words, not one per word.
WORDS_PER_THREAD = 16

_ARGS = [launch.VOID_P, launch.VOID_P, launch.VOID_P, launch.I64,
         launch.I32, launch.I32, launch.VOID_P]


def mismatch_count(got: torch.Tensor, want: torch.Tensor, *,
                   threads: int = 256) -> torch.Tensor:
    """Number of differing bits between two packed int32 word tensors.

    Both operands hold the same number of words, in any shape (they are
    compared as flat word sequences); unequal sizes raise.  Returns a
    0-d int32 tensor on the operands' device: the low 32 bits of the
    count, read as two's complement, which is what the reference's int32
    accumulator gives (it wraps past 2**31 differing bits).  The kernel
    counts exactly up to 2**64 before that wrap.  Zero words give 0 and
    still make one launch.
    """
    global launches
    launch.check_words("mismatch", got, min_ndim=0)
    launch.check_words("mismatch", want, min_ndim=0)
    if got.numel() != want.numel():
        raise ValueError(f"mismatch: operands hold {got.numel()} and "
                         f"{want.numel()} words; they must be equal")
    if got.device != want.device:
        raise ValueError(f"mismatch: operands on {got.device} and "
                         f"{want.device}")
    if launch.on_cpu(got):
        return mismatch_count_ref(got.reshape(-1), want.reshape(-1))
    n = got.numel()
    acc = torch.empty(1, dtype=torch.int64, device=got.device)
    fn = launch.kernel("mismatch", "mismatch_launch", _ARGS)
    launch.run(fn, "mismatch", got.device, got.data_ptr(), want.data_ptr(),
               acc.data_ptr(), n,
               launch.blocks_for(-(-n // WORDS_PER_THREAD), threads),
               threads)
    launches += 1
    # Little-endian: the first int32 of the 64-bit count is its low word.
    return acc.view(torch.int32)[0]


def success_rate(got: torch.Tensor, want: torch.Tensor,
                 n_bits: Optional[int] = None, *,
                 threads: int = 256) -> float:
    """Fraction of matching bits — the paper's §3.1 metric."""
    total = int(n_bits) if n_bits else got.numel() * 32
    bad = int(mismatch_count(got, want, threads=threads))
    return 1.0 - bad / total


__all__ = ["mismatch_count", "success_rate", "mismatch_count_ref"]
