"""Plain PyTorch version of the mismatch-count (success-rate) kernel.

The ``oracle`` backend computes with it, the ``mismatch`` wrapper uses
it on CPU tensors, and ``chip_smoke.py`` holds ``csrc/mismatch.cu``
against it on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitplanes as bp


def mismatch_count_ref(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Total number of differing bits between two packed-word tensors.

    Returns an int32 scalar that wraps past 2**31 differing bits, as the
    reference's int32 accumulator does.
    """
    total = bp.popcount(got ^ want).to(torch.int64).sum() & 0xFFFFFFFF
    return bp.wrap_i32(total)
