"""Plain PyTorch version of the bulk MAJX kernel (``csrc/majx.cu``)."""

from __future__ import annotations

import torch

from repro_torch.core import bitplanes as bp


def majx_ref(planes: torch.Tensor) -> torch.Tensor:
    """Bitwise majority across axis 0 of packed int32 planes.

    planes: (N, ...) int32, N odd.  Returns (...) int32 where each output
    bit is 1 iff more than N/2 of the stacked bits are 1 — the
    charge-share semantics of an N-row activation (paper §5).  Counts
    bit by bit, independently of the kernel's carry-save counter.
    """
    if planes.shape[0] % 2 == 0:
        raise ValueError("MAJX needs odd N")
    return bp.majority(planes, axis=0)
