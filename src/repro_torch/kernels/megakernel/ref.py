"""Plain PyTorch version of the megakernel (``csrc/megakernel.cu``).

Executes a :class:`~repro_torch.compile.megakernel.MegaLowering` against
a program-rows image with per-slot python loops — deliberately the
dumbest interpretation of the tables, so tests can separate *lowering*
bugs (tables disagree with the Program) from *kernel* bugs (the kernel
disagrees with its own tables).
"""

from __future__ import annotations

import torch

from repro_torch.compile.megakernel import (MegaLowering, N_CONST_ROWS,
                                            ONE_ROW)
from repro_torch.core import bitplanes as bp


def schedule_exec_ref(lowering: MegaLowering,
                      state: torch.Tensor) -> torch.Tensor:
    """Run the level tables on a (rows, words) int32 image, per slot."""
    rows, words = state.shape
    aug = state.new_zeros((rows + N_CONST_ROWS, words))
    aug[ONE_ROW] = bp.ONES
    aug[N_CONST_ROWS:] = state
    for li in range(lowering.n_levels):
        entry = aug.clone()
        for w in range(lowering.w_max):
            operands = entry[torch.as_tensor(lowering.src[li, w],
                                             device=state.device)]
            vote = bp.majority(operands, axis=0)
            if lowering.inv[li, w]:
                vote = ~vote
            aug[int(lowering.dst[li, w])] = vote
    return aug[N_CONST_ROWS:]
