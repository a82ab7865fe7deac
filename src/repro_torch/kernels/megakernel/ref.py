"""The independent oracle of the megakernel (``csrc/megakernel.cu``).

Executes a :class:`~repro_torch.compile.megakernel.MegaLowering` against
a program-rows image the plainest way the padded tables allow: every
slot of every level, padding included, votes by counting bits (the
32-lane expansion of :func:`~repro_torch.core.bitplanes.majority`, not
the kernel's carry-save counter), all from the level-entry image, and
the last slot that names a row writes it.  It shares nothing with the
execution plan (:mod:`repro_torch.kernels.megakernel.plan`) that the
kernel and its plain walker run, so tests can separate *lowering* bugs
(tables disagree with the Program) from *plan or kernel* bugs (the plan
walk disagrees with the tables).  A level's slots are taken in chunks
that bound the bit expansion's memory.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.compile.megakernel import (MegaLowering, N_CONST_ROWS,
                                            ONE_ROW)
from repro_torch.core import bitplanes as bp

#: Most 32-bit lanes one chunk of votes expands to.
_LANES_PER_CHUNK = 2**26


def schedule_exec_ref(lowering: MegaLowering,
                      state: torch.Tensor) -> torch.Tensor:
    """Run the padded level tables on a (rows, words) int32 image."""
    rows, words = state.shape
    aug = state.new_zeros((rows + N_CONST_ROWS, words))
    aug[ONE_ROW] = bp.ONES
    aug[N_CONST_ROWS:] = state
    w_max, x_max = lowering.w_max, lowering.x_max
    chunk = max(1, _LANES_PER_CHUNK // max(1, x_max * words * 32))
    for li in range(lowering.n_levels):
        entry = aug.clone()
        votes = []
        for lo in range(0, w_max, chunk):
            src = torch.as_tensor(lowering.src[li, lo:lo + chunk],
                                  dtype=torch.int64, device=state.device)
            votes.append(bp.majority(entry[src], axis=1))   # (w, words)
        votes = torch.cat(votes)
        flip = torch.as_tensor(lowering.inv[li].astype(bool),
                               device=state.device)
        votes = torch.where(flip[:, None], ~votes, votes)
        dst = np.asarray(lowering.dst[li], np.int64)
        # The last slot naming a row is the one whose vote it keeps.
        _, first_from_end = np.unique(dst[::-1], return_index=True)
        last = w_max - 1 - first_from_end
        aug[torch.as_tensor(dst[last], device=state.device)] = \
            votes[torch.as_tensor(last, device=state.device)]
    return aug[N_CONST_ROWS:]
