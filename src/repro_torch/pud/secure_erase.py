"""Cold-boot-attack content destruction (paper §8.2).

Three strategies, exactly as the paper schedules them:

1. **RowClone-based**: WR a predetermined pattern to one row, then RowClone
   it to every other row (one op per destination row).
2. **Frac-based**: Frac every row to the neutral VDD/2 state.
3. **Multi-RowCopy-based**: WR one row, then fan it out with N-row
   activation (N in 2..32), destroying N-1 rows per op.

`destruction_time_ns` is the analytical bank-wipe model behind Fig. 17;
`erase_subarray` actually performs the wipe on the behavioural model (on
the subarray's device).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import calibration as cal
from repro_torch.core.subarray import Subarray
from repro_torch.core import rowcopy as rc
from repro_torch.pud.latency import LAT

#: rows per DDR4 bank (2^16, §7.1) and per subarray (512, Mfr H).
BANK_ROWS = 65536


def destruction_time_ns(strategy: str, n_act: int = 32,
                        bank_rows: int = BANK_ROWS) -> float:
    """Total time to overwrite every row in a bank (Fig. 17 model)."""
    if strategy == "rowclone":
        return LAT.wr_row + (bank_rows - 1) * LAT.rowclone
    if strategy == "frac":
        return bank_rows * LAT.frac
    if strategy == "mrc":
        if n_act not in cal.N_ACT_LEVELS:
            raise ValueError(f"n_act must be one of {cal.N_ACT_LEVELS}")
        # Each MRC issue wipes n_act-1 rows (the source is already wiped).
        ops = -(-(bank_rows - 1) // (n_act - 1))
        return LAT.wr_row + ops * LAT.mrc
    raise ValueError(f"unknown strategy {strategy!r}")


def speedup_over_rowclone(strategy: str, n_act: int = 32) -> float:
    return destruction_time_ns("rowclone") / destruction_time_ns(strategy, n_act)


def erase_subarray(sa: Subarray, pattern_word: int = 0, n_act: int = 32) -> float:
    """Functionally destroy a subarray's content with Multi-RowCopy fan-out.

    Returns the modeled wall time (ns).  Walks activation groups across the
    subarray; any rows not covered by a full group fall back to RowClone.
    """
    word = int(np.uint32(pattern_word).view(np.int32))
    src = torch.full((sa.n_words,), word, dtype=torch.int32, device=sa.device)
    t = LAT.wr_row
    covered = set()
    for base in range(sa.rows):
        if base in covered:
            continue
        try:
            rf, rs = sa.decoder.pair_for_n_rows(n_act, base)
            group = sa.decoder.apa_activated_rows(rf, rs)
        except ValueError:
            continue  # group would cross the subarray boundary
        if any(r in covered for r in group):
            continue
        rc.multi_rowcopy(sa, src, n_act, base_row=base)
        covered.update(group)
        t += LAT.mrc
    for r in range(sa.rows):
        if r not in covered:
            sa.write_row(r, src)
            t += LAT.rowclone
    return t
