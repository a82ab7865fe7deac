"""Op-level MAJX on a subarray (paper §3.3, §5).

Characterization flow (five steps, §3.3):
  1. store the X input operands in X rows of the activation group,
  2. replicate them floor(N/X) times across the group (Multi-RowCopy),
  3. Frac-initialize the N%X leftover rows to neutral,
  4. issue APA with the MAJX-optimal timings (t1=1.5ns, t2=3ns),
  5. read the result back from the row buffer.

`majx` performs all five steps against a
:class:`~repro_torch.core.subarray.Subarray` and returns the packed result
plane.  `majx_reference` is the pure boolean oracle used by tests.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import bitplanes as bp
from repro_torch.core import calibration as cal
from repro_torch.core import commands as cmd
from repro_torch.core.subarray import Subarray


def majx_reference(operands: torch.Tensor) -> torch.Tensor:
    """Pure bitwise majority over packed operand planes, shape (X, words)."""
    return bp.majority(torch.as_tensor(operands), axis=0)


def majx(
    sa: Subarray,
    operands: Sequence[torch.Tensor],
    n_act: int,
    *,
    t1_ns: float = cal.MAJX_BEST_T1_NS,
    t2_ns: float = cal.MAJX_BEST_T2_NS,
    base_row: int = 0,
    pattern: str = "random",
) -> torch.Tensor:
    """Run MAJX over ``operands`` using N-row activation; returns the result.

    ``operands`` are packed planes (each a full row image: int32 tensors,
    or anything ``np.asarray(x, np.uint32)`` takes).  The function stages
    operands + replicas + neutral rows into the activation group rooted
    at ``base_row`` exactly as §3.3 prescribes.
    """
    x = len(operands)
    if x % 2 == 0 or x < 3:
        raise ValueError("MAJX requires odd X >= 3")
    copies, neutral = cal.replication_plan(x, n_act)
    rf, rs = sa.decoder.pair_for_n_rows(n_act, base_row)
    group = sa.decoder.apa_activated_rows(rf, rs)
    assert len(group) == n_act

    # Steps 1+2: operands and their replicas.
    slots = list(group)
    for c in range(copies):
        for i, op_plane in enumerate(operands):
            sa.write_row(slots[c * x + i], op_plane)
    # Step 3: neutral rows via Frac (Mfr M: bias-emulated, §3.3 fn 5).
    for j in range(copies * x, n_act):
        sa.run(cmd.frac(slots[j]))
    # Step 4: the APA, with the operand-count hint for the error surface.
    sa.hint(x=x, pattern=pattern)
    sa.run(cmd.apa(rf, rs, t1_ns, t2_ns))
    # Step 5: read back the row buffer.
    return sa.row_buffer


def majx_success_measured(
    sa: Subarray,
    operands: Sequence[torch.Tensor],
    n_act: int,
    **kw,
) -> float:
    """Fraction of bitlines whose MAJX result is correct (one trial).

    Mirrors the paper's §3.3 measurement on our behavioural model.
    """
    got = majx(sa, operands, n_act, **kw)
    want = majx_reference(torch.stack([sa._words(o) for o in operands]))
    same = ~(got ^ want)
    return int(torch.sum(bp.popcount(same))) / (sa.n_words * 32)


def and_via_maj3(sa: Subarray, a, b, n_act: int = 4, **kw) -> torch.Tensor:
    """AND(a,b) = MAJ3(a, b, 0)  (Ambit-style, §8.1)."""
    a = sa._words(a)
    return majx(sa, [a, b, torch.zeros_like(a)], n_act, **kw)


def or_via_maj3(sa: Subarray, a, b, n_act: int = 4, **kw) -> torch.Tensor:
    """OR(a,b) = MAJ3(a, b, 1)."""
    a = sa._words(a)
    return majx(sa, [a, b, torch.full_like(a, bp.ONES)], n_act, **kw)
