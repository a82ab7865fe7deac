"""The card's published peaks and the bounds the rooflines divide by.

NVIDIA's data sheet for the H100 SXM (80 GB HBM3): 3.35 TB/s of device
memory bandwidth.  Every kernel this benchmark reads is bound by bytes:
each input byte read once and each output byte written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
WORD_BYTES = 4


def bound_s(n_bytes: float) -> float:
    """The least time the card could take to move ``n_bytes``."""
    return n_bytes / HBM_BYTES_PER_S


def image_bytes(rows: int, words: int) -> int:
    """A megakernel run's bytes: the (rows, words) image read once and
    the image it returns written once."""
    return 2 * rows * words * WORD_BYTES


def maj_op_bytes(program, words: int) -> int:
    """Bytes the MAJ ops of a Program need: each op's source rows read
    once and its destination rows written once (padding that a batched
    launch adds is the launch's waste, not the work)."""
    rows = sum(len(op.srcs) + len(op.dsts) for op in program.ops
               if op.kind == "MAJ")
    return rows * words * WORD_BYTES


def share_percent(n_bytes: float, device_s: float):
    """Roofline share in %: bytes over peak bandwidth over the measured
    time; ``None`` where nothing was measured."""
    if not device_s or device_s <= 0 or not n_bytes:
        return None
    return 100.0 * bound_s(n_bytes) / device_s
