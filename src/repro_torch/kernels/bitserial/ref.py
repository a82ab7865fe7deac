"""Plain PyTorch version of the bit-serial adder kernel
(``csrc/bitserial.cu``): what the wrapper computes on a CPU tensor, what
the ``oracle`` backend computes with, and what the kernel is held
against on the card."""

from __future__ import annotations

import torch


def bitserial_add_ref(a_planes: torch.Tensor,
                      b_planes: torch.Tensor) -> torch.Tensor:
    """Ripple-carry addition over bit-planes, LSB-first along axis 0.

    a/b: (NBITS, ...) int32 packed planes.  Returns sum planes
    (NBITS, ...), carry-out discarded (fixed-width wraparound).  Each
    full adder is the §8.1 majority construction:
    ``carry' = MAJ3(a, b, c); sum = a ^ b ^ c``.
    """
    c = torch.zeros_like(a_planes[0])
    outs = []
    for a, b in zip(a_planes, b_planes):
        outs.append(a ^ b ^ c)
        c = (a & b) | (b & c) | (a & c)
    return torch.stack(outs)
