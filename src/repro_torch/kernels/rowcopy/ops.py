"""Multi-RowCopy fan-out: the CUDA kernel's wrapper.

On a CUDA tensor :func:`fanout` launches ``csrc/fanout.cu``; on a CPU
tensor it computes the same copy with :func:`~repro_torch.kernels.
rowcopy.ref.fanout_ref`.  ``launches`` counts kernel launches, and
nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import launch
from repro_torch.kernels.rowcopy.ref import fanout_ref

#: Kernel launches made by this module since the count was last zeroed.
launches = 0

_ARGS = [launch.VOID_P, launch.VOID_P, launch.I32, launch.I64, launch.I32,
         launch.I32, launch.VOID_P]


def fanout(src: torch.Tensor, fanout_n: int, *,
           threads: int = 256) -> torch.Tensor:
    """Broadcast (...) int32 words -> (fanout_n, ...), Multi-RowCopy style."""
    global launches
    launch.check_words("fanout", src)
    if fanout_n < 0:
        raise ValueError(f"fanout must be >= 0, got {fanout_n}")
    if launch.on_cpu(src):
        return fanout_ref(src, fanout_n)
    out = torch.empty((fanout_n, *src.shape), dtype=torch.int32,
                      device=src.device)
    words = src.numel()
    fn = launch.kernel("fanout", "fanout_launch", _ARGS)
    launch.run(fn, "fanout", src.device, src.data_ptr(), out.data_ptr(),
               fanout_n, words, launch.blocks_for(words, threads), threads)
    launches += 1
    return out


__all__ = ["fanout", "fanout_ref"]
