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
         launch.I32, launch.I32, launch.I32, launch.VOID_P]

#: Source columns of one window of blocks: 1 MiB of 16-byte columns.
#: The kernel's blocks take a window's column chunks for one group of
#: destinations, then for the next group, then the next window.
WINDOW_COLS = 2**16
#: Largest grid z (windows) a launch asks for; a grid-stride loop covers
#: the rest.
MAX_WINDOWS = 65535
#: Largest fan-out the kernel takes: grid y holds one group of
#: destinations a block (4 on the 16-byte path, 8 on the 4-byte one) and
#: at most 65535 groups.  The plain version takes any.
MAX_FANOUT = 65535 * 4


def geometry(words: int, src_ptr: int, out_ptr: int,
             threads: int) -> tuple[bool, int, int]:
    """``(vec, window, windows)`` of one launch over ``words`` words.

    ``vec``: four words a thread (16-byte loads and stores), where
    ``words`` is a multiple of 4 and both pointers are 16-byte aligned;
    every destination row then starts aligned too.  ``window``: column
    chunks of ``threads`` columns a window (grid x), at most
    :data:`WINDOW_COLS` columns and never more chunks than there are;
    ``windows``: grid z, capped at CUDA's limit.  Raises for a
    ``threads`` the card cannot take.
    """
    vec = words % 4 == 0 and (src_ptr | out_ptr) % 16 == 0
    chunks = launch.blocks_for(words // 4 if vec else words, threads)
    window = min(chunks, WINDOW_COLS // threads)
    return vec, window, min(-(-chunks // window), MAX_WINDOWS)


def fanout(src: torch.Tensor, fanout_n: int, *,
           threads: int = 256) -> torch.Tensor:
    """Broadcast (...) int32 words -> (fanout_n, ...), Multi-RowCopy style.

    An empty output (``fanout_n`` 0 or an empty source) launches nothing
    and counts nothing."""
    global launches
    launch.check_words("fanout", src)
    if fanout_n < 0:
        raise ValueError(f"fanout must be >= 0, got {fanout_n}")
    if launch.on_cpu(src):
        return fanout_ref(src, fanout_n)
    if fanout_n > MAX_FANOUT:
        raise ValueError(f"fanout must be <= {MAX_FANOUT} on the card, "
                         f"got {fanout_n}")
    out = torch.empty((fanout_n, *src.shape), dtype=torch.int32,
                      device=src.device)
    words = src.numel()
    if out.numel() == 0:
        return out
    vec, window, windows = geometry(words, src.data_ptr(), out.data_ptr(),
                                    threads)
    fn = launch.kernel("fanout", "fanout_launch", _ARGS)
    launch.run(fn, "fanout", src.device, src.data_ptr(), out.data_ptr(),
               fanout_n, words, int(vec), window, windows, threads)
    launches += 1
    return out


__all__ = ["fanout", "fanout_ref"]
