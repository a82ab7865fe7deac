"""Bulk MAJX: the CUDA kernel's wrapper, and the TMR vote built on it.

On a CUDA tensor :func:`majx` launches ``csrc/majx.cu``; on a CPU tensor
it computes the same function with :func:`~repro_torch.kernels.majx.ref.
majx_ref`.  ``launches`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitplanes as bp
from repro_torch.kernels import launch
from repro_torch.kernels.majx.ref import majx_ref

#: Kernel launches made by this module since the count was last zeroed.
launches = 0

_ARGS = [launch.VOID_P, launch.VOID_P, launch.I64, launch.I32, launch.I64,
         launch.I32, launch.I32, launch.VOID_P]


def majx_batch(planes: torch.Tensor, *, threads: int = 256) -> torch.Tensor:
    """B independent votes: (B, N, ...) int32 planes -> (B, ...).

    One kernel launch for the whole batch.  N must be odd.
    """
    global launches
    launch.check_words("majx", planes, min_ndim=3)
    b, n = planes.shape[:2]
    if n % 2 == 0:
        raise ValueError("MAJX needs odd N")
    if launch.on_cpu(planes):
        return majx_ref(planes.movedim(1, 0))
    out = torch.empty((b, *planes.shape[2:]), dtype=torch.int32,
                      device=planes.device)
    words = out[0].numel() if b else 0
    fn = launch.kernel("majx", "majx_launch", _ARGS)
    launch.run(fn, "majx", planes.device, planes.data_ptr(),
               out.data_ptr(), b, n, words,
               launch.blocks_for(b * words, threads), threads)
    launches += 1
    return out


def majx(planes: torch.Tensor, *, threads: int = 256) -> torch.Tensor:
    """Bulk MAJX over (N, ...) packed int32 planes -> (...), N odd."""
    launch.check_words("majx", planes, min_ndim=2)
    return majx_batch(planes.unsqueeze(0), threads=threads)[0]


def vote(replicas, *, threads: int = 256) -> torch.Tensor:
    """TMR/XMR vote over replicas of an arbitrary fixed-width tensor.

    Bitcasts each replica to packed words, majority-votes them with one
    MAJX launch, and bitcasts back.
    """
    shape, dtype = None, None
    stacked = []
    for rep in replicas:
        w, shape, dtype = bp.bitcast_to_planes(rep)
        stacked.append(w)
    voted = majx(torch.stack(stacked), threads=threads)
    return bp.bitcast_from_planes(voted, shape, dtype)


__all__ = ["majx", "majx_batch", "vote", "majx_ref"]
