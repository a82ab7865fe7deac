"""Bit-plane transpose of uint32 elements: the CUDA kernels' wrappers.

On CUDA tensors :func:`pack_uint_elements` and
:func:`unpack_uint_elements` launch ``csrc/bitplanes.cu``, one launch a
call; on CPU tensors they compute the same planes and elements with
:mod:`~repro_torch.kernels.bitplanes.ref`.  ``launches`` counts kernel
launches, and nothing else.  :mod:`repro_torch.core.bitplanes` routes
its public functions of the same names here.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import bitplanes as bp
from repro_torch.kernels import launch
from repro_torch.kernels.bitplanes.ref import (pack_uint_elements_ref,
                                               unpack_uint_elements_ref)

#: Kernel launches made by this module since the count was last zeroed.
launches = 0

_PACK_ARGS = [launch.VOID_P, launch.VOID_P, launch.I64, launch.I64,
              launch.I32, launch.I32, launch.I32, launch.VOID_P]
_UNPACK_ARGS = [launch.VOID_P, launch.VOID_P, launch.I64, launch.I64,
                launch.I64, launch.I32, launch.I32, launch.I32,
                launch.VOID_P]

#: Threads a block (the kernels' kWarps warps); a warp takes one tile of
#: :data:`TILE` elements.
THREADS = 256
TILE = 1024


def blocks(batch: int, k: int) -> int:
    """Blocks of one launch: a warp a tile of :data:`TILE` elements of
    one row, ``batch`` rows of ``k`` (a grid-stride loop beyond)."""
    return launch.blocks_for(batch * -(-k // TILE) * 32, THREADS)


def pack_uint_elements(x: torch.Tensor, n_bits: int = 32) -> torch.Tensor:
    """(..., k) integers, read as ``uint32`` -> (..., n_bits,
    ceil(k/32)) int32 planes; see
    :func:`repro_torch.core.bitplanes.pack_uint_elements`.

    On the card a non-int32 input is wrapped to int32 and a
    non-contiguous one made contiguous first; the output is filled by
    the kernel alone.  An empty output launches nothing.
    """
    global launches
    x = torch.as_tensor(x)
    if x.dim() < 1:
        raise ValueError("pack_uint_elements: needs (..., k) elements, "
                         "got a 0-d tensor")
    if n_bits < 1:
        raise ValueError(f"pack_uint_elements: n_bits must be >= 1, "
                         f"got {n_bits}")
    if launch.on_cpu(x):
        return pack_uint_elements_ref(x, n_bits)
    if x.dtype != torch.int32:
        x = bp.wrap_i32(x.to(torch.int64) & 0xFFFFFFFF)
    x = x.contiguous()
    k = x.shape[-1]
    out = torch.empty((*x.shape[:-1], n_bits, bp.n_words(k)),
                      dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    batch = math.prod(x.shape[:-1])
    vec = k % 4 == 0 and x.data_ptr() % 16 == 0
    fn = launch.kernel("bitplanes", "pack_uint_elements_launch", _PACK_ARGS)
    launch.run(fn, "pack_uint_elements", x.device, x.data_ptr(),
               out.data_ptr(), batch, k, n_bits, int(vec), blocks(batch, k))
    launches += 1
    return out


def unpack_uint_elements(planes: torch.Tensor, k: int) -> torch.Tensor:
    """(..., n_planes, words) int32 planes -> (..., k) int32 elements,
    ``k <= 32 * words``; see
    :func:`repro_torch.core.bitplanes.unpack_uint_elements`.

    On the card a non-contiguous input is made contiguous first; the
    output is filled by the kernel alone.  An empty output launches
    nothing.
    """
    global launches
    if planes.dim() < 2:
        raise ValueError(f"unpack_uint_elements: needs (..., n_planes, "
                         f"words) planes, got {tuple(planes.shape)}")
    k = int(k)
    words = planes.shape[-1]
    if not 0 <= k <= words * bp.WORD_BITS:
        raise ValueError(f"unpack_uint_elements: k must lie in [0, "
                         f"{words * bp.WORD_BITS}] for {words} words a "
                         f"plane, got {k}")
    if launch.on_cpu(planes):
        return unpack_uint_elements_ref(planes, k)
    planes = planes.contiguous()
    launch.check_words("unpack_uint_elements", planes, min_ndim=2)
    out = torch.empty((*planes.shape[:-2], k), dtype=torch.int32,
                      device=planes.device)
    if out.numel() == 0:
        return out
    batch = math.prod(planes.shape[:-2])
    vec = k % 4 == 0 and out.data_ptr() % 16 == 0
    fn = launch.kernel("bitplanes", "unpack_uint_elements_launch",
                       _UNPACK_ARGS)
    launch.run(fn, "unpack_uint_elements", planes.device, planes.data_ptr(),
               out.data_ptr(), batch, k, words, planes.shape[-2], int(vec),
               blocks(batch, k))
    launches += 1
    return out


__all__ = ["pack_uint_elements", "unpack_uint_elements",
           "pack_uint_elements_ref", "unpack_uint_elements_ref"]
