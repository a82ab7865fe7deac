"""Bit-serial add on packed planes or uint32 elements: the CUDA kernel's
wrapper.

On CUDA tensors :func:`bitserial_add` launches ``csrc/bitserial.cu``;
on CPU tensors it computes the same sums with :func:`~repro_torch.
kernels.bitserial.ref.bitserial_add_ref`.  ``launches`` counts kernel
launches, and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitplanes as bp
from repro_torch.kernels import launch
from repro_torch.kernels.bitserial.ref import bitserial_add_ref

#: Kernel launches made by this module since the count was last zeroed.
launches = 0

_ARGS = [launch.VOID_P, launch.VOID_P, launch.VOID_P, launch.I32,
         launch.I64, launch.I32, launch.I32, launch.I32, launch.VOID_P]


def bitserial_add(a_planes: torch.Tensor, b_planes: torch.Tensor, *,
                  threads: int = 256) -> torch.Tensor:
    """Ripple-carry sum of two (NBITS, ...) packed int32 plane stacks.

    Plane 0 is the least significant; any NBITS >= 1 and any trailing
    shape ((NBITS, C) or (NBITS, R, C) in the reference) are taken, and
    the carry out of the top plane is dropped.  Operands of unequal
    shape raise before any launch.  One kernel launch a call.
    """
    global launches
    a, b = a_planes, b_planes
    launch.check_words("bitserial_add", a, min_ndim=2)
    launch.check_words("bitserial_add", b, min_ndim=2)
    if a.shape != b.shape:
        raise ValueError(f"bitserial_add: operand shapes {tuple(a.shape)} "
                         f"and {tuple(b.shape)} must be equal")
    if a.device != b.device:
        raise ValueError(f"bitserial_add: operands on {a.device} and "
                         f"{b.device}")
    if a.shape[0] == 0:
        raise ValueError("bitserial_add: needs at least one bit-plane")
    if launch.on_cpu(a):
        return bitserial_add_ref(a, b)
    out = torch.empty_like(a)
    nbits, words = a.shape[0], a[0].numel()
    vec = words % 4 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (a, b, out))
    fn = launch.kernel("bitserial", "bitserial_add_launch", _ARGS)
    launch.run(fn, "bitserial_add", a.device, a.data_ptr(), b.data_ptr(),
               out.data_ptr(), nbits, words, int(vec),
               launch.blocks_for(words // 4 if vec else words, threads),
               threads)
    launches += 1
    return out


def add_u32(a: torch.Tensor, b: torch.Tensor, *,
            threads: int = 256) -> torch.Tensor:
    """Element-wise ``a + b`` mod 2**32 through the bit-plane kernel.

    ``a``/``b``: integer tensors of equal element count, read as uint32
    and flattened.  Returns a flat int32 tensor holding the uint32 sums.
    """
    a = torch.as_tensor(a).reshape(-1)
    b = torch.as_tensor(b).reshape(-1)
    if a.numel() != b.numel():
        raise ValueError(f"add_u32: {a.numel()} and {b.numel()} elements; "
                         "they must be equal")
    out = bitserial_add(bp.pack_uint_elements(a), bp.pack_uint_elements(b),
                        threads=threads)
    return bp.unpack_uint_elements(out, a.numel())


__all__ = ["bitserial_add", "add_u32", "bitserial_add_ref"]
