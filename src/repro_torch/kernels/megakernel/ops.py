"""Host-side wrapper: run a MegaLowering against a bit-plane image.

:func:`run_lowering` builds the augmented image (three constant rows in
front of the program rows, see :mod:`repro_torch.compile.megakernel`),
launches ``csrc/megakernel.cu`` exactly once on it, and returns the
program rows.  On a CPU image it computes the same result with
:func:`~repro_torch.kernels.megakernel.ref.schedule_exec_ref`.
``launches`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.compile.megakernel import (MegaLowering, N_CONST_ROWS,
                                            ONE_ROW)
from repro_torch.core import bitplanes as bp
from repro_torch.kernels import launch
from repro_torch.kernels.megakernel.ref import schedule_exec_ref

#: Kernel launches made by this module since the count was last zeroed.
launches = 0

_ARGS = [launch.VOID_P] * 5 + [launch.I32] * 3 + [launch.I64, launch.I32,
                                                  launch.I32, launch.VOID_P]


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """A lowering's three level tables as int32 tensors on one device."""

    src: torch.Tensor
    dst: torch.Tensor
    inv: torch.Tensor


def upload_tables(lowering: MegaLowering, device) -> DeviceTables:
    """Copy a lowering's tables to ``device`` (once per lowering: the
    ``cuda`` backend caches the result by :meth:`MegaLowering.digest`)."""
    def put(a):
        return torch.as_tensor(a.astype("int32"), device=device).contiguous()
    return DeviceTables(put(lowering.src), put(lowering.dst),
                        put(lowering.inv))


def run_lowering(lowering: MegaLowering, state: torch.Tensor, *,
                 tables: Optional[DeviceTables] = None,
                 threads: int = 256) -> torch.Tensor:
    """Execute lowered level tables on a (rows, words) int32 image.

    One kernel launch regardless of level count.  Rows beyond what the
    lowering addresses ride along untouched; an empty lowering is the
    identity (a copy, no launch).  The caller's tensor is never written.
    """
    global launches
    launch.check_words("megakernel", state, min_ndim=2)
    if state.dim() != 2:
        raise ValueError(f"megakernel: state must be (rows, words), got "
                         f"{tuple(state.shape)}")
    rows, words = state.shape
    if lowering.n_levels == 0 or lowering.w_max == 0:
        return state.clone()
    if lowering.n_rows > rows:
        raise ValueError(
            f"lowering addresses {lowering.n_rows} rows but state has "
            f"only {rows}")
    for name, table in (("src", lowering.src), ("dst", lowering.dst)):
        if table.min() < 0 or table.max() >= rows + N_CONST_ROWS:
            raise ValueError(f"lowering {name} table indexes outside the "
                             f"{rows + N_CONST_ROWS}-row augmented image")
    if launch.on_cpu(state):
        return schedule_exec_ref(lowering, state)

    if tables is None:
        tables = upload_tables(lowering, state.device)
    image = torch.empty((rows + N_CONST_ROWS, words), dtype=torch.int32,
                        device=state.device)
    image[:N_CONST_ROWS] = 0
    image[ONE_ROW] = bp.ONES
    image[N_CONST_ROWS:] = state
    scratch = torch.empty((lowering.w_max, words), dtype=torch.int32,
                          device=state.device)
    fn = launch.kernel("megakernel", "megakernel_launch", _ARGS)
    launch.run(fn, "megakernel", state.device, image.data_ptr(),
               scratch.data_ptr(), tables.src.data_ptr(),
               tables.dst.data_ptr(), tables.inv.data_ptr(),
               lowering.n_levels, lowering.w_max, lowering.x_max, words,
               launch.blocks_for(words, threads), threads)
    launches += 1
    return image[N_CONST_ROWS:]
