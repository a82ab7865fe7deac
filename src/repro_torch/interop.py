"""Carry the reference package's artefacts across into the port.

The JAX reference and this port compute the same thing on the same
state.  What crosses between them is plain data — JSON and numpy arrays
— so this module imports neither JAX nor the reference package:

* :func:`program_from_json` — a ``Program.to_json`` string;
* :func:`lowering_from_arrays` — a ``MegaLowering``'s tables;
* :func:`context_from_dict` — ``dataclasses.asdict`` of an
  ``ExecutionContext``;
* :func:`state_to_device` / :func:`state_to_numpy` — a ``uint32``
  (rows, words) image to and from the port's int32 tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.backends.context import ExecutionContext, Timings
from repro_torch.compile.megakernel import MegaLowering
from repro_torch.core.bitplanes import from_u32 as state_to_device  # noqa
from repro_torch.core.bitplanes import to_u32 as state_to_numpy  # noqa
from repro_torch.pud.isa import Program

#: The reference context's TPU execution knobs, which have no meaning
#: here and are dropped.
TPU_KNOBS = ("interpret", "block_r", "block_c", "vmem_budget_bytes")


def program_from_json(text: str) -> Program:
    """The Program a ``Program.to_json`` string describes."""
    return Program.from_json(text)


def lowering_from_arrays(src, dst, inv, n_rows: int,
                         level_meta) -> MegaLowering:
    """A MegaLowering from the reference's table arrays.

    The tables keep the reference's dtypes (int32 / int32 / uint32), so
    :meth:`MegaLowering.digest` is byte-identical to the reference's.
    """
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    inv = np.asarray(inv, np.uint32)
    if src.ndim != 3 or dst.shape != src.shape[:2] or inv.shape != dst.shape:
        raise ValueError(f"table shapes disagree: src {src.shape}, dst "
                         f"{dst.shape}, inv {inv.shape}")
    return MegaLowering(src=src, dst=dst, inv=inv, n_rows=int(n_rows),
                        level_meta=tuple(tuple(int(c) for c in m)
                                         for m in level_meta))


def context_from_dict(d: dict) -> ExecutionContext:
    """The port's ExecutionContext for a reference context's fields.

    Regime fields carry over unchanged; the reference's TPU knobs
    (:data:`TPU_KNOBS`) are dropped, and any other unknown field raises.
    ``device`` / ``threads_per_block`` may be given too.
    """
    fields = {f.name for f in dataclasses.fields(ExecutionContext)}
    kw = {k: v for k, v in d.items() if k not in TPU_KNOBS}
    unknown = set(kw) - fields
    if unknown:
        raise ValueError(f"unknown ExecutionContext fields {sorted(unknown)}")
    if isinstance(kw.get("timings"), dict):
        kw["timings"] = Timings(**kw["timings"])
    return ExecutionContext(**kw)
