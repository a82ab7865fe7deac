"""Carry the reference package's artefacts across into the port.

The JAX reference and this port compute the same thing on the same
state.  What crosses between them is plain data — JSON and numpy arrays
— so this module imports neither JAX nor the reference package:

* :func:`program_from_json` — a ``Program.to_json`` string;
* :func:`lowering_from_arrays` — a ``MegaLowering``'s tables;
* :func:`context_from_dict` — ``dataclasses.asdict`` of an
  ``ExecutionContext``;
* :func:`compiled_program_from` — a traced §8.1 ``CompiledProgram``
  (its Program's JSON, image, output rows and lane count);
* :func:`state_to_device` / :func:`state_to_numpy` — a ``uint32``
  (rows, words) image to and from the port's int32 tensors;
* :func:`params_from_jax` / :func:`params_to_numpy` — a model's
  parameter tree (numpy arrays, bfloat16 ones included) to and from the
  port's tensors;
* :func:`train_state_from_jax` / :func:`train_state_to_numpy` — a
  training state (params, AdamW state with its int32 step, error
  feedback) to and from the port's ``TrainState``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.backends.context import ExecutionContext, Timings
from repro_torch.compile.megakernel import MegaLowering
from repro_torch.compile.trace import CompiledProgram
from repro_torch.core import tree as tree_util
from repro_torch.core.bitplanes import from_u32 as state_to_device  # noqa
from repro_torch.core.bitplanes import to_u32 as state_to_numpy  # noqa
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.compression import ErrorFeedback
from repro_torch.pud.isa import Program
from repro_torch.train.step import TrainState

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


def compiled_program_from(program_json: str, state, out_rows,
                          n_lanes: int) -> CompiledProgram:
    """The port's CompiledProgram for a reference one's parts: its
    ``program.to_json()``, its (rows, words) ``uint32`` image, its
    ``out_rows`` and ``n_lanes``."""
    state = np.ascontiguousarray(state, dtype=np.uint32)
    if state.ndim != 2:
        raise ValueError(f"state must be a (rows, words) image, got shape "
                         f"{state.shape}")
    out_rows = tuple(int(r) for r in out_rows)
    if any(not 0 <= r < state.shape[0] for r in out_rows):
        raise ValueError(f"out_rows {out_rows} outside the image's "
                         f"{state.shape[0]} rows")
    return CompiledProgram(program_from_json(program_json), state,
                           out_rows, int(n_lanes))


def _leaf_to_tensor(leaf, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart numpy knows:
        # carry the bits.
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree, device="cuda"):
    """The port's parameter tree (tensors on ``device``) for a reference
    one whose leaves are numpy arrays (``np.asarray`` of each jax
    array); bfloat16 leaves are taken by their bits, without
    ``ml_dtypes``."""
    leaves, structure = tree_util.flatten(tree)
    return tree_util.unflatten(
        structure, [_leaf_to_tensor(x, device) for x in leaves])


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only where a bfloat16 array is asked for

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(tree):
    """The inverse of :func:`params_from_jax`: a tree of numpy arrays
    (bfloat16 leaves as ``ml_dtypes.bfloat16``, as ``np.asarray`` of a
    jax array gives them)."""
    leaves, structure = tree_util.flatten(tree)
    return tree_util.unflatten(structure,
                               [_leaf_to_numpy(x) for x in leaves])


def train_state_from_jax(state, device="cuda") -> TrainState:
    """The port's ``TrainState`` on ``device`` for a reference one whose
    leaves are numpy arrays (``jax.tree.map(np.asarray, state)``): its
    ``(params, (step, m, v, master), (residual,))``, bfloat16 leaves
    taken by their bits and the step kept ``int32``."""
    params, (step, m, v, master), (residual,) = state
    return TrainState(
        params=params_from_jax(params, device),
        opt=AdamWState(step=_leaf_to_tensor(step, device),
                       m=params_from_jax(m, device),
                       v=params_from_jax(v, device),
                       master=params_from_jax(master, device)),
        feedback=ErrorFeedback(params_from_jax(residual, device)))


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The inverse of :func:`train_state_from_jax`: the same
    ``TrainState`` of numpy arrays (bfloat16 leaves as
    ``ml_dtypes.bfloat16``)."""
    return params_to_numpy(state)
