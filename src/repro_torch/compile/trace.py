"""Lower BitSerial gate streams to addressed, fusable Programs.

The §8.1 bit-serial compiler (:class:`repro_torch.pud.arith.BitSerial`)
records cost-only ops while computing on whatever planes flow through
it.  The :class:`Tracer` here is a :class:`~repro_torch.pud.arith.
GateExecutor` that additionally assigns every gate a *row address*:
operands resolve to rows of a growing subarray image, each gate output
gets a fresh (SSA) row, and the emitted :class:`~repro_torch.pud.isa.
Program` carries full ``srcs``/``dsts`` — executable by any backend and
fusable by :mod:`repro_torch.compile.schedule`.

Rows are keyed by plane *value*.  BitSerial freely reshapes, stacks and
re-indexes planes (``torch.stack(sums)``, ``acc[i:]``), destroying object
identity but never values; because traced rows are written exactly once,
any row holding a value is a valid source for that value forever, so
value-keying is exact.  Planes first seen as gate operands (packed inputs,
``const`` planes) become *input rows* of the initial state image.

The key is a SHA-256 digest of the plane's bytes, where the reference
package keys by the bytes themselves: at 2**18 words a plane those are a
MiB per gate, which a multiplier's two thousand gates would hold on the
host.  The Program, the image and the output rows are the
reference's.  The tracer computes gate values on the CPU: they serve
only as keys, and the backend that runs the Program computes its own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bitplanes as bp
from repro_torch.pud.arith import BitSerial, build_op, elements
from repro_torch.pud.isa import Program


def _cpu(plane: torch.Tensor) -> torch.Tensor:
    """A plane as a contiguous int32 CPU tensor."""
    return plane.to("cpu").contiguous()


class Tracer:
    """GateExecutor assigning SSA row addresses while computing oracle
    gate values (the recorded Program is then *re*-executed by a real
    backend, so traced values never leak into backend results)."""

    def __init__(self):
        self.program = Program()
        #: initial value per row; None for gate outputs (written by ops).
        self._init: list[Optional[np.ndarray]] = []
        self._table: dict[bytes, int] = {}
        #: Digest of a plane object seen before, by ``id``: BitSerial
        #: hands the same carry, complement or operand object to several
        #: gates, and its bytes are hashed once.  The weak reference and
        #: the version counter make an entry count only for the same,
        #: unmodified object.
        self._seen: dict[int, tuple[weakref.ref, int, bytes]] = {}

    # ------------------------------------------------------------- rows
    def _key(self, plane: torch.Tensor) -> bytes:
        hit = self._seen.get(id(plane))
        if hit is not None and hit[0]() is plane and hit[1] == plane._version:
            return hit[2]
        key = hashlib.sha256(_cpu(plane).numpy()).digest()
        self._seen[id(plane)] = (weakref.ref(plane), plane._version, key)
        return key

    @property
    def n_rows(self) -> int:
        return len(self._init)

    def row_of(self, plane) -> int:
        """Row holding ``plane``'s value (allocating an input row if the
        value was never produced by a traced gate)."""
        key = self._key(plane)
        row = self._table.get(key)
        if row is None:
            row = len(self._init)
            self._init.append(bp.to_u32(_cpu(plane)).copy())
            self._table[key] = row
        return row

    def _alloc_output(self, value) -> int:
        row = len(self._init)
        self._init.append(None)
        # Map the value to its newest row: both old and new rows hold it
        # once written (rows are SSA), so either is a valid source.
        self._table[self._key(value)] = row
        return row

    def initial_state(self) -> np.ndarray:
        """(rows, words) uint32 image: input rows hold their traced
        values, gate-output rows start zeroed (their ops overwrite)."""
        width = 0
        for v in self._init:
            if v is not None:
                width = int(v.shape[-1])
                break
        state = np.zeros((len(self._init), width), np.uint32)
        for r, v in enumerate(self._init):
            if v is not None:
                state[r] = v
        return state

    # --------------------------------------------- GateExecutor protocol
    def gate_maj(self, planes: Sequence[torch.Tensor], x: int,
                 n_act: int) -> torch.Tensor:
        srcs = tuple(self.row_of(p) for p in planes)
        cpu = [_cpu(p) for p in planes]
        out = bp.maj3_words(*cpu) if len(cpu) == 3 else \
            bp.majority_words(torch.stack(cpu))
        dst = self._alloc_output(out)
        self.program.emit("MAJ", x=x, n_act=n_act, srcs=srcs, dsts=(dst,))
        return out

    def gate_not(self, p: torch.Tensor) -> torch.Tensor:
        src = self.row_of(p)
        out = ~_cpu(p)
        dst = self._alloc_output(out)
        self.program.emit("NOT", srcs=(src,), dsts=(dst,))
        return out


@dataclasses.dataclass
class CompiledProgram:
    """A traced computation, ready for :meth:`Backend.run_fused`.

    ``state`` is the initial (rows, words) uint32 image; ``out_rows``
    index the rows holding the result planes after execution;
    ``n_lanes`` is the element count for unpacking elementwise results.
    """

    program: Program
    state: np.ndarray
    out_rows: tuple[int, ...]
    n_lanes: int

    def outputs(self, final_state) -> torch.Tensor:
        """Unpack the result planes of an executed image (an int32
        tensor, or a uint32 numpy image) into elements: an int32 tensor
        of uint32 values on the image's device (inverse of
        :func:`bitplanes.pack_uint_elements`)."""
        if isinstance(final_state, np.ndarray):
            final_state = bp.from_u32(final_state, "cpu")
        rows = torch.as_tensor(self.out_rows, dtype=torch.int64,
                               device=final_state.device)
        return bp.unpack_uint_elements(final_state[rows], self.n_lanes)


def trace_planes(build, tier: int, n_act: int) -> CompiledProgram:
    """Trace ``build(bs) -> output planes`` into a CompiledProgram.

    ``build`` receives a :class:`~repro_torch.pud.arith.BitSerial` wired
    to a fresh Tracer and returns the output planes ``(nbits, words)``;
    constructions are shared verbatim with the per-gate path, so the
    traced Program's histogram equals the cost-only recording.
    """
    tracer = Tracer()
    bs = BitSerial(tier=tier, n_act=n_act, executor=tracer)
    out = build(bs)
    out_rows = tuple(tracer.row_of(p) for p in out)
    return CompiledProgram(tracer.program, tracer.initial_state(),
                           out_rows, n_lanes=0)


def compile_elementwise(op: str, a, b, tier: int = 3, n_act: int = 4
                        ) -> CompiledProgram:
    """Compile a §8.1 elementwise microbenchmark to an addressed Program.

    Mirrors :func:`repro_torch.pud.arith.run_elementwise` (same
    constructions, same recorded op stream) but captures row addresses,
    so the returned program executes through :meth:`Backend.run_fused`
    in level-batched kernel launches instead of one launch per gate.
    The operands are packed and traced on the CPU, wherever they lie.
    """
    a, b = elements(a), elements(b)
    A = bp.pack_uint_elements(a)
    B = bp.pack_uint_elements(b)
    cp = trace_planes(lambda bs: build_op(bs, op, A, B), tier=tier,
                      n_act=n_act)
    cp.n_lanes = int(a.shape[0])
    return cp
