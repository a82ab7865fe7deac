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
any row holding a value is a valid source for that value forever.
Planes first seen as gate operands (packed inputs, ``const`` planes)
become *input rows* of the initial state image.  The Program is exact
for the operands it was traced on, and only for them: where two planes
happen to hold one value on those operands (in division, every traced
``no_borrow`` plane that is all zero, and the constant 0), a later gate
reads either row, so on other operands it reads the wrong one.

:func:`compile_op` traces the same constructions on *symbols* instead:
every plane is one integer naming the row that holds it (``const(0)``
and ``const(-1)`` name the constant rows), and BitSerial never branches
on a plane's value, so its Program depends on nothing but the op, the
tier and the activation count, and runs on any operands.

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

from repro_torch import obs
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
        return _unpack_rows(final_state, self.out_rows, self.n_lanes)


def _unpack_rows(final_state, out_rows, n_lanes: int) -> torch.Tensor:
    """The ``n_lanes`` uint32 elements (int32 tensor) whose bit-planes an
    executed image holds in ``out_rows``; the rows' index goes to the
    image's device on every call (``backend.index_uploads``)."""
    if isinstance(final_state, np.ndarray):
        final_state = bp.from_u32(final_state, "cpu")
    obs.count("backend.index_uploads")
    rows = torch.as_tensor(out_rows, dtype=torch.int64,
                           device=final_state.device)
    return bp.unpack_uint_elements(final_state[rows], n_lanes)


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


class _SymbolTracer:
    """GateExecutor on symbolic planes: a plane is a one-element int64
    tensor naming its row; every gate output gets a fresh symbol and a
    fresh (SSA) row.  The constant planes BitSerial makes (``0`` and
    ``-1``, from ``full_like``) name the constant rows, allocated at
    their first use; any other symbol this tracer did not hand out is
    refused."""

    def __init__(self):
        self.program = Program()
        self.n_rows = 0
        self.rows: dict[int, int] = {}
        self.consts: dict[int, int] = {}     # row -> uint32 word

    def plane(self) -> torch.Tensor:
        """A new symbol, on a new row."""
        sym = self.n_rows + 1          # never 0 or -1, the constants
        self.rows[sym] = self.n_rows
        self.n_rows += 1
        return torch.tensor([sym], dtype=torch.int64)

    def row_of(self, plane: torch.Tensor) -> int:
        sym = int(plane.item())
        row = self.rows.get(sym)
        if row is None:
            if sym not in (0, bp.ONES):
                raise ValueError(f"plane {sym} was not made by the tracer")
            row = self.rows[sym] = self.n_rows
            self.n_rows += 1
            self.consts[row] = 0 if sym == 0 else 0xFFFFFFFF
        return row

    def _gate(self, kind: str, planes, **fields) -> torch.Tensor:
        srcs = tuple(self.row_of(p) for p in planes)
        out = self.plane()
        self.program.emit(kind, srcs=srcs, dsts=(self.n_rows - 1,),
                          **fields)
        return out

    def gate_maj(self, planes: Sequence[torch.Tensor], x: int,
                 n_act: int) -> torch.Tensor:
        return self._gate("MAJ", planes, x=x, n_act=n_act)

    def gate_not(self, p: torch.Tensor) -> torch.Tensor:
        return self._gate("NOT", (p,))


@dataclasses.dataclass(frozen=True)
class CompiledOp:
    """A §8.1 op compiled once for any operands (:func:`compile_op`).

    Rows ``a_rows[i]`` and ``b_rows[i]`` take bit-plane ``i`` of the
    operands, each row of ``consts`` its uint32 word; every other row is
    a gate output, written by its op.  After the Program runs,
    ``out_rows[i]`` holds bit-plane ``i`` of the result.
    """

    op: str
    program: Program
    n_rows: int
    a_rows: tuple[int, ...]
    b_rows: tuple[int, ...]
    consts: dict[int, int]
    out_rows: tuple[int, ...]

    def image(self, a, b) -> torch.Tensor:
        """The initial (n_rows, words) int32 image for uint32 operands
        ``a`` and ``b`` (equal lengths), on ``a``'s device if a tensor."""
        device = a.device if isinstance(a, torch.Tensor) else "cpu"
        a, b = elements(a, device), elements(b, device)
        if a.shape != b.shape:
            raise ValueError(f"operands of {a.numel()} and {b.numel()} "
                             f"elements")
        A, B = bp.pack_uint_elements(a), bp.pack_uint_elements(b)
        image = torch.zeros((self.n_rows, A.shape[-1]), dtype=torch.int32,
                            device=A.device)
        image[list(self.a_rows)] = A
        image[list(self.b_rows)] = B
        for row, word in self.consts.items():
            image[row] = word - 2**32 if word >= 2**31 else word
        return image

    def outputs(self, final_state, n_lanes: int) -> torch.Tensor:
        """The ``n_lanes`` uint32 results (int32 tensor) of an executed
        image, as :meth:`CompiledProgram.outputs` unpacks them."""
        return _unpack_rows(final_state, self.out_rows, n_lanes)


def compile_op(op: str, tier: int = 3, n_act: int = 4) -> CompiledOp:
    """Compile §8.1 microbenchmark ``op`` once, for any operands.

    The constructions are :func:`compile_elementwise`'s (the same op
    histogram), traced on symbols rather than on values, so the Program
    depends on ``(op, tier, n_act)`` alone.  The span ``trace.compile_op``
    (:mod:`repro_torch.obs`) is the whole call.
    """
    with obs.span("trace.compile_op"):
        tracer = _SymbolTracer()
        A = torch.cat([tracer.plane() for _ in range(32)])[:, None]
        B = torch.cat([tracer.plane() for _ in range(32)])[:, None]
        bs = BitSerial(tier=tier, n_act=n_act, executor=tracer)
        out = build_op(bs, op, A, B)
        a_rows, b_rows, out_rows = (tuple(tracer.row_of(p) for p in x)
                                    for x in (A, B, out))
        return CompiledOp(op, tracer.program, tracer.n_rows, a_rows,
                          b_rows, dict(tracer.consts), out_rows)
