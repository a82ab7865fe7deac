"""Majority-based bit-serial arithmetic (paper §8.1).

The paper's case study implements 32-bit AND/OR/XOR/ADD/SUB/MUL/DIV with
MAJX operations and evaluates how the new MAJ5/MAJ7/MAJ9 primitives speed
them up over the MAJ3-only state of the art.  This module is both the
*functional* implementation (exact boolean results on packed bit-planes,
tested against numpy integer arithmetic) and the *compiler* (every gate is
recorded into a :class:`~repro_torch.pud.isa.Program` for latency/energy
costing).  Its constructions are the reference package's, gate for gate,
so the recorded op streams are identical.

Planes are int32 tensors holding uint32 words (see
:mod:`repro_torch.core.bitplanes`): the all-ones constant is ``-1``.

Gate constructions (all standard majority-logic identities):

* ``AND_k(x1..xk)  = MAJ(2k-1)(x1..xk, 0 * (k-1))``
* ``OR_k(x1..xk)   = MAJ(2k-1)(x1..xk, 1 * (k-1))``
* ``NOT``            is a complement-row copy (RowClone through the dual
  row, Ambit-style); complements of inputs can be *staged once* and reused.
* full adder:   ``c' = MAJ3(a,b,c)``;  ``s = MAJ5(a,b,c,~c',~c')``
  (the MAJ5 *input-replication* identity: s=1 iff a+b+c in {1,3}).
* two-position carry skip:  ``c_{i+2} = MAJ7(a_{i+1},a_{i+1},b_{i+1},
  b_{i+1},a_i,b_i,c_i)`` (weights 2,2,1,1,1 — again via input replication).

Tiers: ``tier=3`` restricts gates to MAJ3 (the FracDRAM/ComputeDRAM
state-of-the-art baseline the paper compares against); ``tier=5/7/9``
unlock the wider gates demonstrated by the paper.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from repro_torch.core import bitplanes as bp
from repro_torch.core import calibration as cal
from repro_torch.pud.isa import Program

Plane = torch.Tensor  # int32[W]


class GateExecutor(Protocol):
    """How a recorded gate actually computes its result.

    The bit-serial compiler below emits the *same* Program regardless of
    the executor; backends (:mod:`repro_torch.backends`) and sessions
    inject themselves here so one compiled §8.1 program runs through the
    plain ``oracle`` or the CUDA kernels interchangeably.
    """

    def gate_maj(self, planes: Sequence[Plane], x: int, n_act: int) -> Plane:
        ...

    def gate_not(self, p: Plane) -> Plane:
        ...


def _maj_planes(planes: Sequence[Plane]) -> Plane:
    if len(planes) == 3:
        return bp.maj3_words(*planes)
    return bp.majority_words(torch.stack(list(planes)))


@dataclasses.dataclass
class BitSerial:
    """Bit-serial execution context: gates compute *and* get recorded."""

    tier: int = 3          # largest MAJ arity available (3/5/7/9)
    n_act: int = 4         # simultaneous activation count per MAJ issue
    program: Program = dataclasses.field(default_factory=Program)
    #: Optional gate executor (see :class:`GateExecutor`); None = logical.
    executor: Optional[GateExecutor] = None

    def __post_init__(self):
        if self.tier not in (3, 5, 7, 9):
            raise ValueError("tier must be one of 3/5/7/9")

    # ------------------------------------------------------------- gates
    def maj(self, *planes: Plane, tag: str = "") -> Plane:
        x = len(planes)
        if x % 2 == 0 or x < 3:
            raise ValueError("MAJ arity must be odd >= 3")
        if x > self.tier:
            raise ValueError(f"MAJ{x} exceeds tier {self.tier}")
        # N-row activation must be a reachable level (2/4/8/16/32) >= X.
        n_act = cal.min_activation_for(max(self.n_act, x))
        self.program.emit("MAJ", x=x, n_act=n_act, tag=tag)
        if self.executor is not None:
            return self.executor.gate_maj(planes, x, n_act)
        return _maj_planes(planes)

    def not_(self, p: Plane, tag: str = "") -> Plane:
        self.program.emit("NOT", tag=tag)
        if self.executor is not None:
            return self.executor.gate_not(p)
        return ~p

    def const(self, value: int, like: Plane) -> Plane:
        return torch.full_like(like, bp.ONES if value else 0)

    def and_(self, *ps: Plane, tag: str = "and") -> Plane:
        """k-ary AND, fused into the widest available MAJ gate."""
        ps = list(ps)
        while len(ps) > 1:
            k_max = (self.tier + 1) // 2  # widest AND arity per gate
            k = min(len(ps), k_max)
            group, ps = ps[:k], ps[k:]
            if k == 1:
                ps.append(group[0])
                continue
            zeros = [self.const(0, group[0])] * (k - 1)
            ps.insert(0, self.maj(*group, *zeros, tag=tag))
        return ps[0]

    def or_(self, *ps: Plane, tag: str = "or") -> Plane:
        ps = list(ps)
        while len(ps) > 1:
            k_max = (self.tier + 1) // 2
            k = min(len(ps), k_max)
            group, ps = ps[:k], ps[k:]
            if k == 1:
                ps.append(group[0])
                continue
            ones = [self.const(1, group[0])] * (k - 1)
            ps.insert(0, self.maj(*group, *ones, tag=tag))
        return ps[0]

    def xor(self, a: Plane, b: Plane, tag: str = "xor") -> Plane:
        """XOR = AND(OR(a,b), NAND(a,b)) — 3 MAJ + 1 NOT."""
        o = self.or_(a, b, tag=tag)
        na = self.not_(self.and_(a, b, tag=tag), tag=tag)
        return self.and_(o, na, tag=tag)

    def mux(self, sel: Plane, x: Plane, y: Plane, tag: str = "mux") -> Plane:
        """sel ? x : y = OR(AND(x, sel), AND(y, ~sel))."""
        nsel = self.not_(sel, tag=tag)
        return self.or_(self.and_(x, sel, tag=tag),
                        self.and_(y, nsel, tag=tag), tag=tag)

    # ------------------------------------------------------------ adders
    def full_adder(self, a: Plane, b: Plane, c: Plane, tag: str = "fa"
                   ) -> tuple[Plane, Plane]:
        """Returns (sum, carry_out) using the tier's best construction."""
        if self.tier >= 5:
            cout = self.maj(a, b, c, tag=f"{tag}/carry")
            ncout = self.not_(cout, tag=f"{tag}/ncarry")
            s = self.maj(a, b, c, ncout, ncout, tag=f"{tag}/sum5")
            return s, cout
        cout = self.maj(a, b, c, tag=f"{tag}/carry")
        s = self.xor(self.xor(a, b, tag=f"{tag}/x1"), c, tag=f"{tag}/x2")
        return s, cout

    def carry_skip2(self, a1, b1, a0, b0, c0, tag="skip") -> Plane:
        """c2 = MAJ7(a1,a1,b1,b1,a0,b0,c0) — requires tier >= 7.

        tier 9 maps the gate to MAJ9 by padding one all-0 and one all-1
        row (MAJ9(x.., 0, 1) == MAJ7(x..)) — the widest-gate compiler
        policy whose poor MAJ9 success rate on Mfr H reproduces the
        paper's Fig 16 degradation.
        """
        if self.tier >= 9:
            zero = self.const(0, a1)
            one = self.const(1, a1)
            return self.maj(a1, a1, b1, b1, a0, b0, c0, zero, one, tag=tag)
        return self.maj(a1, a1, b1, b1, a0, b0, c0, tag=tag)

    def add(self, A: torch.Tensor, B: torch.Tensor,
            cin: Optional[Plane] = None, tag: str = "add",
            ) -> tuple[torch.Tensor, Plane]:
        """Ripple add of two bit-plane numbers, shape (nbits, W).

        tier>=7 computes every second carry with the MAJ7 two-position skip,
        halving the *sequential* carry depth (subarray-level parallelism;
        op count matches the MAJ5 construction).
        Returns (sum planes, carry_out plane).
        """
        nbits = A.shape[0]
        c = cin if cin is not None else self.const(0, A[0])
        sums = []
        i = 0
        while i < nbits:
            if self.tier >= 7 and i + 1 < nbits:
                c1 = self.maj(A[i], B[i], c, tag=f"{tag}/c[{i}]")
                c2 = self.carry_skip2(A[i + 1], B[i + 1], A[i], B[i], c,
                                      tag=f"{tag}/cskip[{i+1}]")
                nc1 = self.not_(c1, tag=tag)
                nc2 = self.not_(c2, tag=tag)
                sums.append(self.maj(A[i], B[i], c, nc1, nc1,
                                     tag=f"{tag}/s[{i}]"))
                sums.append(self.maj(A[i + 1], B[i + 1], c1, nc2, nc2,
                                     tag=f"{tag}/s[{i+1}]"))
                c = c2
                i += 2
            else:
                s, c = self.full_adder(A[i], B[i], c, tag=f"{tag}[{i}]")
                sums.append(s)
                i += 1
        return torch.stack(sums), c

    def neg_planes(self, B: torch.Tensor, tag: str = "neg") -> torch.Tensor:
        return torch.stack([self.not_(B[i], tag=tag)
                            for i in range(B.shape[0])])

    def sub(self, A: torch.Tensor, B: torch.Tensor, tag: str = "sub"
            ) -> tuple[torch.Tensor, Plane]:
        """A - B (two's complement).  carry_out == 1 iff A >= B (no borrow)."""
        nB = self.neg_planes(B, tag=f"{tag}/not")
        one = self.const(1, A[0])
        return self.add(A, nB, cin=one, tag=tag)

    def mul(self, A: torch.Tensor, B: torch.Tensor,
            tag: str = "mul") -> torch.Tensor:
        """Low ``nbits`` of A*B via shift-and-add partial products."""
        nbits = A.shape[0]
        zero = self.const(0, A[0])
        acc = torch.stack([zero] * nbits)
        for i in range(nbits):
            # Partial product: (A << i) & b_i, restricted to low nbits.
            pp = [self.and_(A[j], B[i], tag=f"{tag}/pp[{i},{j}]")
                  for j in range(nbits - i)]
            pp_planes = torch.stack([zero] * i + pp)
            # Accumulate only the live positions.
            hi, _ = self.add(acc[i:], pp_planes[i:], tag=f"{tag}/acc[{i}]")
            acc = torch.cat([acc[:i], hi], dim=0)
        return acc

    def div(self, A: torch.Tensor, B: torch.Tensor, tag: str = "div"
            ) -> tuple[torch.Tensor, torch.Tensor]:
        """Unsigned restoring division: returns (quotient, remainder).

        Divide-by-zero lanes return Q=all-ones, R=A (hardware convention).
        """
        nbits = A.shape[0]
        zero = self.const(0, A[0])
        # Remainder is nbits+1 wide to absorb the shift before compare.
        R = torch.stack([zero] * (nbits + 1))
        Bx = torch.cat([B, zero[None]], dim=0)
        q = []
        for step in range(nbits - 1, -1, -1):
            # R = (R << 1) | a_step
            R = torch.cat([A[step][None], R[:-1]], dim=0)
            diff, no_borrow = self.sub(R, Bx, tag=f"{tag}/cmp[{step}]")
            q.append(no_borrow)
            R = torch.stack([
                self.mux(no_borrow, diff[i], R[i], tag=f"{tag}/sel[{step}]")
                for i in range(nbits + 1)
            ])
        Q = torch.stack(list(reversed(q)))
        return Q, R[:nbits]


# ---------------------------------------------------------------------------
# element-level convenience API (uint32 vectors <-> planes)
# ---------------------------------------------------------------------------

OPS = ("and", "or", "xor", "add", "sub", "mul", "div")


def elements(x, device="cpu") -> torch.Tensor:
    """uint32 elements as a flat int32 tensor on ``device``: a numpy
    array (or sequence) is read as ``uint32``; a tensor keeps its bits
    (see :func:`repro_torch.core.bitplanes.pack_uint_elements`)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).to(device)
    return bp.from_u32(np.asarray(x, np.uint32).reshape(-1), device)


def build_op(bs: BitSerial, op: str, A: torch.Tensor,
             B: torch.Tensor) -> torch.Tensor:
    """The result planes of §8.1 microbenchmark ``op`` on planes A, B."""
    if op == "and":
        return torch.stack([bs.and_(A[i], B[i]) for i in range(A.shape[0])])
    if op == "or":
        return torch.stack([bs.or_(A[i], B[i]) for i in range(A.shape[0])])
    if op == "xor":
        return torch.stack([bs.xor(A[i], B[i]) for i in range(A.shape[0])])
    if op == "add":
        return bs.add(A, B)[0]
    if op == "sub":
        return bs.sub(A, B)[0]
    if op == "mul":
        return bs.mul(A, B)
    if op == "div":
        return bs.div(A, B)[0]
    raise ValueError(f"unknown op {op!r}")


def _executor_device(executor) -> str:
    """Where an executor computes: its context's device (backends and
    sessions), else the CPU."""
    ctx = getattr(executor, "ctx", None)
    return getattr(ctx, "device", "cpu")


def run_elementwise(op: str, a, b, tier: int = 3, n_act: int = 4,
                    executor: Optional[GateExecutor] = None,
                    ) -> tuple[torch.Tensor, Program]:
    """Run a §8.1 microbenchmark op over uint32 element vectors.

    Returns (int32 tensor of the uint32 results, recorded Program).
    ``a``/``b`` may be any shape; they are flattened into bit-serial
    lanes.  ``executor`` selects where each recorded gate computes
    (default: the logical oracle): a backend, or — the session-API entry
    point — a :class:`repro_torch.session.DramSession` (what
    ``DramSession.elementwise`` passes).

    Executors with native batch dispatch (``cuda``) take the *fused*
    path: the gate stream is first lowered to an addressed Program
    (:func:`repro_torch.compile.compile_elementwise`) and then executed
    in level-batched kernel launches via ``executor.run_fused`` — the
    values still come from that executor's kernels, and the returned
    Program additionally carries row addresses (same op histogram as
    the per-gate recording).  When the executor is a session, that
    ``run_fused`` resolves through its content-hashed compile cache, so
    re-running a traced program (same op/tier/width) skips
    re-scheduling.
    """
    caps = getattr(executor, "capabilities", None)
    if caps is not None and executor.capabilities().native_batch:
        from repro_torch.compile.trace import compile_elementwise

        cp = compile_elementwise(op, a, b, tier=tier, n_act=n_act)
        final = executor.run_fused(cp.program, cp.state)
        return cp.outputs(final), cp.program

    device = _executor_device(executor)
    a, b = elements(a, device), elements(b, device)
    ctx = BitSerial(tier=tier, n_act=n_act, executor=executor)
    out = build_op(ctx, op, bp.pack_uint_elements(a),
                   bp.pack_uint_elements(b))
    return bp.unpack_uint_elements(out, a.shape[0]), ctx.program
