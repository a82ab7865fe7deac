"""32-bit division compiled once for any operands: one closed-loop client.

The §8.1 arithmetic driver (``drivers/arith.py``: its State, request,
window, release and check) with three changes:

* set-up compiles each op with ``repro_torch.compile.compile_op``, whose
  Program depends on the op, the tier and the activation count alone,
  and takes the operand and constant rows from it (the arith driver
  traces on sample operands and finds the rows by their values, which
  gives a division that is exact only on those operands);
* the divisor of each lane is ``u32 >> k``, k uniform on
  0..``DIVISOR_SHIFT_MAX`` (k = 32 gives 0), so the check meets
  quotients of every width and division by zero (the time a request
  takes does not depend on its data);
* every window opens ``repro_torch.obs.recording()`` and leaves its
  summary (spans and counters, see ``Recording``) in
  ``Record.counters["program"]`` for the program-span and
  program-counter readers.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

from port_bench.harness.spec import driver
from port_bench.harness.traffic import sub_seed

arith = driver({"driver": "arith"})
release, check, _u32 = arith.release, arith.check, arith._u32

#: The largest shift of a divisor ``u32 >> k``: 32 gives the divisor 0.
DIVISOR_SHIFT_MAX = 32


@dataclasses.dataclass
class Compiled:
    """A ``CompiledOp`` where the arith driver takes a compiled program:
    its Program, and its outputs at the run's width."""

    op: object          # repro_torch.compile.CompiledOp
    n_lanes: int = 0

    @property
    def program(self):
        return self.op.program

    def outputs(self, final):
        return self.op.outputs(final, self.n_lanes)


def compile_div(op: str, config: dict):
    """``op`` compiled for any operands, as the arith driver's
    ``OpProgram`` (its image rows, fills and MAJ bytes)."""
    from repro_torch.compile import compile_op

    co = compile_op(op, int(config["tier"]), int(config["n_act"]))
    fills: dict[int, list[int]] = collections.defaultdict(list)
    for row, word in co.consts.items():
        fills[word].append(row)
    maj = sum(len(o.srcs) + len(o.dsts) for o in co.program.ops
              if o.kind == "MAJ")
    return arith.OpProgram(op, Compiled(co), co.n_rows, list(co.a_rows),
                           list(co.b_rows), dict(fills), maj)


class State(arith.State):
    def operands(self, index: int):
        """A uniform dividend and a divisor ``u32 >> k`` a lane, made
        again from the seed and the request's index."""
        a, raw = super().operands(index)
        self.gen.manual_seed(sub_seed(self.seed, index, 2))
        k = torch.randint(0, DIVISOR_SHIFT_MAX + 1,
                          (self.lanes,), dtype=torch.int64,
                          device=self.device, generator=self.gen)
        b = (raw.to(torch.int64) & 0xFFFFFFFF) >> k
        del raw, k
        return [a, torch.where(b >= 2**31, b - 2**32, b).to(torch.int32)]


def setup(config: dict, traffic: dict, seed: int, device: str,
          split: dict) -> State:
    st = State(config, traffic, seed, device)
    t = time.perf_counter()
    for op in config["ops"]:
        prog = compile_div(op, config)
        prog.compiled.n_lanes = st.lanes
        st.programs[op] = prog
    split["trace"] = time.perf_counter() - t
    t = time.perf_counter()
    for op, prog in st.programs.items():
        st.images[op] = arith.template(prog, st.words, st.device)
        st.rows_t[op] = tuple(torch.as_tensor(r, device=st.device)
                              for r in (prog.a_rows, prog.b_rows))
    arith._sync(st)
    split["template"] = time.perf_counter() - t
    # As the arith driver: the first request of each op schedules, lowers
    # and certifies its Program; the second runs with everything built.
    for phase, index in (("certify", -1), ("warm", -2)):
        t = time.perf_counter()
        for k, op in enumerate(config["ops"]):
            st.issue(index * 16 - k, op, {})
            arith._sync(st)
        split[phase] = time.perf_counter() - t
    return st


def window(st: State, seconds: float, prof):
    """The arith driver's window inside a recording of the program's
    spans and counters."""
    from repro_torch import obs

    with obs.recording() as rec:
        record = arith.window(st, seconds, prof)
    record.counters["program"] = dataclasses.asdict(rec)
    return record
