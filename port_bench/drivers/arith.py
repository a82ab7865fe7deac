"""Compiled §8.1 arithmetic on new operands: one closed-loop client.

Set-up traces each op once at a narrow width (the Program does not
depend on the width: rows are SSA and keyed by value), locates the
operand rows of its image, and builds the full-width image template on
the device: constant rows tiled, operand rows written per request, every
other row as the traced image has it (zero: gate outputs are written by
their ops).  The port has no entry that runs a compiled Program on new
operands, so this composes one from its public pieces; per request:

1. fresh uint32 operands on the device, drawn from the seed;
2. ``bitplanes.pack_uint_elements`` of each;
3. the planes written into the template's operand rows;
4. ``DramSession.run_fused(program, image, mode=...)``;
5. ``CompiledProgram.outputs`` of the final image.

The client keeps ``in_flight`` requests issued, issuing the next before
it waits on the oldest (on an event recorded after its outputs).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from port_bench.harness import peaks
from port_bench.harness.record import Record
from port_bench.harness.runner import Check
from port_bench.harness.spec import reference
from port_bench.harness.traffic import Reservoir, mix_sequence, sub_seed

INT32_MIN, INT32_END = -2**31, 2**31


@dataclasses.dataclass
class OpProgram:
    """A traced op and where its operands go in its image."""

    op: str
    compiled: object          # repro_torch.compile.trace.CompiledProgram
    rows: int
    a_rows: list[int]
    b_rows: list[int]
    fills: dict[int, list[int]]   # word value -> uniform rows holding it
    maj_bytes_per_word: int


def trace_op(op: str, config: dict) -> OpProgram:
    """Trace ``op`` at ``trace_words`` words a row and map its image."""
    from repro_torch.compile.trace import compile_elementwise
    from repro_torch.core import bitplanes as bp

    words = int(config["trace_words"])
    rng = np.random.default_rng(int(config["trace_seed"]))
    a = rng.integers(0, 2**32, words * 32, dtype=np.uint32)
    b = rng.integers(0, 2**32, words * 32, dtype=np.uint32)
    cp = compile_elementwise(op, a, b, tier=int(config["tier"]),
                             n_act=int(config["n_act"]))
    planes = {}
    for name, x in (("a", a), ("b", b)):
        packed = bp.to_u32(bp.pack_uint_elements(
            torch.from_numpy(x.view(np.int32))))
        for i, p in enumerate(packed):
            key = p.tobytes()
            if key in planes or (p == p[0]).all():
                raise ValueError(f"{op}: operand plane {name}[{i}] is not "
                                 f"distinct at {words} words")
            planes[key] = (name, i)
    a_rows, b_rows = [-1] * 32, [-1] * 32
    fills: dict[int, list[int]] = collections.defaultdict(list)
    for r, row in enumerate(cp.state):
        hit = planes.get(row.tobytes())
        if hit is not None:
            (a_rows if hit[0] == "a" else b_rows)[hit[1]] = r
        elif (row == row[0]).all():
            fills[int(row[0])].append(r)
        else:
            raise ValueError(f"{op}: image row {r} is neither an operand "
                             f"plane nor uniform")
    if -1 in a_rows or -1 in b_rows:
        raise ValueError(f"{op}: an operand plane has no row")
    maj = sum(len(o.srcs) + len(o.dsts) for o in cp.program.ops
              if o.kind == "MAJ")
    return OpProgram(op, cp, int(cp.state.shape[0]), a_rows, b_rows,
                     dict(fills), maj)


def template(prog: OpProgram, words: int, device):
    """The (rows, words) int32 image on ``device`` with every row but the
    operand rows as the traced image has it."""
    image = torch.zeros((prog.rows, words), dtype=torch.int32,
                        device=device)
    for value, rows in prog.fills.items():
        if value:
            word = value - 2**32 if value >= 2**31 else value
            image[torch.as_tensor(rows, device=device)] = word
    return image


class State:
    def __init__(self, config, traffic, seed, device):
        from repro_torch.backends import ExecutionContext
        from repro_torch.session import DramSession

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.words = int(config["bank_words"]) * int(config["banks"])
        self.lanes = self.words * 32
        self.mode = traffic["mode"]
        self.session = DramSession(
            config["backend"],
            ExecutionContext(device=device, tier=int(config["tier"]),
                             n_act=int(config["n_act"])),
            name="bench/arith")
        self.gen = torch.Generator(device=self.device)
        self.programs: dict[str, OpProgram] = {}
        self.images = {}
        self.rows_t = {}
        self.samples: dict[str, Reservoir] = {}

    # ------------------------------------------------------- one request
    def operands(self, index: int):
        out = []
        for which in (0, 1):
            self.gen.manual_seed(sub_seed(self.seed, index, which))
            out.append(torch.randint(INT32_MIN, INT32_END, (self.lanes,),
                                     dtype=torch.int32, device=self.device,
                                     generator=self.gen))
        return out

    def issue(self, index: int, op: str, host: dict):
        """Issue one request; returns (issue time, done event, outputs)."""
        from repro_torch.core import bitplanes as bp

        prog = self.programs[op]
        image = self.images[op]
        t_issue = time.perf_counter()
        with record_function("bench.pack"):
            a, b = self.operands(index)
            ra, rb = self.rows_t[op]
            image.index_copy_(0, ra, bp.pack_uint_elements(a))
            image.index_copy_(0, rb, bp.pack_uint_elements(b))
            del a, b
        with record_function("bench.run_fused"):
            t = time.perf_counter()
            final = self.session.run_fused(prog.compiled.program, image,
                                           mode=self.mode)
            host.setdefault("run_fused_s", []).append(
                time.perf_counter() - t)
        with record_function("bench.unpack"):
            result = prog.compiled.outputs(final)
            del final
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return t_issue, done, result


def setup(config: dict, traffic: dict, seed: int, device: str,
          split: dict) -> State:
    st = State(config, traffic, seed, device)
    t = time.perf_counter()
    for op in config["ops"]:
        prog = trace_op(op, config)
        prog.compiled = dataclasses.replace(prog.compiled,
                                            n_lanes=st.lanes)
        st.programs[op] = prog
    split["trace"] = time.perf_counter() - t
    t = time.perf_counter()
    for op, prog in st.programs.items():
        st.images[op] = template(prog, st.words, st.device)
        st.rows_t[op] = tuple(torch.as_tensor(r, device=st.device)
                              for r in (prog.a_rows, prog.b_rows))
    _sync(st)
    split["template"] = time.perf_counter() - t
    # The first request of each op schedules, lowers and certifies its
    # Program; the second shows every kernel and table already built.
    for phase, index in (("certify", -1), ("warm", -2)):
        t = time.perf_counter()
        for k, op in enumerate(config["ops"]):
            st.issue(index * 16 - k, op, {})
            _sync(st)
        split[phase] = time.perf_counter() - t
    return st


def _sync(st: State) -> None:
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)


def window(st: State, seconds: float, prof) -> Record:
    traffic = st.traffic
    ops = mix_sequence(traffic["mix"], traffic["deck_copies"], st.seed)
    depth = int(traffic["in_flight"])
    per_op = int(traffic["sample_per_op"])
    if not st.samples:      # one sample over every window of the run
        st.samples = {op: Reservoir(per_op, st.seed, k)
                      for k, op in enumerate(st.config["ops"])}
    host: dict[str, list[float]] = {}
    latencies: list[float] = []
    calls: list[str] = []
    inflight = collections.deque()

    def complete():
        index, op, t_issue, done, result = inflight.popleft()
        with record_function("bench.wait"):
            if done is not None:
                done.synchronize()
        latencies.append(time.perf_counter() - t_issue)
        st.samples[op].offer(lambda: (index, op, result))

    with record_function("bench.window"):
        t_start = time.perf_counter()
        t_end = t_start + seconds
        index = 0
        while time.perf_counter() < t_end:
            op = next(ops)
            t_issue, done, result = st.issue(index, op, host)
            calls.append(op)
            inflight.append((index, op, t_issue, done, result))
            del result
            index += 1
            while len(inflight) >= depth:
                complete()
        while inflight:
            complete()
        t_last = time.perf_counter()
    n = len(latencies)
    rows = {op: p.rows for op, p in st.programs.items()}
    return Record(
        window_s=t_last - t_start, attempted=n, failed=0,
        latencies_s=latencies,
        work={"requests": n, "lanes": n * st.lanes},
        host=host,
        counters={
            "mode": st.mode, "words": st.words, "lanes": st.lanes,
            "calls": calls,
            "image_bytes": sum(peaks.image_bytes(rows[op], st.words)
                               for op in calls),
            "maj_bytes": sum(st.programs[op].maj_bytes_per_word
                             * st.words * peaks.WORD_BYTES
                             for op in calls)})


def release(st: State) -> list:
    """The sampled answers on the host, with their operands made again
    from the seed; the program's state is dropped first."""
    samples = [item for r in st.samples.values() for item in r.items]
    st.samples = {}
    st.images.clear()
    st.programs.clear()
    st.session = None
    out = []
    for index, op, result in samples:
        a, b = st.operands(index)
        out.append((index, op, _u32(a), _u32(b), _u32(result)))
        del a, b, result
    return out


def _u32(t) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def check(answers: list, config: dict, traffic: dict, seed: int
          ) -> list[Check]:
    """Every sampled answer against the plain reference, lane by lane."""
    ref = reference(config)
    wrong = sum(ref.wrong_lanes(op, a, b, got)
                for _, op, a, b, got in answers)
    missing = len(set(config["ops"]) - {op for _, op, *_ in answers})
    return [Check("wrong_lanes", wrong, 0),
            Check("ops_not_compared", missing, 0)]
