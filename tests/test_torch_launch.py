"""The ctypes bindings of the CUDA kernels against their C entry points.

A CUDA source cannot be compiled here, so a binding that disagrees with
its ``extern "C"`` signature would first show on the card.  These tests
read each entry point's signature from ``csrc/<name>.cu`` and hold every
wrapper's ``argtypes`` to it, then call each wrapper on CPU tensors with
the launch itself replaced by a recorder: the wrapper must pass one
argument per parameter, the stream last.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.compile import build_schedule, lower_schedule
from repro_torch.core import bitplanes as bp
from repro_torch.kernels import launch
from repro_torch.kernels.bitplanes import ops as bitplanes_ops
from repro_torch.kernels.bitserial import ops as bitserial_ops
from repro_torch.kernels.majx import ops as majx_ops
from repro_torch.kernels.megakernel import ops as mega_ops
from repro_torch.kernels.mismatch import ops as mismatch_ops
from repro_torch.kernels.rowcopy import ops as rowcopy_ops
from repro_torch.pud.isa import Program

C_TYPES = {"void*": launch.VOID_P, "int": launch.I32,
           "long long": launch.I64}

#: (source, entry point) -> the wrapper's ``argtypes`` for it.
BINDINGS = {
    ("majx", "majx_launch"): majx_ops._ARGS,
    ("fanout", "fanout_launch"): rowcopy_ops._ARGS,
    ("megakernel", "megakernel_launch"): mega_ops._ARGS,
    ("mismatch", "mismatch_launch"): mismatch_ops._ARGS,
    ("bitserial", "bitserial_add_launch"): bitserial_ops._ARGS,
    ("bitplanes", "pack_uint_elements_launch"): bitplanes_ops._PACK_ARGS,
    ("bitplanes", "unpack_uint_elements_launch"):
        bitplanes_ops._UNPACK_ARGS,
}


def c_signature(name: str, fn: str) -> list:
    """The ctypes types of ``fn``'s parameters in ``csrc/<name>.cu``."""
    text = (launch.CSRC / f"{name}.cu").read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    assert m, f"no extern C entry point {fn} in {name}.cu"
    types = []
    for param in m.group(1).split(","):
        words = param.replace("const ", "").split()
        ctype = " ".join(words[:-1]) + ("*" if "*" in words[-1] else "")
        types.append(C_TYPES[ctype.replace(" *", "*")])
    return types


@pytest.mark.parametrize("key", sorted(BINDINGS), ids=lambda k: k[1])
def test_argtypes_match_the_c_entry_point(key):
    assert BINDINGS[key] == c_signature(*key)
    assert launch.SOURCES == ("majx", "fanout", "megakernel", "mismatch",
                              "bitserial", "bitplanes")


class _Recorder:
    def __init__(self, argtypes):
        self.argtypes = argtypes
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _megakernel_call(regime):
    prog = Program()
    prog.emit("MAJ", x=3, n_act=4, srcs=(0, 1, 2), dsts=(3,))
    prog.emit("NOT", srcs=(3,), dsts=(0,))
    low = lower_schedule(build_schedule(prog))
    state = bp.from_u32(np.zeros((4, 64), np.uint32), "cpu")
    return lambda: mega_ops.run_lowering(low, state, regime=regime)


def _words(*shape):
    return torch.zeros(shape, dtype=torch.int32)


CALLS = {
    "majx": lambda: majx_ops.majx(_words(5, 64)),
    "fanout": lambda: rowcopy_ops.fanout(_words(64), 3),
    "megakernel[resident]": _megakernel_call("resident"),
    "megakernel[streaming]": _megakernel_call("streaming"),
    "mismatch": lambda: mismatch_ops.mismatch_count(_words(64), _words(64)),
    "bitserial": lambda: bitserial_ops.bitserial_add(_words(8, 64),
                                                     _words(8, 64)),
    "bitplanes[pack]": lambda: bitplanes_ops.pack_uint_elements(
        _words(3, 100), 40),
    "bitplanes[unpack]": lambda: bitplanes_ops.unpack_uint_elements(
        _words(3, 40, 4), 100),
}


@pytest.mark.parametrize("case", sorted(CALLS))
def test_wrapper_passes_every_parameter(case, monkeypatch):
    recorders = {}

    def kernel(name, fn, argtypes):
        return recorders.setdefault(fn, _Recorder(argtypes))

    def run(f, what, device, *args):
        assert f(*args, 0) == 0

    monkeypatch.setattr(launch, "on_cpu", lambda t: False)
    monkeypatch.setattr(launch, "kernel", kernel)
    monkeypatch.setattr(launch, "run", run)
    try:
        CALLS[case]()
    except (TypeError, ValueError, RuntimeError):
        pass    # a wrapper may read its (recorded) output afterwards
    (rec,) = recorders.values()
    assert len(rec.calls) == 1
    assert len(rec.calls[0]) == len(rec.argtypes)


@pytest.fixture
def recorded_launches(monkeypatch):
    """Route every wrapper to the kernel and record each launch's
    arguments (the stream left out) instead of making it."""
    calls = []

    def run(f, what, device, *args):
        calls.append((what, args[2:]))

    monkeypatch.setattr(launch, "on_cpu", lambda t: False)
    monkeypatch.setattr(launch, "kernel", lambda name, fn, argtypes: fn)
    monkeypatch.setattr(launch, "run", run)
    return calls


@pytest.mark.parametrize("lead,k,n_bits,vec,blocks", [
    ((), 2**26, 32, 1, 2**13),          # the benchmark's request
    ((2, 3), 1000, 40, 1, 1),           # batch 6, one tile a row
    ((5,), 33, 1, 0, 1),                # ragged k: 4-byte loads
    ((3,), 2**16 + 4, 32, 1, 25),       # 65 tiles a row: 195 warps
])
def test_pack_launch_arguments(recorded_launches, lead, k, n_bits, vec,
                               blocks):
    """A CUDA-shaped pack passes (batch, k, n_bits, vec, blocks): one
    warp a tile of 1024 elements of a row, 8 warps a block, the planes'
    stride ceil(k / 32) words following from k; int64 input is wrapped
    to int32 and a transposed view made contiguous first."""
    x = torch.zeros((*lead, k), dtype=torch.int32)
    before = bitplanes_ops.launches
    out = bitplanes_ops.pack_uint_elements(x, n_bits)
    batch = int(np.prod(lead))
    assert recorded_launches == [("pack_uint_elements",
                                  (batch, k, n_bits, vec, blocks))]
    assert out.shape == (*lead, n_bits, bp.n_words(k))
    assert out.dtype == torch.int32 and bitplanes_ops.launches == before + 1
    if lead:
        recorded_launches.clear()
        wide = x.to(torch.int64).movedim(-1, 0).contiguous().movedim(0, -1)
        assert not wide.is_contiguous()
        bitplanes_ops.pack_uint_elements(wide, n_bits)
        assert recorded_launches[0][1] == (batch, k, n_bits, vec, blocks)


@pytest.mark.parametrize("lead,n_planes,words,k,vec,blocks", [
    ((), 32, 2**21, 2**26, 1, 2**13),   # the benchmark's result planes
    ((4,), 5, 40, 1279, 0, 1),          # fewer planes, ragged k
    ((2,), 40, 3, 64, 1, 1),            # more planes, k < 32 * words
])
def test_unpack_launch_arguments(recorded_launches, lead, n_planes, words,
                                 k, vec, blocks):
    """A CUDA-shaped unpack passes (batch, k, words, n_planes, vec,
    blocks): the tiles follow k, the plane stride is the planes' own
    word count."""
    planes = torch.zeros((*lead, n_planes, words), dtype=torch.int32)
    out = bitplanes_ops.unpack_uint_elements(planes, k)
    assert recorded_launches == [("unpack_uint_elements",
                                  (int(np.prod(lead)), k, words, n_planes,
                                   vec, blocks))]
    assert out.shape == (*lead, k) and out.dtype == torch.int32


def test_bitplanes_empty_or_bad_calls_launch_nothing(recorded_launches):
    empty = bitplanes_ops.pack_uint_elements(torch.zeros((3, 0),
                                                         dtype=torch.int32))
    assert empty.shape == (3, 32, 0)
    assert bitplanes_ops.unpack_uint_elements(
        torch.zeros((2, 32, 4), dtype=torch.int32), 0).shape == (2, 0)
    with pytest.raises(ValueError):
        bitplanes_ops.unpack_uint_elements(
            torch.zeros((32, 4), dtype=torch.int32), 129)
    with pytest.raises(ValueError):
        bitplanes_ops.pack_uint_elements(torch.zeros(8, dtype=torch.int32),
                                         0)
    with pytest.raises(TypeError):
        bitplanes_ops.unpack_uint_elements(
            torch.zeros((32, 4), dtype=torch.int64), 100)
    assert recorded_launches == []


def test_concurrent_first_use_builds_once(tmp_path, monkeypatch):
    """Threads that all launch one kernel first on a cold build
    directory (the workers of ``run_sweep_ft``) start one build, load
    one library and bind one entry point; each build's temporary file is
    its own.  ``_start_build`` is a stand-in: no ``nvcc`` runs."""
    import sys
    import threading
    import time

    builds, loads = [], []

    class Proc:
        def __init__(self, tmp):
            self.tmp = tmp

        def wait(self):
            time.sleep(0.05)        # a build takes a while
            self.tmp.write_bytes(b"lib")
            return 0

    def start_build(name):
        builds.append(name)
        tmp = launch.library_path(name).with_suffix(f".tmp{len(builds)}")
        return Proc(tmp), tmp

    class Lib:
        def __init__(self, path):
            loads.append(path)
            self.majx_launch = _Recorder([])

    monkeypatch.setattr(launch, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(launch, "_start_build", start_build)
    monkeypatch.setattr(launch, "_LIBRARIES", {})
    monkeypatch.setattr(launch, "_ENTRIES", {})
    monkeypatch.setattr(launch.ctypes, "CDLL", Lib)
    got, errors = [], []
    start = threading.Barrier(32, timeout=30)

    def first_launch():
        try:
            start.wait()
            got.append(launch.kernel("majx", "majx_launch", majx_ops._ARGS))
        except Exception as e:     # reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_launch) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert builds == ["majx"] and len(loads) == 1
    assert len(got) == 32 and all(f is got[0] for f in got)
    assert got[0].argtypes == majx_ops._ARGS
    assert launch.library_path("majx").read_bytes() == b"lib"
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        [launch.library_path("majx").name]
    # Two builds of one source name distinct temporary files.
    monkeypatch.undo()
    monkeypatch.setattr(launch, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(launch, "_nvcc", lambda: "true")
    (proc_a, tmp_a), (proc_b, tmp_b) = (launch._start_build("fanout"),
                                        launch._start_build("fanout"))
    assert proc_a.wait() == proc_b.wait() == 0 and tmp_a != tmp_b
