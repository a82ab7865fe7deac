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
from repro_torch.kernels.bitserial import ops as bitserial_ops
from repro_torch.kernels.majx import ops as majx_ops
from repro_torch.kernels.megakernel import ops as mega_ops
from repro_torch.kernels.mismatch import ops as mismatch_ops
from repro_torch.kernels.rowcopy import ops as rowcopy_ops
from repro_torch.pud.isa import Program

C_TYPES = {"void*": launch.VOID_P, "int": launch.I32,
           "long long": launch.I64}

BINDINGS = {
    ("majx", "majx_launch"): majx_ops,
    ("fanout", "fanout_launch"): rowcopy_ops,
    ("megakernel", "megakernel_launch"): mega_ops,
    ("mismatch", "mismatch_launch"): mismatch_ops,
    ("bitserial", "bitserial_add_launch"): bitserial_ops,
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
    assert BINDINGS[key]._ARGS == c_signature(*key)
    assert launch.SOURCES == ("majx", "fanout", "megakernel", "mismatch",
                              "bitserial")


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
