"""The port's main path as a whole: program execution on its backends.

Golden Programs replay through the port's ``oracle`` and
``cuda(device="cpu")`` backends in per-op, fused and megakernel modes
against their frozen expected rows and digests; random hazard-heavy
Programs run bit-exact against the reference's ``pallas`` backend in
interpret mode, with the same dispatch counts per program and mode.
"""

import glob
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _proptest import rand_u32
from repro.backends import ExecutionContext as RefContext
from repro.backends import get_backend as ref_get_backend
from repro_torch import interop
from repro_torch.backends import (CudaBackend, ExecutionContext,
                                  available_backends, get_backend,
                                  resolve_backend)
from repro_torch.core import bitplanes as bp
from repro_torch.pud.isa import Program
from test_compile_differential import rand_program

CPU = ExecutionContext(device="cpu", ideal=True)
REF = RefContext(ideal=True)
MODES = ("per_op", "fused", "megakernel")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_FILES = sorted(glob.glob(os.path.join(GOLDEN_DIR, "*.json")))
GOLDEN_IDS = [os.path.basename(p)[:-5] for p in GOLDEN_FILES]


def _run(be, mode, prog, state):
    """(final image as uint32 numpy, dispatches of that run)."""
    with be.count_dispatches() as scope:
        if mode == "per_op":
            out = be.run(prog, state)
        else:
            out = be.run_fused(prog, state, mode=mode)
    return (np.asarray(out) if not isinstance(out, torch.Tensor)
            else bp.to_u32(out)), scope.count


@pytest.mark.parametrize("path", GOLDEN_FILES, ids=GOLDEN_IDS)
@pytest.mark.parametrize("backend", ["oracle", "cuda"])
def test_golden_replay_all_modes(path, backend):
    with open(path) as f:
        doc = json.load(f)
    prog = interop.program_from_json(json.dumps(doc["ops"]))
    rng = np.random.default_rng((doc["seed"], 0x601D))
    state = rng.integers(0, 2**32, (doc["rows"], doc["words"]),
                         dtype=np.uint32)
    expected = np.array(
        [[int(row[i:i + 8], 16) for i in range(0, len(row), 8)]
         for row in doc["expected"]], dtype=np.uint32)
    be = get_backend(backend, CPU)
    for mode in MODES:
        got, _ = _run(be, mode, prog, state)
        assert (got == expected).all(), (doc["name"], backend, mode)
        assert hashlib.sha256(got.tobytes()).hexdigest() == \
            doc["megakernel"]["final_digest"]


def _random_cases(n=20, seed=0x70C4):
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n):
        prog = rand_program(rng, n_ops=int(rng.integers(6, 16)))
        cases.append((prog, rand_u32(rng, 20, 8)))
    return cases


@pytest.mark.parametrize("case", _random_cases(),
                         ids=[f"rand{i}" for i in range(20)])
def test_random_programs_match_pallas(case):
    ref_prog, state = case
    prog = interop.program_from_json(ref_prog.to_json())
    pallas = ref_get_backend("pallas", REF)
    cuda = get_backend("cuda", CPU)
    want, _ = _run(get_backend("oracle", CPU), "per_op", prog, state)
    for mode in MODES:
        ref_out, ref_n = _run(pallas, mode, ref_prog, jnp.asarray(state))
        got, n = _run(cuda, mode, prog, state)
        assert (ref_out == want).all(), mode
        assert (got == want).all(), mode
        assert n == ref_n, (mode, n, ref_n)


def test_add32_dispatch_budget():
    with open(os.path.join(GOLDEN_DIR, "add32.json")) as f:
        doc = json.load(f)
    prog = interop.program_from_json(json.dumps(doc["ops"]))
    state = np.zeros((doc["rows"], 4), np.uint32)
    be = get_backend("cuda", CPU)
    counts = {mode: _run(be, mode, prog, state)[1] for mode in MODES}
    assert counts == {"per_op": 64, "fused": 34, "megakernel": 1}
    assert be.dispatch_count == 99 and be.energy_nj_total > 0


def test_run_never_writes_the_callers_tensor():
    prog = Program()
    prog.emit("MAJ", x=3, n_act=4, srcs=(0, 1, 2), dsts=(0,))
    prog.emit("NOT", srcs=(0,), dsts=(1,))
    prog.emit("MRC", n_act=4, srcs=(1,), dsts=(2, 3))
    state = bp.from_u32(rand_u32(np.random.default_rng(5), 4, 6), "cpu")
    before = state.clone()
    be = get_backend("cuda", CPU)
    outs = [be.run(prog, state), be.run_fused(prog, state),
            be.run_fused(prog, state, mode="megakernel")]
    assert torch.equal(state, before)
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert not torch.equal(outs[0], before)


def test_bulk_entry_points_match_oracle():
    rng = np.random.default_rng(9)
    planes = rand_u32(rng, 2, 5, 3, 16)
    cuda, oracle = get_backend("cuda", CPU), get_backend("oracle", CPU)
    assert torch.equal(cuda.majx_batch(planes), oracle.majx_batch(planes))
    assert torch.equal(cuda.majx(planes[0]), oracle.majx(planes[0]))
    assert torch.equal(cuda.rowcopy(planes[0, 0], 5),
                       oracle.rowcopy(planes[0, 0], 5))
    with cuda.count_dispatches() as scope:
        cuda.majx_batch(planes)
    assert scope.count == 1


def test_registry():
    assert available_backends() == ("cuda", "oracle")
    with pytest.raises(KeyError, match="cuda.*oracle"):
        get_backend("pallas")
    be = get_backend("cuda", CPU)
    assert resolve_backend(be) is be
    with pytest.raises(ValueError, match="ExecutionContext"):
        resolve_backend(be, ExecutionContext(device="cpu"))
    assert isinstance(resolve_backend("cuda", CPU), CudaBackend)
    assert be.capabilities().megakernel and be.capabilities().native_batch


def test_unported_kernels_raise():
    be = get_backend("cuda", CPU)
    a = np.zeros((2, 4), np.uint32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        be.mismatch(a, a)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        be.add_planes(a, a)
    with pytest.raises(NotImplementedError):
        be.success_rate(a, a)


def test_oracle_mismatch_and_adder_match_reference():
    rng = np.random.default_rng(11)
    a, b = rand_u32(rng, 8, 2, 16), rand_u32(rng, 8, 2, 16)
    a[0, 0, 0] = 0xFFFFFFFF
    oracle = get_backend("oracle", CPU)
    ref = ref_get_backend("oracle", REF)
    assert int(oracle.mismatch(a, b)) == int(ref.mismatch(a, b))
    assert oracle.success_rate(a, b) == ref.success_rate(a, b)
    assert (bp.to_u32(oracle.add_planes(a, b))
            == np.asarray(ref.add_planes(a, b))).all()


def test_backend_refuses_tensors_on_another_device():
    be = get_backend("cuda", ExecutionContext(device="meta"))
    with pytest.raises(ValueError, match="backend runs on meta"):
        be.majx(torch.zeros((3, 4), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        get_backend("cuda", CPU).majx(torch.zeros((3, 4)))
