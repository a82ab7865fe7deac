"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no card is present
(the check is made in the ``cuda_device`` fixture, at run time).  The
module imports neither JAX nor the reference package, so it runs on a
GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CPU twins in ``test_torch_kernels.py`` and ``test_torch_backends.py``
hold the same plain versions against the JAX reference; together they
tie each kernel to the reference.  All comparisons are bit-exact.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.backends import ExecutionContext, get_backend
from repro_torch.compile import build_schedule, lower_schedule
from repro_torch.core import bitplanes as bp
from repro_torch.kernels.majx import ops as majx_ops
from repro_torch.kernels.megakernel import ops as mega_ops
from repro_torch.kernels.megakernel.ref import schedule_exec_ref
from repro_torch.kernels.rowcopy import ops as rowcopy_ops
from repro_torch.pud.isa import Program

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _words(seed, *shape, device):
    rng = np.random.default_rng(seed)
    return bp.from_u32(rng.integers(0, 2**32, shape, dtype=np.uint32),
                       device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 5, 7, 9, 33])
@pytest.mark.parametrize("shape", [(1000,), (3, 4099)], ids=["2d", "3d"])
def test_majx_kernel_matches_plain(cuda_device, n, shape):
    planes = _words(n, n, *shape, device=cuda_device)
    before = majx_ops.launches
    got = majx_ops.majx(planes)
    assert majx_ops.launches == before + 1
    assert torch.equal(got, majx_ops.majx_ref(planes))


@pytest.mark.cuda
def test_majx_batch_kernel_is_one_launch(cuda_device):
    planes = _words(1, 3, 5, 2, 777, device=cuda_device)
    before = majx_ops.launches
    got = majx_ops.majx_batch(planes)
    assert majx_ops.launches == before + 1
    assert torch.equal(got.cpu(), majx_ops.majx_batch(planes.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_vote_kernel_matches_plain(cuda_device, dtype):
    reps = [_words(i, 37, device=cuda_device).view(dtype)
            for i in range(3)]
    got = majx_ops.vote(reps)
    want = majx_ops.vote([r.cpu() for r in reps])
    assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("fan", [1, 7, 15, 31])
def test_fanout_kernel_matches_plain(cuda_device, fan):
    src = _words(fan, 3, 1001, device=cuda_device)
    before = rowcopy_ops.launches
    got = rowcopy_ops.fanout(src, fan)
    assert rowcopy_ops.launches == before + 1
    assert torch.equal(got, rowcopy_ops.fanout_ref(src, fan))


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(GOLDEN_DIR, "*.json"))))
def test_megakernel_matches_plain_on_goldens(cuda_device, path):
    with open(path) as f:
        doc = json.load(f)
    prog = interop.program_from_json(json.dumps(doc["ops"]))
    low = lower_schedule(build_schedule(prog))
    state = _words(doc["seed"], doc["rows"], 1000, device=cuda_device)
    before = mega_ops.launches
    got = mega_ops.run_lowering(low, state)
    assert mega_ops.launches == before + 1
    assert torch.equal(got, schedule_exec_ref(low, state))


def _rand_program(rng, rows: int = 20, n_ops: int = 12) -> Program:
    """Random hazard-heavy Program, the generator of
    ``test_compile_differential.rand_program`` without its JAX imports:
    aliased destinations, rewritten rows, dead stores, mixed arities."""
    prog = Program()
    for _ in range(n_ops):
        kind = rng.choice(["MAJ", "MAJ", "MAJ", "NOT", "COPY", "MRC",
                           "FRAC", "WR", "cost"])
        if kind == "cost":
            prog.emit("MAJ", x=3, n_act=4)
        elif kind == "MAJ":
            x = int(rng.choice([3, 5, 7]))
            prog.emit("MAJ", x=x, n_act=8,
                      srcs=tuple(int(r) for r in rng.integers(0, rows, x)),
                      dsts=tuple(int(r) for r in rng.integers(
                          0, rows, int(rng.integers(1, 3)))))
        elif kind in ("NOT", "COPY", "MRC"):
            n_dst = int(rng.integers(1, 8 if kind == "MRC" else 3))
            prog.emit(kind, n_act=8 if kind == "MRC" else 0,
                      srcs=(int(rng.integers(0, rows)),),
                      dsts=tuple(int(r)
                                 for r in rng.integers(0, rows, n_dst)))
        elif kind == "FRAC":
            prog.emit("FRAC", dsts=(int(rng.integers(0, rows)),))
        else:
            prog.emit("WR")
    return prog


@pytest.mark.cuda
def test_cuda_backend_modes_agree_with_oracle(cuda_device):
    cuda = get_backend("cuda", ExecutionContext(device="cuda"))
    oracle = get_backend("oracle", ExecutionContext(device="cuda"))
    rng = np.random.default_rng(0xC0DA)
    for i in range(12):
        prog = _rand_program(rng)
        state = _words(i, 20, 3000, device=cuda_device)
        want = oracle.run(prog, state)
        with cuda.count_dispatches() as scope:
            outs = [cuda.run(prog, state), cuda.run_fused(prog, state),
                    cuda.run_fused(prog, state, mode="megakernel")]
        assert all(torch.equal(o, want) for o in outs)
        sched = build_schedule(prog)
        assert scope.count == (sched.per_op_dispatches()
                               + sched.n_dispatches()
                               + (1 if sched.n_levels else 0))
