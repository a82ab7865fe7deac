"""Each kernel module of the port against its JAX counterpart.

The port's wrappers take their plain PyTorch version for a CPU tensor,
which is what runs here; the JAX side runs its Pallas kernels in
interpret mode, as the reference's own tests do.  All of it is integer
bitwise work, so every comparison is bit-exact (tolerance zero).  The
kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _proptest import rand_u32
from repro.compile import build_schedule as ref_build_schedule
from repro.compile import lower_schedule as ref_lower_schedule
from repro.kernels.majx import ops as ref_majx
from repro.kernels.megakernel import ops as ref_mega
from repro.kernels.megakernel.ref import schedule_exec_ref as ref_exec
from repro.kernels.rowcopy import ops as ref_rowcopy
from repro_torch import interop
from repro_torch.core import bitplanes as bp
from repro_torch.kernels.majx import ops as majx_ops
from repro_torch.kernels.megakernel import ops as mega_ops
from repro_torch.kernels.megakernel.ref import schedule_exec_ref
from repro_torch.kernels.rowcopy import ops as rowcopy_ops
from test_compile_differential import rand_program


def _t(a):
    return bp.from_u32(a, "cpu")


@pytest.mark.parametrize("n", [1, 3, 5, 7, 9, 33])
@pytest.mark.parametrize("shape", [(37,), (3, 29)], ids=["2d", "3d"])
def test_majx_matches_pallas(n, shape):
    rng = np.random.default_rng(n)
    planes = rand_u32(rng, n, *shape)
    planes[:, ..., 0] = 0x80000001
    got = majx_ops.majx(_t(planes))
    want = ref_majx.majx(jnp.asarray(planes))
    assert got.shape == shape
    assert (bp.to_u32(got) == np.asarray(want)).all()
    assert majx_ops.launches == 0  # the CPU route launches nothing


@pytest.mark.parametrize("b,x", [(1, 3), (4, 5), (3, 9)])
def test_majx_batch_matches_pallas(b, x):
    rng = np.random.default_rng(b * 10 + x)
    planes = rand_u32(rng, b, x, 2, 40)
    got = majx_ops.majx_batch(_t(planes))
    want = np.stack([np.asarray(ref_majx.majx(jnp.asarray(p)))
                     for p in planes])
    assert (bp.to_u32(got) == want).all()


def test_majx_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="odd"):
        majx_ops.majx(torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        majx_ops.majx(torch.zeros((3, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        majx_ops.majx(torch.zeros((8, 3), dtype=torch.int32).t())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_vote_matches_pallas(dtype):
    rng = np.random.default_rng(len(dtype))
    n = 45
    raw = rng.integers(0, 256, (3, n * 4), dtype=np.uint8)
    raw[2] = raw[0]  # replica 1 corrupt, replicas 0 and 2 agree
    tdtype = getattr(torch, dtype)
    reps = [torch.from_numpy(r.copy()).view(tdtype)[:n] for r in raw]
    got = majx_ops.vote(reps)
    want = ref_majx.vote([jnp.asarray(r).view(jnp.dtype(dtype))[:n]
                          for r in raw])
    assert got.dtype == tdtype and got.shape == (n,)
    assert (got.view(torch.uint8).numpy()
            == np.asarray(want).view(np.uint8)).all()
    assert torch.equal(got.view(torch.uint8), reps[0].view(torch.uint8))


@pytest.mark.parametrize("fan", [1, 7, 15, 31])
def test_fanout_matches_pallas(fan):
    rng = np.random.default_rng(fan)
    src = rand_u32(rng, 3, 45)
    got = rowcopy_ops.fanout(_t(src), fan)
    want = ref_rowcopy.fanout(jnp.asarray(src), fan)
    assert got.shape == (fan, 3, 45)
    assert (bp.to_u32(got) == np.asarray(want)).all()
    row = rowcopy_ops.fanout(_t(src[0]), fan)
    assert (bp.to_u32(row) == np.asarray(
        ref_rowcopy.fanout(jnp.asarray(src[0]), fan))).all()


def _lowering_cases():
    rng = np.random.default_rng(0x10E)
    return [rand_program(rng, n_ops=12) for _ in range(6)]


@pytest.mark.parametrize("ref_prog", _lowering_cases(),
                         ids=[f"rand{i}" for i in range(6)])
def test_run_lowering_matches_pallas_and_refs(ref_prog):
    ref_low = ref_lower_schedule(ref_build_schedule(ref_prog))
    low = interop.lowering_from_arrays(ref_low.src, ref_low.dst,
                                       ref_low.inv, ref_low.n_rows,
                                       ref_low.level_meta)
    rng = np.random.default_rng(ref_low.n_levels)
    state = rand_u32(rng, 22, 9)
    got = mega_ops.run_lowering(low, _t(state))
    want = np.asarray(ref_mega.run_lowering(ref_low, jnp.asarray(state)))
    assert (bp.to_u32(got) == want).all()
    assert (bp.to_u32(schedule_exec_ref(low, _t(state))) == want).all()
    assert (ref_exec(ref_low, state) == want).all()


def test_run_lowering_identity_and_row_check():
    empty = ref_lower_schedule(ref_build_schedule(rand_program(
        np.random.default_rng(1), n_ops=0)))
    low = interop.lowering_from_arrays(empty.src, empty.dst, empty.inv,
                                       empty.n_rows, empty.level_meta)
    state = _t(rand_u32(np.random.default_rng(2), 4, 5))
    out = mega_ops.run_lowering(low, state)
    assert torch.equal(out, state) and out.data_ptr() != state.data_ptr()
    prog = rand_program(np.random.default_rng(3), n_ops=8)
    big = ref_lower_schedule(ref_build_schedule(prog))
    low = interop.lowering_from_arrays(big.src, big.dst, big.inv,
                                       big.n_rows, big.level_meta)
    with pytest.raises(ValueError, match="rows"):
        mega_ops.run_lowering(low, state[:1])
