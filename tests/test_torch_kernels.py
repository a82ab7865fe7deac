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
from repro.kernels.bitserial import ops as ref_bitserial
from repro.kernels.majx import ops as ref_majx
from repro.kernels.megakernel import ops as ref_mega
from repro.kernels.megakernel.ref import schedule_exec_ref as ref_exec
from repro.kernels.mismatch import ops as ref_mismatch
from repro.kernels.rowcopy import ops as ref_rowcopy
from repro_torch import interop
from repro_torch.core import bitplanes as bp
from repro_torch.kernels.bitserial import ops as bitserial_ops
from repro_torch.kernels.majx import ops as majx_ops
from repro_torch.kernels.megakernel import ops as mega_ops
from repro_torch.kernels.megakernel.ref import schedule_exec_ref
from repro_torch.kernels.mismatch import ops as mismatch_ops
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


# ------------------------------------------------------------ mismatch


def _mismatch_pair(shape, kind):
    rng = np.random.default_rng(sum(shape) + len(kind))
    got = rand_u32(rng, *shape)
    if kind == "equal":
        return got, got.copy()
    want = rand_u32(rng, *shape)
    if kind == "sign" and got.size:
        got.reshape(-1)[::3] = 0x80000000
        want.reshape(-1)[::3] = 0x7FFFFFFF
    return got, want


@pytest.mark.parametrize("kind", ["random", "sign", "equal"])
@pytest.mark.parametrize("shape", [(1,), (511,), (512,), (513,), (4099,),
                                   (3, 4099)], ids=str)
def test_mismatch_matches_pallas(shape, kind):
    got, want = _mismatch_pair(shape, kind)
    count = mismatch_ops.mismatch_count(_t(got), _t(want))
    ref = ref_mismatch.mismatch_count(jnp.asarray(got), jnp.asarray(want))
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(ref)
    assert int(count) == int(ref_mismatch.mismatch_count_ref(
        jnp.asarray(got), jnp.asarray(want)))
    assert mismatch_ops.success_rate(_t(got), _t(want)) == \
        ref_mismatch.success_rate(jnp.asarray(got), jnp.asarray(want))
    if kind == "equal":
        assert int(count) == 0
    assert mismatch_ops.launches == 0  # the CPU route launches nothing


def test_mismatch_zero_words():
    """Zero words count 0, as the reference's plain version gives; the
    reference's Pallas wrapper cannot take them (it raises), which is
    recorded in ROADMAP.md's queue of reference faults."""
    empty = np.zeros(0, np.uint32)
    count = mismatch_ops.mismatch_count(_t(empty), _t(empty))
    assert int(count) == int(ref_mismatch.mismatch_count_ref(
        jnp.asarray(empty), jnp.asarray(empty))) == 0
    with pytest.raises(TypeError):
        ref_mismatch.mismatch_count(jnp.asarray(empty), jnp.asarray(empty))


@pytest.mark.parametrize("n_got,n_want", [(600, 1000), (100, 5000),
                                          (5000, 100)])
def test_mismatch_refuses_unequal_sizes(n_got, n_want):
    """The reference pads each operand to rows of 512 words on its own
    and walks the grid of ``got``: with unequal sizes its count depends
    on which operand is longer and by how much (it is neither the count
    over the common words nor over the zero-padded shorter operand in
    every case).  The port raises instead."""
    rng = np.random.default_rng(n_got)
    got, want = rand_u32(rng, n_got), rand_u32(rng, n_want)
    with pytest.raises(ValueError, match="must be equal"):
        mismatch_ops.mismatch_count(_t(got), _t(want))
    n = max(n_got, n_want)
    pad_g, pad_w = np.zeros(n, np.uint32), np.zeros(n, np.uint32)
    pad_g[:n_got], pad_w[:n_want] = got, want
    zero_padded = int(np.unpackbits((pad_g ^ pad_w).view(np.uint8)).sum())
    ref = int(ref_mismatch.mismatch_count(jnp.asarray(got),
                                          jnp.asarray(want)))
    assert (ref == zero_padded) == (n_got == 600)


def test_mismatch_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        mismatch_ops.mismatch_count(a, a.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        mismatch_ops.mismatch_count(a.view(2, 4).t(), a.view(2, 4).t())
    with pytest.raises(ValueError, match="operands on"):
        mismatch_ops.mismatch_count(a, a.to("meta"))


# ----------------------------------------------------------- bitserial

# NBITS 1/8/16/32/33, each in the 2-D (NBITS, C) and the 3-D
# (NBITS, R, C) layout, over word counts 1, 3, 300 and 4099.
BITSERIAL_CASES = [(1, (1,)), (1, (2, 3)), (8, (300,)), (8, (3, 4099)),
                   (16, (4099,)), (16, (2, 1)), (32, (3,)),
                   (32, (2, 300)), (33, (4099,)), (33, (3, 3))]


@pytest.mark.parametrize("nbits,shape", BITSERIAL_CASES, ids=str)
def test_bitserial_add_matches_pallas(nbits, shape):
    rng = np.random.default_rng(nbits * 7 + len(shape))
    a, b = rand_u32(rng, 2, nbits, *shape)
    a[:, ..., 0] = 0xFFFFFFFF           # a carry through every plane
    b[0, ..., 0] = 1
    got = bitserial_ops.bitserial_add(_t(a), _t(b))
    want = np.asarray(ref_bitserial.bitserial_add(jnp.asarray(a),
                                                  jnp.asarray(b)))
    assert got.shape == (nbits, *shape)
    assert (bp.to_u32(got) == want).all()
    assert (bp.to_u32(bitserial_ops.bitserial_add_ref(_t(a), _t(b)))
            == np.asarray(ref_bitserial.bitserial_add_ref(a, b))).all()
    assert bitserial_ops.launches == 0  # the CPU route launches nothing


@pytest.mark.parametrize("k", [0, 1, 33, 1000])
def test_add_u32_matches_numpy_and_pallas(k):
    rng = np.random.default_rng(k)
    a, b = rand_u32(rng, 2, k)
    if k:
        a[0], b[0] = 0xFFFFFFFF, 0xFFFFFFFF
    got = bitserial_ops.add_u32(_t(a), _t(b))
    assert got.dtype == torch.int32 and got.shape == (k,)
    assert (bp.to_u32(got) == a + b).all()
    if k:
        assert (bp.to_u32(got) == np.asarray(ref_bitserial.add_u32(
            jnp.asarray(a), jnp.asarray(b)))).all()
    assert torch.equal(bitserial_ops.add_u32(_t(a).reshape(1, -1),
                                             _t(b).to(torch.int64)), got)


@pytest.mark.parametrize("sa,sb", [((8, 300), (8, 200)), ((8, 300), (4, 300)),
                                   ((8, 2, 300), (8, 300))], ids=str)
def test_bitserial_refuses_unequal_shapes(sa, sb):
    """The reference takes operands of unequal shape and returns ``a``'s
    shape: for (8, 300) + (8, 200) its columns past 256 are neither the
    zero-padded sum nor ``a``; the port raises instead (ROADMAP.md
    queue 3).  ``add_u32`` refuses unequal element counts, which the
    reference also takes (33 + 34 elements give 33 sums)."""
    rng = np.random.default_rng(len(sa))
    a, b = rand_u32(rng, *sa), rand_u32(rng, *sb)
    with pytest.raises(ValueError, match="must be equal"):
        bitserial_ops.bitserial_add(_t(a), _t(b))
    if len(sa) == len(sb):
        assert np.asarray(ref_bitserial.bitserial_add(
            jnp.asarray(a), jnp.asarray(b))).shape == sa
    with pytest.raises(ValueError, match="must be equal"):
        bitserial_ops.add_u32(_t(a[0]), _t(b[0, :-1]))
    assert ref_bitserial.add_u32(jnp.arange(33, dtype=jnp.uint32),
                                 jnp.arange(34, dtype=jnp.uint32)).shape \
        == (33,)


def test_bitserial_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        bitserial_ops.bitserial_add(a, a.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        bitserial_ops.bitserial_add(a.t(), a.t())
    with pytest.raises(ValueError, match="dims"):
        bitserial_ops.bitserial_add(a[0], a[0])
    with pytest.raises(ValueError, match="bit-plane"):
        bitserial_ops.bitserial_add(a[:0], a[:0])
    with pytest.raises(ValueError, match="operands on"):
        bitserial_ops.bitserial_add(a, a.to("meta"))
