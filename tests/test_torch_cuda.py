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
from repro_torch.kernels.bitserial import ops as bitserial_ops
from repro_torch.kernels.majx import ops as majx_ops
from repro_torch.kernels.megakernel import ops as mega_ops
from repro_torch.kernels.megakernel.ref import schedule_exec_ref
from repro_torch.kernels.mismatch import ops as mismatch_ops
from repro_torch.kernels.rowcopy import ops as rowcopy_ops
from repro_torch.pud.isa import Program
from repro_torch.session import DramSession

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
@pytest.mark.parametrize("n", list(range(1, 34, 2)) + [63])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_majx_kernel_any_odd_arity(cuda_device, n, offset):
    """Odd N from 1 to 33 and 63 (ragged last group of eight planes);
    ``offset`` 1 starts the planes one word into their storage, which
    takes the single-word path, as does the odd word count of the
    second shape."""
    for words in (4096, 1001):
        flat = _words(n + words, n * words + offset, device=cuda_device)
        planes = flat[offset:].view(n, words)
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


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["resident", "streaming"])
@pytest.mark.parametrize("words", [1, 31, 33, 2048, 2**18 + 3])
def test_megakernel_regimes_match_plain_on_add32(cuda_device, regime,
                                                  words):
    with open(os.path.join(GOLDEN_DIR, "add32.json")) as f:
        doc = json.load(f)
    low = lower_schedule(build_schedule(interop.program_from_json(
        json.dumps(doc["ops"]))))
    state = _words(words, doc["rows"], words, device=cuda_device)
    before = mega_ops.launches
    got = mega_ops.run_lowering(low, state, regime=regime)
    assert mega_ops.launches == before + 1
    assert torch.equal(got, schedule_exec_ref(low, state))


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["resident", "streaming"])
@pytest.mark.parametrize("words", [100, 1001, 2100])
def test_megakernel_regimes_match_plain_on_hazard_programs(cuda_device,
                                                           regime, words):
    """Random hazard-heavy Programs (swaps, rewrites, aliasing) in both
    regimes, at word counts whose strips leave a ragged edge: resident
    128 columns a block, streaming 1, 8 and 32 (16-byte accesses where
    the word count and the strip are multiples of 4)."""
    rng = np.random.default_rng(0x4A2)
    for i in range(8):
        prog = _rand_program(rng)
        low = lower_schedule(build_schedule(prog))
        if low.n_levels == 0:
            continue
        state = _words(i, 20, words, device=cuda_device)
        got = mega_ops.run_lowering(low, state, regime=regime)
        assert torch.equal(got, schedule_exec_ref(low, state))


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["resident", "streaming"])
def test_megakernel_level_too_wide_to_stage(cuda_device, regime):
    """One Multi-RowCopy level of 600 destinations: more slot records
    than the kernel stages in shared memory, so that level's tables are
    read from device memory, between two staged chunks."""
    from repro_torch.kernels.megakernel.plan import STAGE_SLOTS, plan_for

    fan = STAGE_SLOTS + 88
    prog = Program()
    prog.emit("MAJ", x=3, n_act=4, srcs=(0, 1, 2), dsts=(3,))
    prog.emit("MRC", n_act=8, srcs=(3,), dsts=tuple(range(4, 4 + fan)))
    prog.emit("NOT", srcs=(4 + fan // 2,), dsts=(0,))
    low = lower_schedule(build_schedule(prog))
    assert plan_for(low).chunks[:, 6].tolist() == [1, 0, 1]
    state = _words(fan, 4 + fan, 77, device=cuda_device)
    got = mega_ops.run_lowering(low, state, regime=regime)
    assert torch.equal(got, schedule_exec_ref(low, state))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [7200, 7300])
def test_megakernel_either_side_of_the_shared_memory_limit(cuda_device,
                                                           rows):
    """A strip of 8 columns of a 7,203-row augmented image fits in 227 KB
    of shared memory, one of 7,303 rows does not.  The planner streams
    both (too few columns an SM to stay resident); a forced resident
    launch runs at 7,200 rows and raises at 7,300 before launching."""
    from repro_torch.kernels.megakernel.plan import plan_for, plan_launch

    rng = np.random.default_rng(rows)
    prog = _rand_program(rng, rows=rows, n_ops=40)
    low = lower_schedule(build_schedule(prog))
    state = _words(rows, rows, 40, device=cuda_device)
    assert plan_launch(plan_for(low), rows, 40).regime == "streaming"
    want = schedule_exec_ref(low, state)
    for regime in (None, "streaming") + (("resident",) if rows == 7200
                                         else ()):
        assert torch.equal(mega_ops.run_lowering(low, state, regime=regime),
                           want)
    if rows == 7300:
        before = mega_ops.launches
        with pytest.raises(ValueError, match="shared memory"):
            mega_ops.run_lowering(low, state, regime="resident")
        assert mega_ops.launches == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0,), (1,), (511,), (512,), (513,),
                                   (4099,), (3, 4099), (2**22,)], ids=str)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_mismatch_kernel_matches_plain(cuda_device, shape, offset):
    """Bit-exact count; ``offset`` 1 starts both operands one word into
    their storage, which takes the kernel's single-word path."""
    n = int(np.prod(shape))
    got = _words(n, n + offset, device=cuda_device)[offset:].view(shape)
    want = _words(n + 1, n + offset, device=cuda_device)[offset:].view(shape)
    if n:
        want.view(-1)[::5] = got.view(-1)[::5]
    before = mismatch_ops.launches
    count = mismatch_ops.mismatch_count(got, want)
    assert mismatch_ops.launches == before + 1
    assert count.dtype == torch.int32 and count.device == got.device
    assert int(count) == int(mismatch_ops.mismatch_count_ref(got.cpu(),
                                                             want.cpu()))
    assert int(mismatch_ops.mismatch_count(got, got)) == 0


@pytest.mark.cuda
def test_mismatch_kernel_counts_known_flips(cuda_device):
    rng = np.random.default_rng(3)
    n = 100_003
    pos = rng.choice(n * 32, size=4321, replace=False)
    want = np.zeros(n, np.uint32)
    np.bitwise_or.at(want, pos // 32, (np.uint32(1) << (pos % 32)
                                       ).astype(np.uint32))
    got = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    assert int(mismatch_ops.mismatch_count(
        got, bp.from_u32(want, cuda_device))) == 4321


@pytest.mark.cuda
def test_cuda_success_rate_matches_oracle(cuda_device):
    ctx = ExecutionContext(device="cuda")
    cuda, oracle = get_backend("cuda", ctx), get_backend("oracle", ctx)
    got = _words(5, 7, 3001, device=cuda_device)
    want = got.clone()
    want[2:4] = _words(6, 2, 3001, device=cuda_device)
    with cuda.count_dispatches() as scope:
        rate = cuda.success_rate(got, want)
    assert scope.count == 1
    assert rate == oracle.success_rate(got, want) < 1.0
    assert cuda.success_rate(got, want, n_bits=10**7) == \
        oracle.success_rate(got, want, n_bits=10**7)


@pytest.mark.cuda
def test_session_heal_agrees_across_modes_and_oracle(cuda_device):
    rng = np.random.default_rng(11)
    clean = rng.integers(0, 2**32, (8, 5000), dtype=np.uint32)
    reps = [clean.copy() for _ in range(3)]
    for j, rep in enumerate(reps):
        rep[j, 100 * j:100 * j + 7] ^= np.uint32(1 << j)
    sess = DramSession()
    b = sess.program(rows=32, name="heal")
    groups = [b.input(r) for r in reps]
    voted = b.alloc_rows(8)
    for r in range(8):
        b.maj(*(g[r] for g in groups), dst=voted[r], n_act=32)
    prog, state = b.build(), b.initial_state()
    want = get_backend("oracle", ExecutionContext(device="cuda")).run(
        prog, state)
    fused = sess.run_fused(prog, state)
    mega = sess.run_fused(prog, state, mode="megakernel")
    assert fused.device.type == "cuda"
    assert torch.equal(fused, want) and torch.equal(mega, want)
    tile = mega[list(voted.indices)]
    assert torch.equal(tile.cpu(), bp.from_u32(clean, "cpu"))
    assert int(sess.mismatch(reps[0], tile)) == 7
    assert sess.success_rate(reps[0], tile) == 1 - 7 / (8 * 5000 * 32)


#: NBITS 1/8/32/33 over 2-D and 3-D plane stacks of 1 to 12,297 words,
#: and 32 planes of 2**22 words.
BITSERIAL_CASES = [(n, s) for n in (1, 8, 32, 33)
                   for s in ((1,), (3,), (4099,), (3, 4099))]
BITSERIAL_CASES.append((32, (2**22,)))


@pytest.mark.cuda
@pytest.mark.parametrize("nbits,shape", BITSERIAL_CASES, ids=str)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_bitserial_kernel_matches_plain(cuda_device, nbits, shape, offset):
    """``offset`` 1 starts both operands one word into their storage,
    which takes the kernel's single-word path, as odd word counts do."""
    n = nbits * int(np.prod(shape))
    a = _words(n, n + offset, device=cuda_device)[offset:]
    b = _words(n + 1, n + offset, device=cuda_device)[offset:]
    a, b = a.view(nbits, *shape), b.view(nbits, *shape)
    before = bitserial_ops.launches
    got = bitserial_ops.bitserial_add(a, b)
    assert bitserial_ops.launches == before + 1
    assert torch.equal(got, bitserial_ops.bitserial_add_ref(a, b))
    assert torch.equal(got.cpu(), bitserial_ops.bitserial_add(a.cpu(),
                                                              b.cpu()))


@pytest.mark.cuda
def test_bitserial_kernel_refuses_without_a_launch(cuda_device):
    a = _words(1, 8, 300, device=cuda_device)
    cuda = get_backend("cuda", ExecutionContext(device="cuda"))
    before = bitserial_ops.launches
    for other in (a[:4], a[:, :200], a.view(8, 3, 100)):
        with pytest.raises(ValueError, match="must be equal"):
            bitserial_ops.bitserial_add(a, other.contiguous())
        with pytest.raises(ValueError, match="must be equal"):
            cuda.add_planes(a, other.contiguous())
    assert bitserial_ops.launches == before and cuda.dispatch_count == 0
    with cuda.count_dispatches() as scope:
        out = cuda.add_planes(a, a)
    assert scope.count == 1 and bitserial_ops.launches == before + 1
    assert torch.equal(out, bitserial_ops.bitserial_add_ref(a, a))


@pytest.mark.cuda
def test_add_u32_kernel_matches_numpy(cuda_device):
    rng = np.random.default_rng(20)
    x, y = rng.integers(0, 2**32, (2, 2**20), dtype=np.uint32)
    before = bitserial_ops.launches
    got = bitserial_ops.add_u32(bp.from_u32(x, cuda_device),
                                bp.from_u32(y, cuda_device))
    assert bitserial_ops.launches == before + 1
    assert got.device.type == "cuda"
    assert (bp.to_u32(got) == x + y).all()


def _numpy_op(op, a, b):
    if op == "div":
        return np.where(b == 0, np.uint32(0xFFFFFFFF),
                        a // np.where(b == 0, 1, b)).astype(np.uint32)
    return {"add": np.add, "mul": np.multiply}[op](a, b).astype(np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "mul", "div"])
def test_session_elementwise_agrees_with_oracle(cuda_device, op):
    from repro_torch.compile import build_schedule, compile_elementwise

    rng = np.random.default_rng(len(op))
    a, b = rng.integers(0, 2**32, (2, 3000), dtype=np.uint32)
    b[::7] = 0
    b[1::11] = rng.integers(0, 256, len(b[1::11]), dtype=np.uint32)
    want = _numpy_op(op, a, b)
    sess = DramSession()
    with sess.count_dispatches() as scope:
        out, prog = sess.elementwise(op, a, b, tier=5, n_act=32)
    assert out.device.type == "cuda" and (bp.to_u32(out) == want).all()
    assert scope.count == build_schedule(prog).n_dispatches()
    oracle = get_backend("oracle", ExecutionContext(device="cuda"))
    ref, _ = oracle.elementwise(op, a, b, tier=5, n_act=32)
    assert torch.equal(out, ref)
    cp = compile_elementwise(op, a, b, tier=5, n_act=32)
    with sess.count_dispatches() as scope:
        final = sess.run_fused(cp.program, cp.state, mode="megakernel")
    assert scope.count == 1
    assert torch.equal(cp.outputs(final), out)


def _serve_mix(seed, words=1000):
    """Heals (MAJ3 and MAJ5, flips in one replica), erases of two
    patterns and integrity checks, as numpy specs."""
    from repro_torch import serve

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(4):
        base = rng.integers(0, 2**32, (2 + i % 2, words), dtype=np.uint32)
        reps = np.stack([base] * (5 if i == 3 else 3))
        reps[i % 3].reshape(-1)[rng.choice(base.size, 3 + i,
                                           replace=False)] ^= 1 << 7
        reqs.append(lambda r=reps, i=i: serve.HealRequest(
            replicas=r, tenant=f"h{i}"))
    for i in range(3):
        reqs.append(lambda i=i: serve.EraseRequest(
            rows=5 + 31 * i, words=words,
            pattern=0xDEADBEEF if i < 2 else 7, fanout=31,
            tenant=f"e{i}"))
    for i in range(3):
        live = rng.integers(0, 2**32, (4, words), dtype=np.uint32)
        ref = live.copy()
        ref[0, :i + 1] ^= 0xF
        reqs.append(lambda a=live, b=ref, i=i: serve.IntegrityRequest(
            live=a, reference=b, tenant=f"v{i}"))
    return [make() for make in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("coalesce", [True, False])
def test_service_on_the_card_matches_the_cpu_route(cuda_device, coalesce):
    """``PudService()`` on the card (the default) gives the CPU route's
    results and dispatches, and its dispatches are the kernels'
    launches: MAJX for heals, fan-out for erases, mismatch for each
    heal's ``fixed_bits`` and each check."""
    from repro_torch.serve import PudService, ServiceConfig

    mods = {"majx": majx_ops, "fanout": rowcopy_ops,
            "mismatch": mismatch_ops, "megakernel": mega_ops}
    card = PudService(ServiceConfig(coalesce=coalesce))
    assert card.sessions[0].backend.device.type == "cuda"
    before = {n: m.launches for n, m in mods.items()}
    got = card.serve(_serve_mix(1))
    launches = {n: m.launches - before[n] for n, m in mods.items()}
    cpu = PudService(ServiceConfig(
        coalesce=coalesce, ctx=ExecutionContext(ideal=True, device="cpu")))
    want = cpu.serve(_serve_mix(1))
    for g, w in zip(got, want):
        for field in ("healed", "wiped"):
            if hasattr(w, field):
                assert getattr(g, field).device.type == "cuda"
                assert torch.equal(getattr(g, field).cpu(),
                                   getattr(w, field))
        for field in ("fixed_bits", "mismatch_bits"):
            assert getattr(g, field, None) == getattr(w, field, None)
    assert card.snapshot().dispatches == cpu.snapshot().dispatches == \
        sum(launches.values())
    heal_groups = 2 if coalesce else 4
    erase_groups = 2 if coalesce else 3
    assert launches == {"majx": heal_groups, "fanout": erase_groups,
                        "mismatch": 4 + 3, "megakernel": 0}


@pytest.mark.cuda
def test_tmr_store_restores_a_tree_on_the_card(cuda_device, tmp_path):
    """A tree on the card saves, loses one replica's leaf bytes, and
    restores voted on the card: one MAJX launch a leaf, bit-exact."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.ckpt import tmr_store
    from repro_torch.core import tree as tree_util

    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {"w": torch.randn(64, 96, generator=g, device="cuda").to(
                torch.bfloat16),
            "opt": [torch.randn(333, generator=g, device="cuda"),
                    torch.randint(-128, 127, (10, 33), generator=g,
                                  device="cuda", dtype=torch.int8)],
            "meta": {"n": torch.arange(7, device="cuda",
                                       dtype=torch.int32)}}
    tmr_store.save(tree, str(tmp_path), 5, replicas=3)
    shard = tmp_path / "replica_2" / "step_00000005" / "shard_p0.npz"
    with np.load(shard) as data:
        arrays = {k: data[k].copy() for k in data.files}
    for a in arrays.values():
        a.view(np.uint8).reshape(-1)[::3] ^= 0x5A
    np.savez(shard, **arrays)
    before = majx_ops.launches
    got, step, bad = tmr_store.restore(tree, str(tmp_path),
                                       use_kernel=True)
    leaves, _ = tree_util.flatten(tree)
    assert (step, bad) == (5, 1)
    assert majx_ops.launches - before == len(leaves)
    for a, b in zip(tree_util.flatten(got)[0], leaves):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert tmr_store.scrub(tree, str(tmp_path)) == 1
    again, _ = ckpt.restore(tree, str(tmp_path / "replica_2"))
    for a, b in zip(tree_util.flatten(again)[0], leaves):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


# ------------------------------------------- the device model and the sweep


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(), (7,), (3, 1001), (2**20 + 5,)],
                         ids=str)
def test_rng_on_the_card_equals_the_cpu(cuda_device, shape):
    """Threefry words and floats are the same on the card as on the CPU
    (the CPU's are held to jax in ``test_torch_rng.py``)."""
    from repro_torch.core import rng

    key = rng.fold_in(rng.PRNGKey(3), 77)
    for lo, hi in ((0.0, 1.0), (-0.4, 0.4)):
        card = rng.uniform(key, shape, lo, hi, device=cuda_device)
        assert card.device.type == "cuda"
        assert torch.equal(card.cpu().view(torch.int32),
                           rng.uniform(key, shape, lo, hi, "cpu").view(
                               torch.int32))
    assert torch.equal(rng.random_bits(key, shape, cuda_device).cpu(),
                       rng.random_bits(key, shape, "cpu"))
    assert torch.equal(rng.bernoulli(key, 0.3, shape, cuda_device).cpu(),
                       rng.bernoulli(key, 0.3, shape, "cpu"))


def _subarray_run(device, ideal):
    from repro_torch.core import majx as mj
    from repro_torch.core import rowcopy as rc
    from repro_torch.core.subarray import DeviceProfile, Subarray

    rng = np.random.default_rng(4)
    sa = Subarray(DeviceProfile.mfr_h(), cols=2048 * 32, seed=5,
                  ideal=ideal, device=device)
    sa.fill("random")
    outs = []
    for i, x in enumerate((3, 5, 7, 9)):
        ops = rng.integers(0, 2**32, (x, sa.n_words), dtype=np.uint32)
        outs.append(mj.majx(sa, list(ops), 32, base_row=32 * i).cpu())
    src = rng.integers(0, 2**32, sa.n_words, dtype=np.uint32)
    rc.multi_rowcopy(sa, src, 32, base_row=128)
    rc.frac_init(sa, [300, 301])
    rc.rowclone(sa, 5, 400)
    return outs, sa.planes.cpu(), sa.frac_rows.copy()


@pytest.mark.cuda
@pytest.mark.parametrize("ideal", [True, False],
                         ids=["ideal", "stochastic"])
def test_subarray_on_the_card_equals_the_cpu(cuda_device, ideal):
    card = _subarray_run("cuda", ideal)
    host = _subarray_run("cpu", ideal)
    for a, b in zip(card[0], host[0]):
        assert torch.equal(a, b)
    assert torch.equal(card[1], host[1]) and (card[2] == host[2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("ideal", [True, False],
                         ids=["ideal", "stochastic"])
def test_sim_backend_on_the_card_equals_the_cpu(cuda_device, ideal):
    outs = []
    for dev in ("cuda", "cpu"):
        be = get_backend("sim", ExecutionContext(ideal=ideal, seed=3,
                                                 device=dev))
        planes = _words(1, 5, 3, 300, device=dev)
        got = [be.majx(planes), be.rowcopy(planes[0], 9),
               be.add_planes(planes[:4], planes[1:])]
        outs.append(([g.cpu() for g in got], be.energy_nj_total))
        assert all(g.device.type == dev for g in got)
    (card, e_card), (host, e_host) = outs
    assert all(torch.equal(a, b) for a, b in zip(card, host))
    assert e_card == e_host


@pytest.mark.cuda
def test_sweep_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """The same stochastic grid on the card and the CPU gives the same
    records; on the card each multi-point cuda chunk is one MAJX launch
    and each cuda MRC point one fan-out launch."""
    from repro_torch.sweep import SweepSpec, planner, run_sweep

    spec = SweepSpec(name="card", backends=("sim", "cuda", "oracle"),
                     x_values=(3, 5), n_act=(8, 32),
                     patterns=("random", "0xAA/0x55"), rows=4, words=512,
                     chunk=4)
    mrc = SweepSpec(name="card-mrc", op="mrc", backends=("sim", "cuda"),
                    n_act=(4, 32), patterns=("random", "0xFF"), words=512)
    m0, f0 = majx_ops.launches, rowcopy_ops.launches
    card = run_sweep(spec, str(tmp_path / "card"), device="cuda").records
    fused = sum(1 for c in planner.plan(spec)
                if c.backend == "cuda" and len(c.points) > 1)
    assert majx_ops.launches - m0 == fused > 0
    card_mrc = run_sweep(mrc, str(tmp_path / "card"), device="cuda").records
    assert rowcopy_ops.launches - f0 == 4
    assert card == run_sweep(spec, str(tmp_path / "cpu"),
                             device="cpu").records
    assert card_mrc == run_sweep(mrc, str(tmp_path / "cpu"),
                                 device="cpu").records
    assert all(r["success"] == 1.0 for r in card + card_mrc
               if r["backend"] != "sim")


@pytest.mark.cuda
def test_pud_device_and_erase_on_the_card(cuda_device):
    from repro_torch.pud import secure_erase
    from repro_torch.pud.device import DeviceConfig, PUDDevice

    outs = []
    for dev in ("cuda", "cpu"):
        d = PUDDevice(DeviceConfig(n_banks=2, cols=4096, device=dev), seed=1)
        ops = [_words(i, 128, device=dev) for i in range(3)]
        got = d.majx(1, ops, 8).cpu()
        d.broadcast_fanout(0, ops[0], 40)
        t = secure_erase.erase_subarray(d.subarray(1), 0xA5A5A5A5)
        outs.append((got, d.subarray(0).planes.cpu(),
                     d.subarray(1).planes.cpu(), t, d.stats()))
    (g1, p1, q1, t1, s1), (g2, p2, q2, t2, s2) = outs
    assert torch.equal(g1, g2) and torch.equal(p1, p2)
    assert torch.equal(q1, q2) and t1 == t2 and s1 == s2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint32", "int64"])
def test_vote_words_converts_on_the_card(cuda_device, dtype, monkeypatch):
    """uint32 and int64 replicas on the card become words there: no
    copy to the host and back on the TMR restore path."""
    from repro_torch.pud import tmr

    w = np.random.default_rng(8).integers(0, 2**32, (3, 4097),
                                          dtype=np.uint32)
    reps = torch.from_numpy(w if dtype == "uint32" else
                            w.astype(np.int64) - 2**32).to(cuda_device)
    want = tmr.vote_words(bp.from_u32(w, "cpu"))

    def host_copy(*a, **kw):
        raise AssertionError("the replicas went through the host")

    with monkeypatch.context() as m:
        for obj, name in ((torch.Tensor, "cpu"), (torch.Tensor, "numpy"),
                          (bp, "from_u32")):
            m.setattr(obj, name, host_copy)
        got = tmr.vote_words(reps)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_spice_study_on_the_card_equals_the_cpu(cuda_device):
    """The §7.2 Monte-Carlo study gives the same bits on the card as on
    the CPU (the CPU's is held to the reference in ``test_torch_sim.py``):
    its sums fold in one order, and its means divide on the device."""
    from repro_torch.core import chargeshare as cs
    from repro_torch.core import rng

    key = rng.PRNGKey(0)
    assert cs.spice_study(key, 3001, cuda_device) == \
        cs.spice_study(key, 3001, "cpu")


# ------------------------------------------------------------- LM serving


def _lm_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _lm_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["chatglm3-6b", "musicgen-medium",
                                  "phi-3-vision-4.2b"])
def test_lm_prefill_and_decode_on_the_card_equal_the_cpu(cuda_device, arch):
    """A float32 smoke model's prefill and teacher-forced decode logits on
    the card within 1e-4 of the largest of the CPU's (TF32 off: both
    compute exact float32 products in their own summation order)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params, _ = M.init(0, cfg, device=cuda_device)
    host = _lm_tree(lambda t: t.cpu(), params)
    rng = np.random.default_rng(0)
    tail = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    toks = rng.integers(0, cfg.vocab_size, (2, 12) + tail)
    steps = rng.integers(0, cfg.vocab_size, (2, 4) + tail)

    def run(p, device):
        out = []
        logits, cache = M.prefill(
            p, {"tokens": torch.as_tensor(toks, device=device)}, cfg, 32)
        out.append(logits.cpu())
        for t in range(steps.shape[1]):
            tok = torch.as_tensor(steps[:, t:t + 1], device=device)
            logits, cache = M.decode(p, tok, cache, cfg)
            out.append(logits.cpu())
        return out

    with torch.inference_mode():
        for got, want in zip(run(params, cuda_device), run(host, "cpu")):
            err = (got - want).abs().max() / want.abs().max()
            assert float(err) <= 1e-4


@pytest.mark.cuda
def test_engine_generates_and_heals_on_the_card(cuda_device):
    """``Engine.generate`` on the card gives the CPU engine's tokens for a
    float32 smoke model; ``heal_params`` through the card's service
    (one MAJX and one mismatch launch) restores the clean params bit for
    bit and counts the flipped bits."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core import tree as tree_util
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine, Request

    cfg = dataclasses.replace(get_config("chatglm3-6b", smoke=True),
                              dtype="float32")
    params, _ = M.init(0, cfg, device=cuda_device)
    card = Engine(params, cfg, max_seq=32)
    host = Engine(_lm_tree(lambda t: t.cpu(), params), cfg, max_seq=32,
                  device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (8,)) for _ in range(3)]
    got = card.generate([Request(rid=i, prompt=p, max_new_tokens=4)
                         for i, p in enumerate(prompts)])
    want = host.generate([Request(rid=i, prompt=p, max_new_tokens=4)
                          for i, p in enumerate(prompts)])
    for a, b in zip(got, want):
        assert [int(t) for t in a.out_tokens] == \
            [int(t) for t in b.out_tokens]
    bad = dict(params, ln_f=params["ln_f"].clone())
    bad["ln_f"].view(torch.int32)[3] ^= 0x00F0
    before = (majx_ops.launches, mismatch_ops.launches)
    assert card.heal_params([bad, params, params]) == 4
    assert (majx_ops.launches, mismatch_ops.launches) == \
        (before[0] + 1, before[1] + 1)
    for a, b in zip(tree_util.flatten(card.params)[0],
                    tree_util.flatten(params)[0]):
        assert a.device.type == "cuda"
        assert torch.equal(a.view(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    assert card.verify_params(params) == 1.0


@pytest.mark.cuda
def test_train_steps_on_the_card_match_the_cpu(cuda_device, tmp_path):
    """Two train steps of a float32 smoke model on the card against the
    same steps on the CPU (losses within 1e-4, params within the
    ``2 * lr * steps`` of AdamW's sign noise); the trainer's TMR store
    then votes the card's state through the MAJX kernel, one launch a
    leaf, bit for bit."""
    import dataclasses

    from repro_torch.ckpt import tmr_store
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import tree as tree_util
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import step as train_step

    cfg = dataclasses.replace(get_config("chatglm3-6b", smoke=True),
                              dtype="float32")
    tc = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    host, _ = train_step.init_train_state(0, cfg, device="cpu")
    leaves, structure = tree_util.flatten(host)
    card = tree_util.unflatten(structure,
                               [t.to(cuda_device) for t in leaves])
    step = train_step.make_train_step(cfg, tc)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=4))
    for i in range(2):
        host, want = step(host, data.batch(i))
        card, got = step(card, data.batch(i))
        assert abs(float(got["loss"]) - float(want["loss"])) <= \
            1e-4 * abs(float(want["loss"]))
    assert card.opt.step.dtype == torch.int32 and int(card.opt.step) == 2
    for a, b in zip(tree_util.flatten(card)[0], tree_util.flatten(host)[0]):
        assert a.device.type == "cuda" and a.dtype == b.dtype
    for a, b in zip(tree_util.flatten(card.params)[0],
                    tree_util.flatten(host.params)[0]):
        assert (a.cpu() - b).abs().max() <= 2 * tc.lr * 2
    tmr_store.save(card, str(tmp_path), 2, replicas=3)
    before = majx_ops.launches
    voted, at, bad = tmr_store.restore(card, str(tmp_path), use_kernel=True)
    leaves = tree_util.flatten(card)[0]
    assert (at, bad) == (2, 0)
    assert majx_ops.launches == before + len(leaves)
    for a, b in zip(tree_util.flatten(voted)[0], leaves):
        assert a.device.type == "cuda" and torch.equal(a, b)
