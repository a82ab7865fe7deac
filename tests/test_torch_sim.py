"""The port's behavioural device model against the reference's.

``repro_torch.core.{decoder,subarray,majx,rowcopy,chargeshare}``,
``repro_torch.backends.sim``, ``repro_torch.pud.device`` and
``repro_torch.pud.secure_erase`` are held to their ``repro``
counterparts on the CPU: planes, row buffers, Frac flags and command
times bit for bit, with ``ideal=True`` and with the stochastic error
model (``ideal=False``).  The stochastic masks fold Python's salted
``hash`` of string salts into their keys, as the reference does, so they
repeat the reference's only within one process — which is where these
tests compare them; the last test pins that fault of the reference.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import ExecutionContext as RefContext
from repro.backends import get_backend as ref_backend
from repro.core import chargeshare as ref_cs
from repro.core import commands as ref_cmd
from repro.core import decoder as ref_dec
from repro.core import majx as ref_mj
from repro.core import rowcopy as ref_rc
from repro.core import subarray as ref_sa
from repro.pud import device as ref_device
from repro.pud import isa as ref_isa
from repro.pud import secure_erase as ref_erase
from repro_torch.backends import ExecutionContext, get_backend
from repro_torch.core import bitplanes as bp
from repro_torch.core import chargeshare as cs
from repro_torch.core import commands as cmd
from repro_torch.core import decoder as dec
from repro_torch.core import majx as mj
from repro_torch.core import rng
from repro_torch.core import rowcopy as rc
from repro_torch.core import subarray as sa_mod
from repro_torch.pud import device as device_mod
from repro_torch.pud import secure_erase
from repro_torch.pud.isa import Program

MFRS = ["H", "M", "S"]
IDEAL = pytest.mark.parametrize("ideal", [True, False],
                                ids=["ideal", "stochastic"])


def u32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return bp.to_u32(x)
    return np.asarray(x).astype(np.uint32)


def pair(mfr, cols, *, seed=0, ideal=False, **kw):
    """The reference's and the port's subarray, built alike (CPU)."""
    ref = ref_sa.Subarray(getattr(ref_sa.DeviceProfile, f"mfr_{mfr.lower()}")
                          (), cols, seed=seed, ideal=ideal, **kw)
    port = sa_mod.Subarray(getattr(sa_mod.DeviceProfile,
                                   f"mfr_{mfr.lower()}")(), cols, seed=seed,
                           ideal=ideal, device="cpu", **kw)
    return ref, port


def same_state(ref, port) -> None:
    assert (u32(ref.planes) == u32(port.planes)).all()
    assert (u32(ref.row_buffer) == u32(port.row_buffer)).all()
    assert (ref.frac_rows == port.frac_rows).all()
    assert ref.open_rows == port.open_rows
    assert ref.buffer_valid == port.buffer_valid
    assert ref.elapsed_ns == port.elapsed_ns


# ------------------------------------------------------------- decoder


@pytest.mark.parametrize("rows", [512, 1024, 64])
def test_decoder_equals_reference(rows):
    r, p = ref_dec.RowDecoder.for_subarray(rows), \
        dec.RowDecoder.for_subarray(rows)
    assert [(s.name, s.lo, s.hi) for s in r.predecoders] == \
        [(s.name, s.lo, s.hi) for s in p.predecoders]
    g = np.random.default_rng(rows)
    for a, b in g.integers(0, rows, (200, 2)):
        assert r.apa_activated_rows(a, b) == p.apa_activated_rows(a, b)
        assert r.split_predecoders(a, b) == p.split_predecoders(a, b)
    for n in (1, 2, 4, 8, 16, 32, 3, 64):
        for base in (0, 5, rows - 1):
            try:
                want = r.row_group(n, base)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)[:20]):
                    p.row_group(n, base)
                continue
            assert p.row_group(n, base) == want
    assert dec.fig14_example() == ref_dec.fig14_example() == (0, 1, 6, 7)
    assert dec.fig13_32row_example() == ref_dec.fig13_32row_example()


# ------------------------------------------------------------ subarray


def test_fill_random_is_jax_bits_where_the_reference_raises():
    """Pins a fault of the reference (ROADMAP queue 3): its
    ``fill("random")`` calls ``randint`` over uint32 with ``maxval =
    1 << 32``, which raises ``OverflowError`` under jax 0.9.0.  The port
    draws the uniform words meant, as ``jax.random.bits`` gives them under
    the subarray's next key."""
    ref, port = pair("H", 2048, seed=7)
    with pytest.raises(OverflowError, match="maxval"):
        ref.fill("random")
    port.fill("random")
    sub = jax.random.split(jax.random.PRNGKey(7))[1]
    want = jax.random.bits(sub, (512, 64), jnp.uint32)
    assert (u32(port.planes) == np.asarray(want)).all()
    key = rng.PRNGKey(99)
    port.fill("random", key=key)
    assert (u32(port.planes) == np.asarray(jax.random.bits(
        jax.random.PRNGKey(99), (512, 64), jnp.uint32))).all()


@pytest.mark.parametrize("pattern", ["0x00", "0xFF", "0xAA", "0x55", "0xCC",
                                     "0x33", "0x66", "0x99"])
def test_fill_patterns_equal_reference(pattern):
    ref, port = pair("M", 96)
    ref.fill(pattern)
    port.fill(pattern)
    same_state(ref, port)


def _ops(g, x, words):
    return [g.integers(0, 2**32, words, dtype=np.uint32) for _ in range(x)]


def outcome(fn):
    """``fn()``'s result as uint32 words (or as it is), or its error."""
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)
    if isinstance(out, (torch.Tensor, jax.Array)):
        return u32(out).tolist()
    return out


@IDEAL
@pytest.mark.parametrize("mfr", MFRS)
def test_subarray_sequences_bit_exact(mfr, ideal):
    """MAJX at every arity and activation level, Multi-RowCopy, Frac,
    RowClone, a raw APA over an even row set (ties), a SiMRA write
    through open rows, then plain ACT/RD/PRE — the same results (or the
    same refusal: Mfr S has no Frac) and state after each."""
    ref, port = pair(mfr, 1024, seed=3, ideal=ideal, temp_c=70.0)
    g = np.random.default_rng(11)
    base = 0
    for x, n in ((3, 4), (3, 32), (5, 8), (7, 16), (9, 32)):
        ops = _ops(g, x, port.n_words)
        want = outcome(lambda: ref_mj.majx(
            ref, [jnp.asarray(o) for o in ops], n, base_row=base,
            pattern="0xAA/0x55"))
        assert outcome(lambda: mj.majx(port, ops, n, base_row=base,
                                       pattern="0xAA/0x55")) == want
        same_state(ref, port)
        base = (base + 64) % 448
    src = g.integers(0, 2**32, port.n_words, dtype=np.uint32)
    assert ref_rc.multi_rowcopy(ref, jnp.asarray(src), 16, base_row=256) \
        == rc.multi_rowcopy(port, src, 16, base_row=256)
    same_state(ref, port)
    assert outcome(lambda: rc.frac_init(port, [300, 301, 302])) == \
        outcome(lambda: ref_rc.frac_init(ref, [300, 301, 302]))
    ref_rc.rowclone(ref, 7, 390)
    rc.rowclone(port, 7, 390)
    same_state(ref, port)
    ref.run(ref_cmd.apa(0, 7, 1.5, 3.0))          # 4 rows: an even tie
    port.run(cmd.apa(0, 7, 1.5, 3.0))
    same_state(ref, port)
    data = g.integers(0, 2**32, port.n_words, dtype=np.uint32)
    ref.run(ref_cmd.apa_with_wr(127, 128, 3.0, 3.0, data))
    port.run(cmd.apa_with_wr(127, 128, 3.0, 3.0, data))
    same_state(ref, port)
    ref.run(ref_cmd.CommandSeq().act(9, 40.0).rd(9).pre(15.0))
    port.run(cmd.CommandSeq().act(9, 40.0).rd(9).pre(15.0))
    same_state(ref, port)
    assert (u32(port.read_row(9)) == u32(ref.read_row(9))).all()
    assert (port.read_row_bits(9).numpy() ==
            np.asarray(ref.read_row_bits(9))).all()


@IDEAL
def test_success_measurements_equal_reference(ideal):
    g = np.random.default_rng(5)
    for x, n in ((3, 4), (5, 32), (9, 16)):
        ref, port = pair("H", 2048, seed=x, ideal=ideal)
        ops = _ops(g, x, port.n_words)
        assert mj.majx_success_measured(port, ops, n) == \
            ref_mj.majx_success_measured(ref, [jnp.asarray(o) for o in ops],
                                         n)
    ref, port = pair("H", 2048, seed=1, ideal=ideal)
    src = g.integers(0, 2**32, port.n_words, dtype=np.uint32)
    assert rc.mrc_success_measured(port, src, 32) == \
        ref_rc.mrc_success_measured(ref, jnp.asarray(src), 32)


def test_and_or_via_maj3_equal_reference():
    ref, port = pair("H", 256, ideal=True)
    g = np.random.default_rng(1)
    a, b = _ops(g, 2, port.n_words)
    assert (u32(mj.and_via_maj3(port, a, b)) == (a & b)).all()
    assert (u32(mj.or_via_maj3(port, a, b)) == (a | b)).all()
    assert (u32(ref_mj.and_via_maj3(ref, jnp.asarray(a), jnp.asarray(b)))
            == (a & b)).all()
    with pytest.raises(ValueError, match="odd"):
        mj.majx(port, [a, b], 4)


def test_write_bits_and_tensor_operands():
    _, port = pair("H", 100, ideal=True)
    bits = np.random.default_rng(2).integers(0, 2, 100).astype(bool)
    port.write_row_bits(3, bits)
    assert (port.read_row_bits(3).numpy() == bits).all()
    with pytest.raises(TypeError, match="int32"):
        port.write_row(4, torch.zeros(4, dtype=torch.int64))


# ---------------------------------------------------------- charge share


def test_spice_study_equals_reference():
    """Draws word for word; the float32 sums round in another order, so
    deviations agree to 1e-6, and every success count is equal."""
    iters = 2000
    want = ref_cs.spice_study(jax.random.PRNGKey(0), iters)
    got = cs.spice_study(rng.PRNGKey(0), iters, "cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k]["dev_mean"] == pytest.approx(want[k]["dev_mean"],
                                                   abs=1e-6)
        assert got[k]["dev_std"] == pytest.approx(want[k]["dev_std"],
                                                  abs=1e-6)
        assert round(got[k]["success_rate"] * iters) == \
            round(want[k]["success_rate"] * iters)
    for n in (4, 8, 16, 32):
        assert cs.deviation_mean(n) == ref_cs.deviation_mean(n)
        assert cs.maj3_cell_charges(n, "cpu").tolist() == \
            np.asarray(ref_cs.maj3_cell_charges(n)).tolist()
    assert cs.CB_OVER_CC == ref_cs.CB_OVER_CC


# -------------------------------------------------------------- backend


def _program(words):
    """MAJ, NOT, COPY, MRC, FRAC, WR and RD over a 24-row image."""
    prog = Program()
    prog.emit("MAJ", x=3, n_act=32, srcs=(0, 1, 2), dsts=(10,))
    prog.emit("NOT", srcs=(10,), dsts=(11,))
    prog.emit("COPY", srcs=(3,), dsts=(12,))
    prog.emit("MRC", n_act=8, srcs=(4,), dsts=tuple(range(13, 20)))
    prog.emit("FRAC", dsts=(20,))
    prog.emit("WR", dsts=(21,))
    prog.emit("RD", srcs=(21,))
    prog.emit("MAJ", x=5, n_act=16, srcs=(0, 1, 2, 3, 4), dsts=(22,))
    return prog


@IDEAL
@pytest.mark.parametrize("mfr", MFRS)
def test_sim_backend_bit_exact(mfr, ideal):
    ref = ref_backend("sim", RefContext(mfr=mfr, ideal=ideal, seed=2))
    port = get_backend("sim", ExecutionContext(mfr=mfr, ideal=ideal, seed=2,
                                               device="cpu"))
    caps, ref_caps = port.capabilities().__dict__, ref.capabilities().__dict__
    assert caps == {k: ref_caps[k] for k in caps}   # less TPU VMEM budget
    assert caps["device_model"] and not caps["accelerated"]
    g = np.random.default_rng(3)
    planes = g.integers(0, 2**32, (5, 3, 24), dtype=np.uint32)
    src = g.integers(0, 2**32, (2, 24), dtype=np.uint32)
    a, b = (g.integers(0, 2**32, (4, 24), dtype=np.uint32) for _ in "ab")
    state = g.integers(0, 2**32, (24, 24), dtype=np.uint32)
    ref_prog = ref_isa.Program.from_json(_program(24).to_json())
    # Mfr S has no Frac: every MAJX with neutral rows is refused alike.
    for run_port, run_ref in (
            (lambda: port.majx(planes), lambda: ref.majx(planes)),
            (lambda: port.majx(planes[:3], n_act=8),
             lambda: ref.majx(planes[:3], n_act=8)),
            (lambda: port.rowcopy(src, 40), lambda: ref.rowcopy(src, 40)),
            (lambda: port.add_planes(a, b), lambda: ref.add_planes(a, b)),
            (lambda: int(port.mismatch(a, b)),
             lambda: int(ref.mismatch(a, b))),
            (lambda: port.run(_program(24), state),
             lambda: ref.run(ref_prog, state)),
            (lambda: port.run_fused(_program(24), state),
             lambda: ref.run_fused(ref_prog, state))):
        assert outcome(run_port) == outcome(run_ref)
    assert port.energy_nj_total == pytest.approx(ref.energy_nj_total,
                                                 rel=1e-12)
    assert port.dispatch_count == ref.dispatch_count == 0


def test_sim_runs_on_the_context_device_by_default():
    be = get_backend("sim")
    assert be.device.type == "cuda"
    with pytest.raises(ValueError, match="tensor on cpu"):
        be.majx(torch.zeros((3, 4), dtype=torch.int32))


# ----------------------------------------------------- device and erase


@IDEAL
def test_pud_device_equals_reference(ideal):
    cfg = dict(n_banks=2, subarrays_per_bank=2, cols=512, ideal=ideal)
    ref = ref_device.PUDDevice(ref_device.DeviceConfig(**cfg), seed=4)
    port = device_mod.PUDDevice(device_mod.DeviceConfig(**cfg,
                                                        device="cpu"),
                                seed=4)
    assert port.n_subarrays == ref.n_subarrays == 4
    g = np.random.default_rng(6)
    ops = _ops(g, 5, 16)
    assert (u32(port.majx(1, ops, 16)) ==
            u32(ref.majx(1, [jnp.asarray(o) for o in ops], 16))).all()
    src = g.integers(0, 2**32, 16, dtype=np.uint32)
    assert port.multi_rowcopy(0, src, 8) == \
        ref.multi_rowcopy(0, jnp.asarray(src), 8)
    port.rowclone(0, 1, 200)
    ref.rowclone(0, 1, 200)
    assert port.broadcast_fanout(1, src, 70) == \
        ref.broadcast_fanout(1, jnp.asarray(src), 70)
    for s_ref, s_port in zip(ref.subarrays, port.subarrays):
        same_state(s_ref, s_port)
    assert port.stats() == ref.stats()


@pytest.mark.parametrize("strategy,n_act", [("rowclone", 32), ("frac", 32),
                                            ("mrc", 2), ("mrc", 8),
                                            ("mrc", 32)])
def test_destruction_model_equals_reference(strategy, n_act):
    assert secure_erase.destruction_time_ns(strategy, n_act) == \
        ref_erase.destruction_time_ns(strategy, n_act)
    assert secure_erase.speedup_over_rowclone(strategy, n_act) == \
        ref_erase.speedup_over_rowclone(strategy, n_act)


@IDEAL
@pytest.mark.parametrize("n_act", [8, 32])
def test_erase_subarray_equals_reference(ideal, n_act):
    ref, port = pair("H", 256, seed=2, ideal=ideal)
    g = np.random.default_rng(n_act)
    for r in range(0, 512, 37):
        row = g.integers(0, 2**32, port.n_words, dtype=np.uint32)
        ref.write_row(r, jnp.asarray(row))
        port.write_row(r, row)
    assert secure_erase.erase_subarray(port, 0xDEADBEEF, n_act) == \
        ref_erase.erase_subarray(ref, 0xDEADBEEF, n_act)
    same_state(ref, port)


# ----------------------------------------------- the reference's hash salt


_SALT_PROBE = """
import numpy as np, sys
sys.path.insert(0, {src!r})
from repro_torch.core import bitplanes as bp, majx as mj
from repro_torch.core.subarray import Subarray
sa = Subarray(cols=1024, seed=1, device="cpu")
ops = [np.full(32, v, np.uint32) for v in (0xF0F0F0F0, 0xFF00FF00, 0)]
print(bp.to_u32(mj.majx(sa, ops, 32)).tobytes().hex())
"""


def test_stochastic_masks_follow_the_process_hash_salt():
    """Pins the reference's salt fault (ROADMAP queue 3), which the port
    mirrors: ``_stable_mask`` folds ``hash("apa") & 0x7FFFFFFF`` into the
    key, so the same stochastic MAJX repeats under one
    ``PYTHONHASHSEED`` and differs under another."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")

    def run(seed):
        env = dict(os.environ, PYTHONHASHSEED=str(seed))
        return subprocess.run([sys.executable, "-c",
                               _SALT_PROBE.format(src=src)],
                              env=env, capture_output=True, text=True,
                              check=True).stdout
    assert run(1) == run(1)
    assert run(1) != run(2)
