"""The port's serving engine and its launcher against the reference's.

Weights are drawn by the reference and carried across with
``params_from_jax``; prompts come from a numpy seed.  The reference's
engine integrity work runs on ``oracle``; the port's on ``cuda`` under
``ExecutionContext(device="cpu")`` (every kernel wrapper takes its plain
version) and on ``oracle``.  Generation is compared token for token on
float32 copies of the smoke configs; the heal and verify hooks bit for
bit (tiles, ``fixed_bits``, healed leaves, rates, tenant counts).
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
import warnings
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.launch import serve as ref_launch
from repro.models import model as RM
from repro.serve.admission import ArenaExhaustedError as RefArenaExhausted
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro_torch.backends import ExecutionContext
from repro_torch.configs.registry import get_config
from repro_torch.core import tree as tree_util
from repro_torch.interop import params_from_jax
from repro_torch.serve import PudService, ServiceConfig
from repro_torch.serve.admission import ArenaExhaustedError
from repro_torch.serve.engine import (HEAL_TILE_WORDS, Engine,
                                      IntegrityContextError,
                                      IntegrityContextWarning, Request)

CPU = ExecutionContext(device="cpu", ideal=True)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def lm_engines(arch, seed=0, max_seq=64, dtype="float32"):
    """(reference engine, port engine, config) over the same weights."""
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype)
    pcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    rp, _ = RM.init(jax.random.PRNGKey(seed), rcfg)
    pp = params_from_jax(jax.tree.map(np.asarray, rp), "cpu")
    return (RefEngine(rp, rcfg, max_seq=max_seq, pud_backend="oracle"),
            Engine(pp, pcfg, max_seq=max_seq, device="cpu"), rcfg)


def prompts(cfg, seed, lengths):
    rng = np.random.default_rng(seed)
    tail = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    return [rng.integers(0, cfg.vocab_size, (n,) + tail, dtype=np.int32)
            for n in lengths]


def tiny_params():
    """The reference conftest's 2-leaf tree for heal-only engines."""
    return {"w": np.linspace(-1, 1, 32, dtype=np.float32).reshape(4, 8),
            "b": np.arange(6, dtype=np.float32)}


def tiny_engines(port_backend="cuda", **kw):
    params = tiny_params()
    ref = RefEngine(params, ref_config("xlstm-125m", smoke=True),
                    pud_backend="oracle", **kw.pop("ref", {}))
    ctx = kw.pop("pud_ctx", CPU)
    port = Engine(tiny_params(), get_config("xlstm-125m", smoke=True),
                  pud_backend=port_backend, pud_ctx=ctx, device="cpu", **kw)
    return ref, port, params


# ------------------------------------------------------------- generate


@pytest.mark.parametrize("arch", ["chatglm3-6b", "gemma-7b",
                                  "musicgen-medium", "phi-3-vision-4.2b",
                                  "mixtral-8x22b", "qwen3-moe-235b-a22b",
                                  "zamba2-1.2b", "xlstm-125m"])
def test_generate_gives_the_reference_tokens(arch):
    """Mixed prompt lengths (two prefill groups, continuous batching) and
    an eos id: every request's tokens equal the reference's.  A hybrid's
    prompts are multiples of its ``ssm_chunk`` (8 at smoke size), which
    the reference's Mamba2 needs."""
    ref, port, cfg = lm_engines(arch)
    lengths = ((16, 8, 16, 8, 16) if cfg.family == "hybrid"
               else (9, 6, 9, 6, 9))
    ps = prompts(cfg, 0, lengths)
    # Request 0's second token in the same batches (an MoE's capacity
    # dispatch routes a token by its whole batch, so a request served
    # alone may choose other tokens).
    first = ref.generate([RefRequest(rid=i, prompt=p, max_new_tokens=2)
                          for i, p in enumerate(ps)])
    eos = int(np.asarray(first[0].out_tokens[1]).flat[0])
    want = ref.generate([RefRequest(rid=i, prompt=p, max_new_tokens=5,
                                    eos_id=eos if i == 0 else None)
                         for i, p in enumerate(ps)])
    got = port.generate([Request(rid=i, prompt=p, max_new_tokens=5,
                                 eos_id=eos if i == 0 else None)
                         for i, p in enumerate(ps)])
    for a, b in zip(got, want):
        assert a.done and b.done
        assert np.array_equal(np.array(a.out_tokens), np.array(b.out_tokens))
    assert len(got[0].out_tokens) == 2  # stopped at its eos


def test_generate_is_deterministic_and_greedy():
    _, port, cfg = lm_engines("gemma-7b", max_seq=32)
    ps = prompts(cfg, 2, (8, 8, 8))
    out1 = port.generate([Request(rid=i, prompt=p, max_new_tokens=6)
                          for i, p in enumerate(ps)])
    out2 = port.generate([Request(rid=i, prompt=p.copy(), max_new_tokens=6)
                          for i, p in enumerate(ps)])
    for a, b in zip(out1, out2):
        assert [int(t) for t in a.out_tokens] == [int(t) for t in b.out_tokens]
    from repro_torch.models import model as PM
    logits, _ = PM.forward(port.params, {"tokens": torch.as_tensor(
        ps[0][None])}, port.cfg)
    assert int(out1[0].out_tokens[0]) == int(logits[0, -1].argmax())


# ------------------------------------------------------------- packing


def test_pack_pytree_and_heal_on_the_list_shaped_ssm_tree():
    """xlstm's blocks are a list of unlike dicts: the packed tile and a
    heal of three replicas equal the reference's."""
    ref, port, _ = lm_engines("xlstm-125m", dtype="bfloat16")
    clean = jax.tree.map(np.asarray, ref.params)
    want = ref._pack_pytree(clean)
    got = port._pack_pytree(params_from_jax(clean, "cpu"))
    assert np.array_equal(got[0], np.asarray(want[0])) and \
        got[2:] == want[2:]
    bad = jax.tree.map(lambda a: a.copy(), clean)
    bad["blocks"][1]["mix"]["r_h"].view(np.uint16).reshape(-1)[4] ^= 0x0101
    port = Engine(params_from_jax(clean, "cpu"),
                  get_config("xlstm-125m", smoke=True), pud_backend="cuda",
                  pud_ctx=CPU, device="cpu")
    assert port.heal_params([params_from_jax(t, "cpu")
                             for t in (bad, clean, clean)]) == \
        ref.heal_params([bad, clean, clean]) == 2
    assert isinstance(port.params["blocks"], list)
    for a, b in zip(tree_util.flatten(port.params)[0],
                    jax.tree.leaves(clean)):
        assert a.view(torch.uint8).numpy().tobytes() == b.tobytes()


def test_pack_pytree_tiles_equal_the_reference():
    """bfloat16 and float32 leaves of a smoke model, plus odd-sized 1-
    and 2-byte leaves, pack to the reference's tile word for word."""
    ref, port, _ = lm_engines("chatglm3-6b", dtype="bfloat16")
    tree = jax.tree.map(np.asarray, ref.params)
    rng = np.random.default_rng(3)
    tree["extra"] = {"i8": rng.integers(-128, 128, 13, dtype=np.int8),
                     "f16": rng.standard_normal(7).astype(np.float16),
                     "u8": rng.integers(0, 256, (3, 3), dtype=np.uint8)}
    want = ref._pack_pytree(tree)
    got = port._pack_pytree(params_from_jax(tree, "cpu"))
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert got[0].dtype == np.uint32
    assert got[2:] == want[2:]
    assert got[3] == min(HEAL_TILE_WORDS, got[2])
    assert [m[0] for m in got[1]] == [m[0] for m in want[1]]
    assert [tuple(m[1]) for m in got[1]] == [tuple(m[1]) for m in want[1]]


# ------------------------------------------------------------- heal / verify


@pytest.mark.parametrize("port_backend", ["cuda", "oracle"])
def test_heal_and_verify_equal_the_reference(port_backend):
    """A bfloat16 smoke model with bits flipped in two leaves of replica
    0 and one leaf of replica 2: fixed bits, healed leaves, verify rates
    and the tenant's counts equal the reference's."""
    ref, _, cfg = lm_engines("musicgen-medium", dtype="bfloat16")
    clean = jax.tree.map(np.asarray, ref.params)
    port = Engine(params_from_jax(clean, "cpu"),
                  get_config("musicgen-medium", smoke=True),
                  pud_backend=port_backend, pud_ctx=CPU, device="cpu")
    bad0 = jax.tree.map(lambda a: a.copy(), clean)
    bad2 = jax.tree.map(lambda a: a.copy(), clean)
    bad0["embed"]["tok"].view(np.uint16).reshape(-1)[[3, 70, 71]] ^= 0x8001
    bad0["blocks"]["ln2"].view(np.uint32).reshape(-1)[5] ^= 0xFFFF
    bad2["head"]["w"].view(np.uint16).reshape(-1)[9] ^= 0x0100
    want = ref.heal_params([bad0, clean, bad2])
    got = port.heal_params([params_from_jax(t, "cpu")
                            for t in (bad0, clean, bad2)])
    assert got == want == 3 * 2 + 16
    for a, b in zip(tree_util.flatten(port.params)[0],
                    jax.tree.leaves(ref.params)):
        assert tuple(a.shape) == b.shape
        assert a.view(torch.uint8).numpy().tobytes() == \
            np.asarray(b).tobytes()
    rates = [port.verify_params(params_from_jax(tree, "cpu"))
             for tree in (clean, bad0, bad2)]
    assert rates == [ref.verify_params(t) for t in (clean, bad0, bad2)]
    assert rates[0] == 1.0 > rates[1] and rates[2] < 1.0
    assert port.pud_decisions[-1] is not None
    ref_t = ref.service.snapshot().tenants["engine"]
    port_t = port.service.snapshot().tenants["engine"]
    assert port_t["completed"] == ref_t["completed"] == 4  # 1 heal, 3 checks


def test_tiny_engine_heals_and_verifies_like_the_reference():
    ref, port, params = tiny_engines()
    bad = {k: v.copy() for k, v in params.items()}
    bad["w"][0, 0] = np.float32(99.0)  # silent corruption in one replica
    want = ref.heal_params([bad, params, params])
    got = port.heal_params([bad, params, params])
    assert got == want > 0
    assert port.verify_params(params) == ref.verify_params(params) == 1.0
    assert (port.params["w"].numpy() == params["w"]).all()
    assert port.service.snapshot().tenants["engine"]["completed"] == 2


def test_engine_warns_on_non_ideal_context():
    _, port, params = tiny_engines(
        port_backend="oracle",
        pud_ctx=ExecutionContext(device="cpu", ideal=False))
    with pytest.warns(IntegrityContextWarning, match="non-ideal"):
        port.heal_params([params, params, params])


def test_engine_strict_integrity_raises():
    _, port, params = tiny_engines(
        port_backend="oracle",
        pud_ctx=ExecutionContext(device="cpu", ideal=False),
        strict_integrity=True)
    with pytest.raises(IntegrityContextError, match="fidelity studies"):
        port.heal_params([params, params, params])


def test_engine_ideal_context_is_silent():
    _, port, params = tiny_engines(port_backend="oracle")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port.heal_params([params, params, params])


def test_engines_can_share_one_service():
    svc = PudService(ServiceConfig(backend="cuda", ctx=CPU))
    cfg = get_config("xlstm-125m", smoke=True)
    params = tiny_params()
    a = Engine(params, cfg, pud_service=svc, tenant="engine-a")
    b = Engine(params, cfg, pud_service=svc, tenant="engine-b")
    assert a.service is svc and b.service is svc
    a.heal_params([params, params, params])
    b.heal_params([params, params, params])
    tenants = svc.snapshot().tenants
    assert tenants["engine-a"]["completed"] == 1
    assert tenants["engine-b"]["completed"] == 1
    assert svc.cache.stats.hits >= 1       # second vote reused the schedule


def test_default_engine_service_refuses_a_heal_over_1024_rows():
    """The engine's own service keeps the default 4096-row tenant arena,
    and a heal of x=3 replicas charges 4 rows a tile row: any tree over
    1024 x 4096 words (16 MiB) is refused, in both packages: a model's
    heal needs a shared service with a larger ``tenant_rows``."""
    params = {"w": np.zeros(1024 * HEAL_TILE_WORDS + 1, np.float32)}
    cfg = get_config("xlstm-125m", smoke=True)
    ref = RefEngine(params, ref_config("xlstm-125m", smoke=True),
                    pud_backend="oracle")
    with pytest.raises(RefArenaExhausted):
        ref.heal_params([params, params, params])
    port = Engine(params, cfg, pud_backend="oracle", pud_ctx=CPU,
                  device="cpu")
    with pytest.raises(ArenaExhaustedError):
        port.heal_params([params, params, params])


def test_engine_runs_on_the_card_unless_told_otherwise():
    eng = Engine(tiny_params(), get_config("xlstm-125m", smoke=True))
    assert eng.device.type == "cuda"
    assert eng.service.ctx.device == "cuda"
    assert eng.pud.backend.name == "cuda"


# ------------------------------------------------------------- launcher


def test_launch_serve_smoke_on_the_cpu():
    """``python -m repro_torch.launch.serve --smoke --device cpu`` prints
    the reference launcher's lines (the token ids differ: each package
    draws its own weights)."""
    argv = ["--arch", "chatglm3-6b", "--smoke", "--requests", "3",
            "--prompt-len", "6", "--max-new", "4", "--max-seq", "16"]
    env = {**os.environ, "PYTHONPATH": SRC}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv,
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert ref_launch.main(argv) == 0
    got, want = proc.stdout.splitlines(), buf.getvalue().splitlines()
    assert len(got) == len(want) == 3
    assert got[0].split(" in ")[0] == want[0].split(" in ")[0] == \
        "[serve] chatglm3-smoke: 3 requests, 12 tokens"
    for g, w in zip(got[1:], want[1:]):
        assert g.split(":")[0] == w.split(":")[0]
        assert len(json.loads(g.split(":")[1].split("...")[0])) == 4


def test_launch_serve_zamba2_smoke_on_the_cpu():
    """The hybrid family through the launcher (16-token prompts: a
    multiple of the smoke config's ``ssm_chunk``)."""
    argv = ["--arch", "zamba2-1.2b", "--smoke", "--requests", "2",
            "--prompt-len", "16", "--max-new", "3", "--max-seq", "32"]
    env = {**os.environ, "PYTHONPATH": SRC}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv,
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = proc.stdout.splitlines()
    assert got[0].startswith("[serve] zamba2-smoke: 2 requests, 6 tokens")
    assert len(got) == 3


def test_arena_releases_model_sized_reservations_in_linear_time():
    """A heal of a model's params reserves (x + 1) rows a tile row in its
    tenant's arena and a verify then reuses half of them; releasing the
    verify's 300k rows while 300k sit on the free list must not test
    each row against the list (the reference's check is quadratic: it
    would take minutes here)."""
    import time

    from repro_torch.session.rows import RowAllocationError, RowAllocator

    arena = RowAllocator(2**22, name="arena[engine]")
    heal = arena.alloc(600_000, tag="heal")
    arena.free(heal)
    verify = arena.alloc(300_000, tag="verify")
    t0 = time.perf_counter()
    arena.free(verify)
    assert time.perf_counter() - t0 < 10.0
    assert arena.in_use == 0 and len(arena.free_rows) == 600_000
    with pytest.raises(RowAllocationError, match="double free"):
        arena.free(verify[0])
