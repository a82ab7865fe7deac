"""The port's configs, sharding rules and LM stack against the reference's.

Weights are drawn by the reference (``M.init`` with a ``PRNGKey``) and
carried across with ``repro_torch.interop.params_from_jax``; inputs come
from a numpy seed.  Tolerances, as a share of the largest |value| of the
reference's output:

* float32 copies of the configs: 1e-4 (both packages compute exact
  float32 products; only the summation order differs, and what is seen
  is below 2e-6);
* the configs' own bfloat16: 3e-2 (an 8-bit significand; JAX and torch
  on the CPU round bfloat16 products and sums in different places, and
  what is seen at two layers is 0.7-1.3e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.configs import shapes as ref_shapes
from repro.dist import sharding as ref_sharding
from repro.models import attention as RA
from repro.models import common as RC
from repro.models import mlp as RMLP
from repro.models import model as RM
from repro_torch.configs import base as port_base
from repro_torch.configs import registry as port_registry
from repro_torch.configs import shapes as port_shapes
from repro_torch.core import tree as tree_util
from repro_torch.dist import sharding as port_sharding
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models import attention as PA
from repro_torch.models import common as PC
from repro_torch.models import mlp as PMLP
from repro_torch.models import model as PM

#: The reference's model functions, compiled once a config and shape.
R_FORWARD = jax.jit(RM.forward, static_argnums=2)
R_PREFILL = jax.jit(RM.prefill, static_argnums=(2, 3))
R_DECODE = jax.jit(RM.decode, static_argnums=3)

F32_TOL = 1e-4
BF16_TOL = 3e-2
#: The smoke configs the forward / prefill / decode parity covers:
#: GQA with partial RoPE, tied embeddings with ``embed_scale`` and GeGLU,
#: a larger vocabulary, a wider GQA group, codebooks, and patches.
LM_ARCHS = ("chatglm3-6b", "gemma-7b", "glm4-9b", "deepseek-coder-33b",
            "musicgen-medium", "phi-3-vision-4.2b")


def rel_err(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / np.abs(want).max())


def small_cfg(**kw):
    base = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=128)
    base.update(kw)
    return ref_base.ModelConfig(**base), port_base.ModelConfig(**base)


def both(tree):
    """(jax tree, port tree on the CPU) of a numpy tree."""
    return (jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu"))


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_configs_equal_the_reference(arch, smoke):
    ref = ref_registry.get_config(arch, smoke=smoke)
    port = port_registry.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.n_params() == ref.n_params()
    assert port.n_active_params() == ref.n_active_params()
    assert (port.hd, port.q_groups, port.is_moe) == \
        (ref.hd, ref.q_groups, ref.is_moe)
    assert str(port.compute_dtype).removeprefix("torch.") == \
        str(ref.compute_dtype)


def test_registry_shapes_and_train_config_equal_the_reference():
    assert port_registry.ARCH_IDS == ref_registry.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in port_shapes.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_shapes.SHAPES.items()}
    for arch in ref_registry.ARCH_IDS:
        cfg = ref_registry.get_config(arch)
        for shape in ref_shapes.SHAPES.values():
            assert port_shapes.shape_applicable(cfg, shape) == \
                ref_shapes.shape_applicable(cfg, shape)
    assert dataclasses.asdict(port_base.TrainConfig()) == \
        dataclasses.asdict(ref_base.TrainConfig())
    with pytest.raises(KeyError, match="unknown arch"):
        port_registry.get_config("nope")


# ------------------------------------------------------------- sharding


class StandInMesh:
    """What ``_spec_entries`` reads of a mesh: axis names and extents."""

    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = shape


SPEC_CASES = [
    (("batch", None, "tp"), None),
    (("batch", "sp", None), (8, 64, 32)),
    (("fsdp", "tp"), (64, 96)),
    (("fsdp", "tp"), (6, 96)),            # indivisible: replicated
    (("tp", "sp"), (16, 16)),             # "model" used once
    (("kv_batch", None, None, "tp"), (2, 16, 2, 8)),
    ((None, "expert", "fsdp"), (3, 8, 8)),
    (("unknown", None), (4, 4)),
]


@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "SERVE_RULES"])
@pytest.mark.parametrize("mesh", [dict(pod=2, data=2, model=4),
                                  dict(data=8, model=1),
                                  dict(model=2)])
def test_spec_entries_and_rules_equal_the_reference(rules, mesh):
    ref_rules = getattr(ref_sharding, rules)
    port_rules = getattr(port_sharding, rules)
    assert port_rules.name == ref_rules.name
    assert port_rules.mapping == ref_rules.mapping
    m = StandInMesh(**mesh)
    for axes, shape in SPEC_CASES:
        assert port_sharding._spec_entries(axes, m, port_rules, shape) == \
            ref_sharding._spec_entries(axes, m, ref_rules, shape)
        for logical in axes:
            assert port_sharding.axis_extent(logical, port_rules, m) == \
                ref_sharding.axis_extent(logical, ref_rules, m)


def test_no_mesh_means_no_constraint():
    x = torch.arange(6.0).reshape(2, 3)
    assert port_sharding.constraint(x, ("batch", "tp")) is x
    assert port_sharding.axis_extent("tp") == 1 == \
        ref_sharding.axis_extent("tp")
    with port_sharding.use_rules(port_sharding.SERVE_RULES) as r:
        assert port_sharding._active_rules() is r
    assert port_sharding._active_rules() is port_sharding.DEFAULT_RULES


# ------------------------------------------------------------- init


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_axes_shapes_and_dtypes_equal_the_reference(arch):
    rcfg = ref_registry.get_config(arch, smoke=True)
    pcfg = port_registry.get_config(arch, smoke=True)
    rp, rax = RM.init(jax.random.PRNGKey(0), rcfg)
    pp, pax = PM.init(0, pcfg, device="cpu")
    assert pax == rax
    ref_leaves = jax.tree_util.tree_flatten_with_path(rp)[0]
    port_leaves = tree_util.flatten_with_path(pp)[0]
    assert [jax.tree_util.keystr(k) for k, _ in ref_leaves] == \
        [k for k, _ in port_leaves]
    for (_, r), (_, p) in zip(ref_leaves, port_leaves):
        assert tuple(p.shape) == r.shape
        assert str(p.dtype).removeprefix("torch.") == str(r.dtype)
    # a generator on the CPU with the same seed draws the same weights
    again, _ = PM.init(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_util.flatten(again)[0], tree_util.flatten(pp)[0]))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "zamba2-1.2b",
                                  "xlstm-125m"])
def test_unported_families_raise_naming_the_roadmap(arch):
    cfg = port_registry.get_config(arch, smoke=True)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    for call in (lambda: PM.init(0, cfg, device="cpu"),
                 lambda: PM.forward({}, {"tokens": toks}, cfg),
                 lambda: PM.prefill({}, {"tokens": toks}, cfg, 8),
                 lambda: PM.decode({}, toks[:, :1], None, cfg),
                 lambda: PM.fresh_cache(cfg, 1, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            call()


def test_params_cross_over_both_ways():
    cfg = ref_registry.get_config("chatglm3-6b", smoke=True)
    rp, _ = RM.init(jax.random.PRNGKey(3), cfg)
    tree = jax.tree.map(np.asarray, rp)
    port = params_from_jax(tree, "cpu")
    assert port["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert port["blocks"]["ln1"].dtype == torch.float32
    back = params_to_numpy(port)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# ------------------------------------------------------------- components


def test_rms_norm_and_activations_agree():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    for dt, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        rx = jnp.asarray(x).astype(dt)
        px = torch.as_tensor(x).to(getattr(torch, dt))
        got = PC.rms_norm(px, torch.as_tensor(w), 1e-5)
        want = RC.rms_norm(rx, jnp.asarray(w), 1e-5)
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        assert rel_err(got, want) <= tol
    for name in ("silu", "gelu", "relu"):
        got = PC.act_fn(name)(torch.as_tensor(x))
        assert rel_err(got, RC.act_fn(name)(jnp.asarray(x))) <= F32_TOL


@pytest.mark.parametrize("rotary_pct", [1.0, 0.5])
def test_rope_full_and_partial_agree(rotary_pct):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10, dtype=np.int32), (2, 7))
    rot = int(rotary_pct * 16) // 2 * 2
    rc, rs = RA.rope_tables(jnp.asarray(pos), rot, 10000.0)
    pc, ps = PA.rope_tables(torch.as_tensor(pos.copy()), rot, 10000.0)
    assert rel_err(pc, rc) <= F32_TOL and rel_err(ps, rs) <= F32_TOL
    want = RA.apply_rope(jnp.asarray(x), rc, rs, rot)
    got = PA.apply_rope(torch.as_tensor(x), pc, ps, rot)
    assert rel_err(got, want) <= F32_TOL
    if rot < 16:  # the un-rotated tail passes through bit for bit
        assert np.array_equal(got[..., rot:].numpy(), x[..., rot:])


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlps_agree(act):
    rcfg, pcfg = small_cfg(mlp_act=act, dtype="float32")
    rp, _ = RMLP.init_mlp(jax.random.PRNGKey(2), rcfg)
    jp, pp = both(jax.tree.map(np.asarray, rp))
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(
        np.float32)
    got = PMLP.mlp_forward(pp, torch.as_tensor(x), pcfg)
    assert rel_err(got, RMLP.mlp_forward(jp, jnp.asarray(x), rcfg)) <= F32_TOL
    gen_p, gen_ax = PMLP.init_mlp(torch.Generator(), pcfg)
    assert gen_ax == RMLP.init_mlp(jax.random.PRNGKey(0), rcfg)[1]
    assert {k: tuple(v.shape) for k, v in gen_p.items()} == \
        {k: v.shape for k, v in rp.items()}


# ------------------------------------------------------------- attention


def attn_inputs(rcfg, seed, b, s):
    rp, _ = RA.init_attention(jax.random.PRNGKey(seed), rcfg)
    jp, pp = both(jax.tree.map(np.asarray, rp))
    x = (np.random.default_rng(seed).standard_normal((b, s, rcfg.d_model))
         * 0.3).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return jp, pp, x, pos


@pytest.mark.parametrize("kw", [dict(), dict(n_kv_heads=4),
                                dict(n_kv_heads=1), dict(sliding_window=16),
                                dict(rotary_pct=0.5),
                                dict(attn_logit_softcap=30.0)])
def test_dense_equals_streaming_in_both_packages(kw):
    """Dense against streaming (threshold lowered so 96 tokens stream in
    three chunks of 32 a side), in each package and across them."""
    rcfg, pcfg = small_cfg(dtype="float32", **kw)
    jp, pp, x, pos = attn_inputs(rcfg, 0, 2, 96)
    outs = {}
    for name, thresh in (("dense", 10**9), ("stream", 1)):
        outs["ref", name] = RA.attention_forward(
            jp, jnp.asarray(x), jnp.asarray(pos), rcfg,
            streaming_threshold=thresh)
    ref_stream = RA._attend_streaming
    port_stream = PA._attend_streaming
    try:
        RA._attend_streaming = lambda *a, **k: ref_stream(
            *a, q_chunk=32, kv_chunk=32)
        PA._attend_streaming = lambda *a, **k: port_stream(
            *a, q_chunk=32, kv_chunk=32)
        outs["ref", "stream"] = RA.attention_forward(
            jp, jnp.asarray(x), jnp.asarray(pos), rcfg, streaming_threshold=1)
        for name, thresh in (("dense", 10**9), ("stream", 1)):
            outs["port", name] = PA.attention_forward(
                pp, torch.as_tensor(x), torch.as_tensor(pos), pcfg,
                streaming_threshold=thresh)
    finally:
        RA._attend_streaming = ref_stream
        PA._attend_streaming = port_stream
    want = outs["ref", "dense"]
    for key, got in outs.items():
        assert rel_err(got if key[0] == "port" else np.asarray(got),
                       want) <= F32_TOL, key


def test_force_dense_takes_the_dense_path():
    rcfg, pcfg = small_cfg(dtype="float32")
    _, pp, x, pos = attn_inputs(rcfg, 5, 1, 24)
    calls = []
    real = PA._attend_dense
    try:
        PA._attend_dense = lambda *a: calls.append(1) or real(*a)
        PA.FORCE_DENSE = True
        PA.attention_forward(pp, torch.as_tensor(x), torch.as_tensor(pos),
                             pcfg, streaming_threshold=1)
    finally:
        PA.FORCE_DENSE = False
        PA._attend_dense = real
    assert calls == [1]


def test_sliding_window_masks_distant_tokens():
    rcfg, pcfg = small_cfg(dtype="float32", sliding_window=8)
    _, pp, x, pos = attn_inputs(rcfg, 1, 1, 32)
    out = PA.attention_forward(pp, torch.as_tensor(x), torch.as_tensor(pos),
                               pcfg)
    x2 = x.copy()
    x2[:, 5] = 1.0
    out2 = PA.attention_forward(pp, torch.as_tensor(x2),
                                torch.as_tensor(pos), pcfg)
    assert torch.allclose(out[:, 31], out2[:, 31], atol=1e-5)
    assert not torch.allclose(out[:, 6], out2[:, 6])


@pytest.mark.parametrize("kw", [dict(n_kv_heads=2), dict(n_kv_heads=1),
                                dict(sliding_window=16),
                                dict(sliding_window=16, n_kv_heads=1)])
def test_gqa_and_swa_decode_with_a_rolling_cache(kw):
    """Prefill 20 tokens into a 16-slot rolling window (SWA) or a
    24-slot cache, then decode 8 steps past the buffer's end: every
    step's logits and every cache leaf agree with the reference's."""
    rcfg, pcfg = small_cfg(dtype="float32", n_layers=2, **kw)
    rp, _ = RM.init(jax.random.PRNGKey(4), rcfg)
    jp, pp = both(jax.tree.map(np.asarray, rp))
    toks = np.random.default_rng(4).integers(0, 128, (2, 28), dtype=np.int32)
    rl, rc = R_PREFILL(jp, {"tokens": jnp.asarray(toks[:, :20])}, rcfg, 24)
    pl, pc = PM.prefill(pp, {"tokens": torch.as_tensor(toks[:, :20])}, pcfg,
                        24)
    assert rel_err(pl, rl) <= F32_TOL
    for t in range(20, 28):
        step = toks[:, t:t + 1]
        rl, rc = R_DECODE(jp, jnp.asarray(step), rc, rcfg)
        before = pc.layers.k.clone()
        pl, pc2 = PM.decode(pp, torch.as_tensor(step), pc, pcfg)
        assert torch.equal(pc.layers.k, before)  # the old cache is kept
        pc = pc2
        assert rel_err(pl, rl) <= F32_TOL, t
        for a, b in zip(pc.layers, rc.layers):
            assert tuple(a.shape) == b.shape
            if a.dtype == torch.int32:
                assert np.array_equal(a.numpy(), np.asarray(b))
            else:
                assert rel_err(a, b) <= F32_TOL
    # With room for every position (or the window, for SWA), decode
    # reproduces the teacher-forced logits of the forward pass.
    full, _ = PM.forward(pp, {"tokens": torch.as_tensor(toks)}, pcfg)
    _, pc = PM.prefill(pp, {"tokens": torch.as_tensor(toks[:, :20])}, pcfg,
                       28)
    for t in range(20, 28):
        pl, pc = PM.decode(pp, torch.as_tensor(toks[:, t:t + 1]), pc, pcfg)
        assert rel_err(pl[:, 0], full[:, t].numpy()) <= F32_TOL, t


def test_fresh_cache_equals_the_reference():
    rcfg, pcfg = small_cfg(dtype="float32", sliding_window=8)
    rc = RM.fresh_cache(rcfg, 3, 16)
    pc = PM.fresh_cache(pcfg, 3, 16, device="cpu")
    for a, b in zip(pc.layers, rc.layers):
        assert tuple(a.shape) == b.shape
        assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))
    assert pc.extra is None and rc.extra is None
    assert PA.cache_axes() == tuple(RA.cache_axes())


# ------------------------------------------------------------- the models


def lm_batch(cfg, seed, b=2, s=10):
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.n_codebooks) if cfg.family == "audio" else (b, s)
    toks = rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
    ref = {"tokens": jnp.asarray(toks)}
    port = {"tokens": torch.as_tensor(toks)}
    if cfg.family == "vlm":
        patches = rng.standard_normal((b, cfg.n_patches, cfg.d_model)
                                      ).astype(np.float32)
        ref["patches"] = jnp.asarray(patches)
        port["patches"] = torch.as_tensor(patches)
    return toks, ref, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_prefill_decode_agree_with_the_reference(arch, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    rcfg = dataclasses.replace(ref_registry.get_config(arch, smoke=True),
                               dtype=dtype)
    pcfg = dataclasses.replace(port_registry.get_config(arch, smoke=True),
                               dtype=dtype)
    rp, _ = RM.init(jax.random.PRNGKey(7), rcfg)
    jp, pp = both(jax.tree.map(np.asarray, rp))
    toks, rb, pb = lm_batch(rcfg, 7)
    rl, raux = R_FORWARD(jp, rb, rcfg)
    pl, paux = PM.forward(pp, pb, pcfg)
    assert tuple(pl.shape) == rl.shape and float(paux) == float(raux) == 0
    assert str(pl.dtype).removeprefix("torch.") == str(rl.dtype)
    assert rel_err(pl, rl) <= tol
    rl, rc = R_PREFILL(jp, rb, rcfg, 16)
    pl, pc = PM.prefill(pp, pb, pcfg, 16)
    assert tuple(pl.shape) == rl.shape and rel_err(pl, rl) <= tol
    nxt = np.random.default_rng(8).integers(
        0, rcfg.vocab_size, (2, 3) + toks.shape[2:], dtype=np.int32)
    for t in range(3):
        step = nxt[:, t:t + 1]
        rl, rc = R_DECODE(jp, jnp.asarray(step), rc, rcfg)
        pl, pc = PM.decode(pp, torch.as_tensor(step), pc, pcfg)
        assert tuple(pl.shape) == rl.shape and rel_err(pl, rl) <= tol, t
    assert np.array_equal(pc.layers.pos.numpy(), np.asarray(rc.layers.pos))
