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
from repro.models import mamba2 as RMB
from repro.models import mlp as RMLP
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.models import xlstm as RX
from repro_torch.configs import base as port_base
from repro_torch.configs import registry as port_registry
from repro_torch.configs import shapes as port_shapes
from repro_torch.core import tree as tree_util
from repro_torch.dist import sharding as port_sharding
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models import attention as PA
from repro_torch.models import common as PC
from repro_torch.models import mamba2 as PMB
from repro_torch.models import mlp as PMLP
from repro_torch.models import model as PM
from repro_torch.models import moe as PMOE
from repro_torch.models import xlstm as PX

#: The reference's model functions, compiled once a config and shape.
R_FORWARD = jax.jit(RM.forward, static_argnums=2)
R_PREFILL = jax.jit(RM.prefill, static_argnums=(2, 3))
R_DECODE = jax.jit(RM.decode, static_argnums=3)

F32_TOL = 1e-4
BF16_TOL = 3e-2
#: The smoke configs the forward / prefill / decode parity covers:
#: GQA with partial RoPE, tied embeddings with ``embed_scale`` and GeGLU,
#: a larger vocabulary, a wider GQA group, codebooks, and patches; MoE
#: with TP-in-expert and sliding windows, MoE with sharded experts,
#: Mamba2 with the shared attention block, and mLSTM / sLSTM stacks.
LM_ARCHS = ("chatglm3-6b", "gemma-7b", "glm4-9b", "deepseek-coder-33b",
            "musicgen-medium", "phi-3-vision-4.2b", "mixtral-8x22b",
            "qwen3-moe-235b-a22b", "zamba2-1.2b", "xlstm-125m")


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
    """A batch of ``s`` tokens (for a hybrid, the next multiple of its
    ``ssm_chunk``: the reference's Mamba2 takes no other length)."""
    if cfg.family == "hybrid":
        s = -(-s // cfg.ssm_chunk) * cfg.ssm_chunk
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
    assert tuple(pl.shape) == rl.shape
    if rcfg.is_moe:   # the router's aux loss, summed over the layers
        assert abs(float(paux) - float(raux)) <= tol * abs(float(raux))
    else:
        assert float(paux) == float(raux) == 0
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
    assert_caches_agree(pc, rc, tol)


def assert_caches_agree(pc, rc, tol):
    """The same tree of cache leaves (lists of NamedTuples for hybrid
    and ssm models): shapes and dtypes equal, integer leaves exact,
    float leaves within ``tol`` of their largest value."""
    port_leaves = tree_util.flatten_with_path(pc)[0]
    ref_leaves = jax.tree_util.tree_flatten_with_path(rc)[0]
    assert [k for k, _ in port_leaves] == \
        [jax.tree_util.keystr(k) for k, _ in ref_leaves]
    for (name, a), (_, b) in zip(port_leaves, ref_leaves):
        assert tuple(a.shape) == b.shape, name
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), name
        if a.dtype == torch.int32:
            assert np.array_equal(a.numpy(), np.asarray(b)), name
        elif np.abs(np.asarray(b, np.float32)).max() > 0:
            assert rel_err(a, b) <= tol, name


# ------------------------------------------------------------- moe


def f32_smoke(arch, **kw):
    """(reference, port) float32 copies of an arch's smoke config."""
    return (dataclasses.replace(ref_registry.get_config(arch, smoke=True),
                                dtype="float32", **kw),
            dataclasses.replace(port_registry.get_config(arch, smoke=True),
                                dtype="float32", **kw))


def moe_inputs(arch, seed, b=2, s=10, **kw):
    rcfg, pcfg = f32_smoke(arch, **kw)
    rp, _ = RMOE.init_moe(jax.random.PRNGKey(seed), rcfg)
    jp, pp = both(jax.tree.map(np.asarray, rp))
    x = (np.random.default_rng(seed).standard_normal((b, s, rcfg.d_model))
         * 0.5).astype(np.float32)
    return rcfg, pcfg, jp, pp, x


def ref_slots(topi, e, capacity):
    """The reference's FCFS slot assignment (``moe_forward``'s lines),
    in jax, from given expert choices."""
    g, tg, k = topi.shape
    member = sum(jax.nn.one_hot(topi[..., j], e, dtype=jnp.int32)
                 for j in range(k))
    pos_in_e = jnp.cumsum(member, axis=1) - 1
    t_idx = jnp.arange(tg, dtype=jnp.int32)
    score = jnp.where(member.transpose(0, 2, 1) > 0,
                      (tg - t_idx)[None, None, :].astype(jnp.float32),
                      -jnp.inf)
    top_scores, idx = jax.lax.top_k(score, capacity)
    keep = [jnp.take_along_axis(pos_in_e, topi[..., j][..., None],
                                axis=2)[..., 0] < capacity for j in range(k)]
    return np.asarray(idx), np.asarray(top_scores > -jnp.inf), \
        np.asarray(jnp.stack(keep))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("capacity", [None, 3])
def test_moe_forward_equals_the_reference(arch, capacity):
    """Output, aux loss and routing at float32: the top-k expert
    indices exactly, and with a tight capacity the same tokens dropped
    (a token dropped by every choice gives exactly zero in both)."""
    rcfg, pcfg, jp, pp, x = moe_inputs(arch, 11)
    want, raux = RMOE.moe_forward(jp, jnp.asarray(x), rcfg, capacity=capacity)
    got, paux = PMOE.moe_forward(pp, torch.as_tensor(x), pcfg,
                                 capacity=capacity)
    assert rel_err(got, want) <= F32_TOL
    assert abs(float(paux) - float(raux)) <= F32_TOL * abs(float(raux))
    xt = x.reshape(1, -1, rcfg.d_model)
    _, _, topi = PMOE.route(pp, torch.as_tensor(xt), pcfg)
    rlogits = jnp.einsum("gtd,de->gte", jnp.asarray(xt), jp["router"])
    _, rtopi = jax.lax.top_k(rlogits, rcfg.top_k)
    assert np.array_equal(topi.numpy(), np.asarray(rtopi))
    cap = min(capacity or max(int(rcfg.capacity_factor * xt.shape[1]
                                  * rcfg.top_k / rcfg.n_experts), 8),
              xt.shape[1])
    idx, valid, _, _, keep = PMOE._slots(topi, rcfg.n_experts, cap)
    r_idx, r_valid, r_keep = ref_slots(jnp.asarray(topi.numpy()),
                                       rcfg.n_experts, cap)
    assert np.array_equal(keep.numpy(), r_keep)
    assert np.array_equal(valid.numpy(), r_valid)
    assert np.array_equal(np.where(r_valid, idx.numpy(), -1),
                          np.where(r_valid, r_idx, -1))
    # FCFS, in numpy: each expert keeps its first ``cap`` tokens.
    want_keep = np.zeros_like(r_keep)
    seen = {}
    for t in range(xt.shape[1]):
        for j in range(rcfg.top_k):
            ex = int(topi[0, t, j])
            want_keep[j, 0, t] = seen.get(ex, 0) < cap
            seen[ex] = seen.get(ex, 0) + 1
    assert np.array_equal(keep.numpy(), want_keep)
    dropped = ~want_keep.any(axis=0)[0]
    assert (capacity is None) == (not dropped.any())
    zero = np.abs(got.numpy().reshape(-1, rcfg.d_model)).max(axis=1) == 0
    assert np.array_equal(zero, dropped)
    assert np.array_equal(zero, np.abs(np.asarray(want)).reshape(
        -1, rcfg.d_model).max(axis=1) == 0)


def test_moe_unfilled_slots_are_masked():
    """Valid slots hold distinct tokens in token order; the tied -inf
    scores of unfilled slots may name any token (jax and torch order
    ties differently), and the layer's output and gradients do not
    depend on which."""
    rcfg, pcfg, _, pp, x = moe_inputs("qwen3-moe-235b-a22b", 12, s=6)
    xt = torch.as_tensor(x.reshape(1, -1, rcfg.d_model))
    _, topv, topi = PMOE.route(pp, xt, pcfg)
    idx, valid, ej, pos, keep = PMOE._slots(topi, rcfg.n_experts, 8)
    assert not valid.all() and valid.any()
    for e in range(rcfg.n_experts):
        toks = idx[0, e][valid[0, e]].tolist()
        assert toks == sorted(set(toks))
    weights = torch.softmax(topv, dim=-1)
    other = torch.where(valid, idx, (idx + 5) % xt.shape[1])
    y = torch.randn((1, rcfg.n_experts, 8, rcfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    wsel = torch.rand(idx.shape, generator=torch.Generator().manual_seed(1))
    outs = []
    for slot_idx in (idx, other):
        xg = xt.clone().requires_grad_(True)
        yg = y.clone().requires_grad_(True)
        wg = weights.clone().requires_grad_(True)
        buf = PMOE._dispatch(xg, slot_idx, valid, ej, pos, keep)
        out = PMOE._combine(yg, wg, slot_idx, valid, wsel, ej, pos, keep)
        (buf.sum() + (out * out).sum()).backward()
        outs.append([buf, out, xg.grad, yg.grad, wg.grad])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-235b-a22b"])
def test_moe_gather_only_gradients_equal_jax_vjp(arch):
    """``_dispatch`` / ``_combine`` backward against ``jax.vjp`` of the
    reference's custom VJPs, and the whole layer's gradient (input and
    every weight) against ``jax.vjp`` of its ``moe_forward``."""
    rcfg, pcfg, jp, pp, x = moe_inputs(arch, 13)
    rng = np.random.default_rng(13)
    xt = x.reshape(1, -1, rcfg.d_model)
    _, topv, topi = PMOE.route(pp, torch.as_tensor(xt), pcfg)
    cap = 5
    idx, valid, ej, pos, keep = PMOE._slots(topi, rcfg.n_experts, cap)
    weights = torch.softmax(topv, dim=-1)
    wsel = torch.as_tensor(rng.random(idx.shape).astype(np.float32))
    y = rng.standard_normal((1, rcfg.n_experts, cap, rcfg.d_model)
                            ).astype(np.float32)
    jx = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    args = [jx(t) for t in (idx, valid, ej, pos, keep)]

    dbuf = rng.standard_normal((1, rcfg.n_experts, cap, rcfg.d_model)
                               ).astype(np.float32)
    _, vjp = jax.vjp(lambda a: RMOE._dispatch(a, *args), jnp.asarray(xt))
    (want,) = vjp(jnp.asarray(dbuf))
    xg = torch.as_tensor(xt).requires_grad_(True)
    PMOE._dispatch(xg, idx, valid, ej, pos, keep).backward(
        torch.as_tensor(dbuf))
    assert rel_err(xg.grad, want) <= F32_TOL

    dout = rng.standard_normal(xt.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, w: RMOE._combine(
        a, w, args[0], args[1], jx(wsel), *args[2:]),
        jnp.asarray(y), jx(weights))
    want_y, want_w = vjp(jnp.asarray(dout))
    yg = torch.as_tensor(y).requires_grad_(True)
    wg = weights.clone().requires_grad_(True)
    PMOE._combine(yg, wg, idx, valid, wsel, ej, pos, keep).backward(
        torch.as_tensor(dout))
    assert rel_err(yg.grad, want_y) <= F32_TOL
    assert rel_err(wg.grad, want_w) <= F32_TOL

    cot = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, p: RMOE.moe_forward(p, a, rcfg)[0],
                     jnp.asarray(x), jp)
    want_x, want_p = vjp(jnp.asarray(cot))
    xg = torch.as_tensor(x).requires_grad_(True)
    pg = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    out, _ = PMOE.moe_forward(pg, xg, pcfg)
    out.backward(torch.as_tensor(cot))
    assert rel_err(xg.grad, want_x) <= F32_TOL
    for k in ("w_gate", "w_up", "w_down", "router"):
        assert rel_err(pg[k].grad, want_p[k]) <= F32_TOL, k


def test_moe_top1_single_expert_is_that_experts_swiglu():
    _, pcfg = small_cfg(family="moe", n_experts=1, top_k=1,
                        capacity_factor=4.0, dtype="float32")
    pp, _ = PMOE.init_moe(torch.Generator().manual_seed(9), pcfg)
    x = torch.randn((2, 8, 64), generator=torch.Generator().manual_seed(9))
    out, _ = PMOE.moe_forward(pp, x * 0.3, pcfg)
    h = x * 0.3
    want = (torch.nn.functional.silu(h @ pp["w_gate"][0])
            * (h @ pp["w_up"][0])) \
        @ pp["w_down"][0]
    assert torch.allclose(out, want, atol=1e-5)


# ------------------------------------------------------------- mamba2


def mamba_inputs(seed, b, s, scale=0.3):
    rcfg, pcfg = f32_smoke("zamba2-1.2b")
    rp, _ = RMB.init_mamba2(jax.random.PRNGKey(seed), rcfg)
    jp, pp = both(jax.tree.map(np.asarray, rp))
    x = (np.random.default_rng(seed).standard_normal((b, s, rcfg.d_model))
         * scale).astype(np.float32)
    return rcfg, pcfg, jp, pp, x


def test_mamba2_chunked_equals_the_recurrence_and_the_reference():
    rcfg, pcfg, jp, pp, x = mamba_inputs(5, 2, 24)
    y, st = PMB.mamba2_forward(pp, torch.as_tensor(x), pcfg)
    y_rec = PMB.mamba2_reference(pp, torch.as_tensor(x), pcfg)
    assert torch.allclose(y, y_rec, atol=3e-4, rtol=1e-3)
    want, rst = RMB.mamba2_forward(jp, jnp.asarray(x), rcfg)
    assert rel_err(y, want) <= F32_TOL
    assert rel_err(st.h, rst.h) <= F32_TOL
    assert rel_err(st.conv, rst.conv) <= F32_TOL
    assert rel_err(y_rec, RMB.mamba2_reference(jp, jnp.asarray(x), rcfg)) \
        <= F32_TOL


def test_mamba2_state_continues_into_decode():
    rcfg, pcfg, jp, pp, x = mamba_inputs(6, 1, 16)
    xt = torch.as_tensor(x)
    y_all, _ = PMB.mamba2_forward(pp, xt, pcfg)
    y1, st = PMB.mamba2_forward(pp, xt[:, :8], pcfg)
    ys = [y1]
    for t in range(8, 16):
        y, st = PMB.mamba2_decode(pp, xt[:, t:t + 1], pcfg, st)
        ys.append(y)
    assert torch.allclose(y_all, torch.cat(ys, dim=1), atol=3e-4, rtol=1e-3)
    # a second chunked call resumes from the first's state
    y2, _ = PMB.mamba2_forward(pp, xt[:, 8:], pcfg,
                               PMB.mamba2_forward(pp, xt[:, :8], pcfg)[1])
    assert torch.allclose(y_all[:, 8:], y2, atol=3e-4, rtol=1e-3)
    assert tuple(PMB.init_mamba_state(pcfg, 3, "cpu").conv.shape) == \
        RMB.init_mamba_state(rcfg, 3).conv.shape


def test_zamba2_prompt_length_raises_where_the_reference_fails():
    """A prompt that is not a multiple of ``ssm_chunk``: the reference's
    Mamba2 fails in a reshape; the port raises a ValueError naming the
    chunk."""
    rcfg, pcfg, jp, pp, x = mamba_inputs(7, 1, 12)
    with pytest.raises(TypeError):
        RMB.mamba2_forward(jp, jnp.asarray(x), rcfg)
    with pytest.raises(ValueError, match="multiple of ssm_chunk=8"):
        PMB.mamba2_forward(pp, torch.as_tensor(x), pcfg)
    rcfg = ref_registry.get_config("zamba2-1.2b", smoke=True)
    pcfg = port_registry.get_config("zamba2-1.2b", smoke=True)
    rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
    pp = params_from_jax(jax.tree.map(np.asarray, rp), "cpu")
    toks = np.zeros((1, 12), np.int32)
    with pytest.raises(TypeError):
        RM.prefill(rp, {"tokens": jnp.asarray(toks)}, rcfg, 16)
    with pytest.raises(ValueError, match="ssm_chunk"):
        PM.prefill(pp, {"tokens": torch.as_tensor(toks)}, pcfg, 16)


@pytest.mark.parametrize("n_layers,attn_every", [(5, 2), (7, 6), (6, 3),
                                                 (1, 2), (4, 6)])
def test_zamba_groups_with_a_remainder(n_layers, attn_every):
    """The group split, and a prefill + decode over it: the shared
    attention block after each full group, the remainder group alone."""
    rcfg, pcfg = f32_smoke("zamba2-1.2b", n_layers=n_layers,
                           attn_every=attn_every)
    assert PM._zamba_groups(pcfg) == RM._zamba_groups(rcfg)
    groups, n_full = PM._group_layers(pcfg)
    assert [i for g in groups for i in g] == list(range(n_layers))
    assert n_full == n_layers // attn_every
    rp, _ = RM.init(jax.random.PRNGKey(3), rcfg)
    jp, pp = both(jax.tree.map(np.asarray, rp))
    toks, rb, pb = lm_batch(rcfg, 3, s=8)
    rl, rc = R_PREFILL(jp, rb, rcfg, 12)
    pl, pc = PM.prefill(pp, pb, pcfg, 12)
    assert rel_err(pl, rl) <= F32_TOL
    assert len(pc.layers) == len(groups) and len(pc.extra) == n_full
    step = toks[:, -1:]
    rl, rc = R_DECODE(jp, jnp.asarray(step), rc, rcfg)
    pl, pc = PM.decode(pp, torch.as_tensor(step), pc, pcfg)
    assert rel_err(pl, rl) <= F32_TOL
    assert_caches_agree(pc, rc, F32_TOL)


# ------------------------------------------------------------- xlstm


def xlstm_inputs(init, seed, b, s, scale=0.5):
    rcfg, pcfg = f32_smoke("xlstm-125m")
    rp, _ = getattr(RX, init)(jax.random.PRNGKey(seed), rcfg)
    jp, pp = both(jax.tree.map(np.asarray, rp))
    x = (np.random.default_rng(seed).standard_normal((b, s, rcfg.d_model))
         * scale).astype(np.float32)
    return rcfg, pcfg, jp, pp, x


def test_mlstm_chunked_equals_stepwise_and_the_reference():
    rcfg, pcfg, jp, pp, x = xlstm_inputs("init_mlstm", 7, 2, 40)
    xt = torch.as_tensor(x)
    y1, st1 = PX.mlstm_forward(pp, xt, pcfg, chunk=8)
    y2, st2 = PX.mlstm_forward_reference(pp, xt, pcfg)
    assert torch.allclose(y1, y2, atol=2e-5)
    assert torch.allclose(st1.c, st2.c, atol=2e-5)
    want, rst = RX.mlstm_forward(jp, jnp.asarray(x), rcfg, chunk=8)
    assert rel_err(y1, want) <= F32_TOL
    for a, b in zip(st1, rst):
        assert rel_err(a, b) <= F32_TOL
    want, _ = RX.mlstm_forward_reference(jp, jnp.asarray(x), rcfg)
    assert rel_err(y2, want) <= F32_TOL


def test_mlstm_decode_continues_the_chunked_state():
    rcfg, pcfg, jp, pp, x = xlstm_inputs("init_mlstm", 8, 1, 17)
    xt = torch.as_tensor(x)
    y_all, _ = PX.mlstm_forward_reference(pp, xt, pcfg)
    _, st = PX.mlstm_forward(pp, xt[:, :16], pcfg, chunk=8)
    y_last, st = PX.mlstm_decode(pp, xt[:, 16:], pcfg, st)
    assert torch.allclose(y_all[:, -1:], y_last, atol=3e-5)
    _, rst = RX.mlstm_forward(jp, jnp.asarray(x[:, :16]), rcfg, chunk=8)
    want, _ = RX.mlstm_decode(jp, jnp.asarray(x[:, 16:]), rcfg, rst)
    assert rel_err(y_last, want) <= F32_TOL


def test_slstm_forward_and_decode_equal_the_reference():
    rcfg, pcfg, jp, pp, x = xlstm_inputs("init_slstm", 9, 2, 12)
    xt = torch.as_tensor(x)
    y, st = PX.slstm_forward(pp, xt[:, :11], pcfg)
    want, rst = RX.slstm_forward(jp, jnp.asarray(x[:, :11]), rcfg)
    assert rel_err(y, want) <= F32_TOL
    for a, b in zip(st, rst):
        assert rel_err(a, b) <= F32_TOL
    y1, st = PX.slstm_decode(pp, xt[:, 11:], pcfg, st)
    want, _ = RX.slstm_decode(jp, jnp.asarray(x[:, 11:]), rcfg, rst)
    assert rel_err(y1, want) <= F32_TOL
    # decoding token by token from the start equals the forward pass
    full, _ = PX.slstm_forward(pp, xt, pcfg)
    st = PX.init_slstm_state(pcfg, 2, "cpu")
    for t in range(12):
        yt, st = PX.slstm_decode(pp, xt[:, t:t + 1], pcfg, st)
        assert torch.allclose(yt, full[:, t:t + 1], atol=1e-5)


# ------------------------------------------------------------- caches, trees


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "zamba2-1.2b",
                                  "xlstm-125m"])
def test_fresh_cache_equals_the_reference_for_every_family(arch):
    rcfg = ref_registry.get_config(arch, smoke=True)
    pcfg = port_registry.get_config(arch, smoke=True)
    rc = RM.fresh_cache(rcfg, 3, 16)
    pc = PM.fresh_cache(pcfg, 3, 16, device="cpu")
    port_leaves = tree_util.flatten_with_path(pc)[0]
    ref_leaves = jax.tree_util.tree_flatten_with_path(rc)[0]
    assert [k for k, _ in port_leaves] == \
        [jax.tree_util.keystr(k) for k, _ in ref_leaves]
    for (_, a), (_, b) in zip(port_leaves, ref_leaves):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_params_from_jax_on_the_list_shaped_ssm_tree():
    cfg = ref_registry.get_config("xlstm-125m", smoke=True)
    rp, _ = RM.init(jax.random.PRNGKey(3), cfg)
    tree = jax.tree.map(np.asarray, rp)
    port = params_from_jax(tree, "cpu")
    assert isinstance(port["blocks"], list) and len(port["blocks"]) == 4
    assert set(port["blocks"][1]["mix"]) == {"w_x", "r_h", "w_ff1", "w_ff2"}
    assert set(port["blocks"][0]["mix"]) == {"w_up", "w_qkv", "w_if",
                                             "w_down"}
    back = params_to_numpy(port)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_init_abstract_equals_the_reference(arch):
    """Every registry architecture at its published size, on ``meta``:
    shapes, dtypes and axes equal the reference's ``eval_shape``."""
    rcfg = ref_registry.get_config(arch)
    want, rax = RM.init_abstract(rcfg)
    got, pax = PM.init_abstract(port_registry.get_config(arch))
    assert pax == rax
    got_leaves = tree_util.flatten(got)[0]
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        assert a.device.type == "meta"
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)


@pytest.mark.parametrize("arch,layers,s", [("zamba2-1.2b", 7, 64),
                                           ("xlstm-125m", 4, 16)])
def test_bf16_drift_of_the_recurrent_families_is_the_reference_own(
        arch, layers, s):
    """bfloat16 logits against float32 ones on the same weights (the
    bfloat16 weights the float32 ones rounded), prefill and three decode
    steps.  The gates of Mamba2 and the xLSTM cells go through ``exp``,
    so bfloat16 drifts further than in the transformer families: the
    reference's own drift exceeds the 3e-2 a dense model stays within,
    and the port's drift is of the same size (both under 1.5e-1, the
    bound ``chip_smoke.py`` holds these families to on the card)."""
    drift = {}
    for pkg in ("ref", "port"):
        out = {}
        for dtype in ("float32", "bfloat16"):
            rcfg = dataclasses.replace(
                ref_registry.get_config(arch, smoke=True), n_layers=layers,
                dtype=dtype)
            rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
            toks = np.random.default_rng(1).integers(
                0, rcfg.vocab_size, (2, s), dtype=np.int32)
            if pkg == "ref":
                logits, cache = R_PREFILL(rp, {"tokens": jnp.asarray(toks)},
                                          rcfg, s + 8)
                seq = [logits]
                for t in range(3):
                    logits, cache = R_DECODE(rp, jnp.asarray(toks[:, t:t + 1]),
                                             cache, rcfg)
                    seq.append(logits)
                out[dtype] = [np.asarray(x, np.float32) for x in seq]
                continue
            pcfg = dataclasses.replace(
                port_registry.get_config(arch, smoke=True), n_layers=layers,
                dtype=dtype)
            pp = params_from_jax(jax.tree.map(np.asarray, rp), "cpu")
            logits, cache = PM.prefill(pp, {"tokens": torch.as_tensor(toks)},
                                       pcfg, s + 8)
            seq = [logits]
            for t in range(3):
                logits, cache = PM.decode(pp, torch.as_tensor(toks[:, t:t + 1]),
                                          cache, pcfg)
                seq.append(logits)
            out[dtype] = [x.float().numpy() for x in seq]
        drift[pkg] = max(float(np.abs(a - b).max() / np.abs(b).max())
                         for a, b in zip(out["bfloat16"], out["float32"]))
    assert drift["ref"] > BF16_TOL
    assert drift["port"] <= 1.5e-1 and drift["ref"] <= 1.5e-1
