"""The port's AdamW and gradient compression against the reference's.

The same numpy trees go through both packages.  Tolerances:

* ``lr_schedule`` and ``global_norm``: 1e-7 relative (float32 scalars;
  the two may round ``cos`` and the sum differently by an ulp);
* ``apply_updates`` over 3 steps on identical params, state and grads:
  1e-6 of each leaf's largest |value| (XLA on the CPU may fuse a
  multiply-add that torch rounds twice), the step exactly, as int32;
* ``compress``: decoded grads and residuals within 1e-6 absolute
  (``round`` halves to even in both; the int8 scale may differ by an
  ulp), top-k's kept set identical.

The schedule is held to the reference run eagerly; jitted, XLA folds the
schedule's constants at a higher precision and lands within one ulp
(held too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as RTrainConfig
from repro.optim import adamw as RA
from repro.optim import compression as RC
from repro_torch.configs.base import TrainConfig
from repro_torch.core import tree as tree_util
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.optim import adamw as PA
from repro_torch.optim import compression as PC

R_APPLY = jax.jit(RA.apply_updates, static_argnums=3)
R_COMPRESS = jax.jit(RC.compress, static_argnums=(2, 3))


def numpy_tree(seed: int, dtype=np.float32, scale: float = 1.0):
    """A small nested tree of normal draws (a stacked leaf, a list)."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        return jnp.asarray(x, dtype) if dtype != np.float32 else x

    tree = {"w": draw(3, 8, 16), "b": draw(16),
            "blocks": [{"ln": draw(8)}, {"ln": draw(8), "k": draw(4, 4)}]}
    return jax.tree.map(np.asarray, tree)


def ref_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def leaves_close(port_tree, ref_tree_, rtol=0.0, atol=0.0):
    got = tree_util.flatten_with_path(port_tree)[0]
    want = jax.tree_util.tree_flatten_with_path(ref_tree_)[0]
    assert [n for n, _ in got] == [jax.tree_util.keystr(k) for k, _ in want]
    for (name, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), name
        a = a.float().numpy()
        b = b.astype(np.float32)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= rtol * scale + atol, name


# --------------------------------------------------------- schedule, norm

SCHEDULES = {
    "default": TrainConfig(),
    "short": TrainConfig(lr=3e-3, warmup_steps=4, total_steps=30),
    "no_warmup": TrainConfig(lr=1e-2, warmup_steps=0, total_steps=10),
    "warmup_past_total": TrainConfig(lr=5e-4, warmup_steps=20,
                                     total_steps=10),
}


def _ref_tc(tc: TrainConfig) -> RTrainConfig:
    return RTrainConfig(**{f: getattr(tc, f)
                           for f in RTrainConfig.__dataclass_fields__})


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_equals_the_reference(name):
    tc = SCHEDULES[name]
    mid = (tc.warmup_steps + tc.total_steps) // 2
    steps = sorted({0, 1, tc.warmup_steps, mid, tc.total_steps,
                    tc.total_steps + 7})
    ref = RA.lr_schedule(_ref_tc(tc))
    jitted = jax.jit(ref)
    port = PA.lr_schedule(tc)
    for s in steps:
        want = float(ref(jnp.int32(s)))
        got = port(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-7 * abs(want), s
        folded = np.float32(jitted(jnp.int32(s)))
        assert abs(np.float32(got) - folded) <= np.spacing(folded), s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_equal_the_reference(dtype):
    tree = numpy_tree(0, np.float32 if dtype == "float32" else jnp.bfloat16,
                      scale=3.0)
    want = float(jax.jit(RA.global_norm)(ref_tree(tree)))
    got = PA.global_norm(params_from_jax(tree, "cpu"))
    assert abs(float(got) - want) <= 1e-7 * want
    for max_norm in (1.0, 1e6):
        rc, rn = jax.jit(RA.clip_by_global_norm, static_argnums=1)(
            ref_tree(tree), max_norm)
        pc, pn = PA.clip_by_global_norm(params_from_jax(tree, "cpu"),
                                        max_norm)
        assert abs(float(pn) - float(rn)) <= 1e-7 * float(rn)
        leaves_close(pc, rc, 1e-6)


# ---------------------------------------------------------------- state


def test_init_state_matches_the_reference_and_copies_masters():
    tree = numpy_tree(1)
    tree["half"] = np.asarray(jnp.asarray(tree["b"], jnp.bfloat16))
    params = params_from_jax(tree, "cpu")
    port = PA.init_state(params)
    ref = RA.init_state(ref_tree(tree))
    assert port.step.dtype == torch.int32 and port.step.shape == ()
    assert int(port.step) == 0
    for part in ("m", "v", "master"):
        leaves_close(getattr(port, part), getattr(ref, part), 0.0)
    for p, w in zip(tree_util.flatten(params)[0],
                    tree_util.flatten(port.master)[0]):
        assert w.dtype == torch.float32
        assert w.data_ptr() != p.data_ptr()
    m, v = tree_util.flatten(port.m)[0], tree_util.flatten(port.v)[0]
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(m, v))
    axes = {"w": (None, "fsdp", "tp"), "b": ("tp",)}
    assert tuple(PA.state_axes(axes)) == tuple(RA.state_axes(axes))


# -------------------------------------------------------------- updates


@pytest.mark.parametrize("clip", [1.0, 1e6], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_updates_on_identical_grads_equal_the_reference(dtype, clip):
    """The same params, state and grads each step: the update is the
    optimizer's alone, so the two agree tightly (no sign noise)."""
    pdt = np.float32 if dtype == "float32" else jnp.bfloat16
    tree = numpy_tree(2, pdt)
    tc = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=10,
                     grad_clip=clip)
    rtc = _ref_tc(tc)
    r_params = ref_tree(tree)
    r_state = RA.init_state(r_params)
    p_params = params_from_jax(tree, "cpu")
    p_state = PA.init_state(p_params)
    for step in range(3):
        grads = numpy_tree(10 + step, pdt, scale=0.5)
        p_grads = params_from_jax(grads, "cpu")
        held = [t.clone() for t in tree_util.flatten(
            (p_params, p_state, p_grads))[0]]
        r_params, r_state, r_stats = R_APPLY(r_params, r_state,
                                             ref_tree(grads), rtc)
        new_params, new_state, p_stats = PA.apply_updates(
            p_params, p_state, p_grads, tc)
        # the caller's tensors are left as they were (functional)
        for a, b in zip(tree_util.flatten((p_params, p_state, p_grads))[0],
                        held):
            assert torch.equal(a, b)
        p_params, p_state = new_params, new_state
        assert p_state.step.dtype == torch.int32
        assert int(p_state.step) == int(r_state.step) == step + 1
        leaves_close(p_params, r_params, 1e-6)
        for part in ("m", "v", "master"):
            leaves_close(getattr(p_state, part), getattr(r_state, part),
                         1e-6)
        for k in ("grad_norm", "lr"):
            want = float(r_stats[k])
            assert abs(float(p_stats[k]) - want) <= 1e-6 * abs(want), k


# ------------------------------------------------------------ compression


def _grads(seed: int, n: int = 1000):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((n,)).astype(np.float32),
            "m": rng.standard_normal((8, 33)).astype(np.float32),
            # ties at the top-k threshold: repeated magnitudes
            "t": np.repeat(np.float32([0.5, -0.5, 0.25, 2.0]), 25)}


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.3])
@pytest.mark.parametrize("method", ["none", "int8", "topk"])
def test_compress_equals_the_reference_over_three_rounds(method, frac):
    g0 = _grads(0)
    stats = RC.compress(ref_tree(g0), RC.init_feedback(ref_tree(g0)),
                        method, frac)[2]
    r_fb = RC.init_feedback(ref_tree(g0))
    p_fb = PC.init_feedback(params_from_jax(g0, "cpu"))
    for rnd in range(3):
        g = _grads(rnd)
        r_dec, r_fb, r_stats = R_COMPRESS(ref_tree(g), r_fb, method, frac)
        p_dec, p_fb, p_stats = PC.compress(params_from_jax(g, "cpu"), p_fb,
                                           method, frac)
        assert p_stats == stats
        leaves_close(p_dec, r_dec, atol=1e-6)
        leaves_close(p_fb.residual, r_fb.residual, atol=1e-6)
        if method == "topk":
            for a, b in zip(tree_util.flatten(p_dec)[0],
                            jax.tree.leaves(r_dec)):
                assert np.array_equal(a.numpy() != 0, np.asarray(b) != 0)


def test_compress_rejects_an_unknown_codec_as_the_reference():
    g = _grads(0)
    with pytest.raises(ValueError):
        RC.compress(ref_tree(g), RC.init_feedback(ref_tree(g)), "fp4")
    with pytest.raises(ValueError):
        PC.compress(params_from_jax(g, "cpu"),
                    PC.init_feedback(params_from_jax(g, "cpu")), "fp4")


def test_int8_error_feedback_bounds_and_carries_the_error():
    """The reference's own compression test, on the port."""
    grads = {"w": torch.as_tensor(
        np.random.default_rng(0).standard_normal(256).astype(np.float32))}
    fb = PC.init_feedback(grads)
    dec, fb, stats = PC.compress(grads, fb, "int8")
    assert (dec["w"] - grads["w"]).abs().max() < 0.05
    assert stats["wire_bytes_frac"] == 0.25
    assert torch.allclose(fb.residual["w"], grads["w"] - dec["w"],
                          atol=1e-6)


def test_topk_keeps_ties_at_the_threshold():
    g = {"t": torch.tensor([3.0, -2.0, 2.0, 2.0, 1.0, 0.5, -0.1, 0.0])}
    dec, _, _ = PC.compress(g, PC.init_feedback(g), "topk", topk_frac=0.25)
    # k = 2: the threshold is 2.0, and all three entries of |g| = 2 stay
    assert dec["t"].tolist() == [3.0, -2.0, 2.0, 2.0, 0, 0, 0, 0]
    ref, _, _ = RC.compress({"t": jnp.asarray(g["t"].numpy())},
                            RC.init_feedback({"t": jnp.zeros(8)}), "topk",
                            topk_frac=0.25)
    assert np.array_equal(np.asarray(ref["t"]), dec["t"].numpy())


def test_compressed_grads_of_bfloat16_params_are_float32():
    g = params_from_jax({"w": np.asarray(jnp.asarray(
        _grads(3)["w"], jnp.bfloat16))}, "cpu")
    dec, fb, _ = PC.compress(g, PC.init_feedback(g), "int8")
    assert dec["w"].dtype == fb.residual["w"].dtype == torch.float32
    back = params_to_numpy(dec)
    ref, _, _ = RC.compress({"w": jnp.asarray(params_to_numpy(g)["w"])},
                            RC.init_feedback({"w": jnp.zeros(1000)}), "int8")
    assert np.abs(back["w"] - np.asarray(ref["w"])).max() <= 1e-6
