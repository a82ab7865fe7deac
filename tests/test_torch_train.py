"""The port's train step, trainer and launcher against the reference's.

A reference ``TrainState`` (params, AdamW state with its int32 step,
error feedback) is carried across with ``interop.train_state_from_jax``,
and both packages take the same steps on the same numpy batches.
Tolerances:

* the loss of each of 3 steps: 1e-4 relative (float32 copies of the
  smoke configs; the grads agree within 1e-4 of each leaf's largest |g|,
  ``tests/test_torch_loss.py``, and AdamW turns a gradient element near
  zero into a ±lr move, so later losses drift a little);
* the params after those steps: within ``2 * lr * steps`` of the
  reference's (the most that such sign noise moves one element);
* the port's copies of the reference's own trainer tests keep their
  tolerances (microbatching: the loss within rel 1e-3, params within
  5e-3).
"""

import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import TrainConfig as RTrainConfig
from repro.train import step as RS
from repro_torch import interop
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt import tmr_store
from repro_torch.configs import registry as port_registry
from repro_torch.configs.base import TrainConfig
from repro_torch.core import tree as tree_util
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.ft.failures import FailurePlan
from repro_torch.launch import train as launch_train
from repro_torch.train import step as PS
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these eager steps run thousands of tiny ops,
    which are faster so on their own and do not oversubscribe the cores
    that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32_smoke(arch, **kw):
    return (dataclasses.replace(ref_registry.get_config(arch, smoke=True),
                                dtype="float32", **kw),
            dataclasses.replace(port_registry.get_config(arch, smoke=True),
                                dtype="float32", **kw))


def ref_tc(tc: TrainConfig) -> RTrainConfig:
    return RTrainConfig(**dataclasses.asdict(tc))


def loader(cfg, seq=16, batch=4, seed=0) -> SyntheticLM:
    return SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed, n_codebooks=cfg.n_codebooks,
        n_patches=cfg.n_patches if cfg.family == "vlm" else 0,
        d_model=cfg.d_model))


def ref_state_numpy(cfg, seed=0):
    state, _ = RS.init_train_state(jax.random.PRNGKey(seed), cfg)
    return jax.tree.map(np.asarray, state)


def assert_leaves_equal(port_tree, ref_tree):
    got = tree_util.flatten_with_path(port_tree)[0]
    want = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert [n for n, _ in got] == [jax.tree_util.keystr(k) for k, _ in want]
    for (name, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), name
        assert tuple(a.shape) == b.shape, name
        a = interop.params_to_numpy(a)
        assert a.tobytes() == b.tobytes(), name


# ---------------------------------------------------------------- interop


@pytest.mark.parametrize("arch", ["chatglm3-6b", "xlstm-125m"])
def test_train_state_crosses_both_ways_bit_for_bit(arch):
    """bfloat16 params by their bits, float32 state, an int32 step."""
    cfg = ref_registry.get_config(arch, smoke=True)
    ref = ref_state_numpy(cfg)
    port = interop.train_state_from_jax(ref, "cpu")
    assert isinstance(port, PS.TrainState)
    assert port.opt.step.dtype == torch.int32 and port.opt.step.shape == ()
    assert_leaves_equal(port, ref)
    back = interop.train_state_to_numpy(port)
    assert isinstance(back, PS.TrainState)
    for a, b in zip(tree_util.flatten(back)[0], jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_init_train_state_mirrors_the_reference_tree():
    rcfg = ref_registry.get_config("mixtral-8x22b", smoke=True)
    pcfg = port_registry.get_config("mixtral-8x22b", smoke=True)
    rs, raxes = RS.init_train_state(jax.random.PRNGKey(0), rcfg)
    ps, paxes = PS.init_train_state(0, pcfg, device="cpu")
    names = [n for n, _ in tree_util.flatten_with_path(ps)[0]]
    assert names == [jax.tree_util.keystr(k) for k, _ in
                     jax.tree_util.tree_flatten_with_path(rs)[0]]
    for a, b in zip(tree_util.flatten(ps)[0], jax.tree.leaves(rs)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    assert paxes == raxes
    assert inspect.signature(PS.init_train_state).parameters[
        "device"].default == "cuda"


# ------------------------------------------------------------------ steps

STEP_CASES = {
    "dense": ("chatglm3-6b", {}),
    "dense_int8": ("chatglm3-6b", {"compression": "int8"}),
    "dense_topk": ("chatglm3-6b", {"compression": "topk",
                                   "topk_frac": 0.05}),
    "moe": ("qwen3-moe-235b-a22b", {}),
    "hybrid": ("zamba2-1.2b", {}),
    "ssm": ("xlstm-125m", {}),
    "audio": ("musicgen-medium", {}),
    "vlm_microbatched": ("phi-3-vision-4.2b", {"microbatches": 2}),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_three_train_steps_agree_with_the_reference(case):
    arch, kw = STEP_CASES[case]
    rcfg, pcfg = f32_smoke(arch)
    tc = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=10, **kw)
    r_step = jax.jit(RS.make_train_step(rcfg, ref_tc(tc)))
    p_step = PS.make_train_step(pcfg, tc)
    ref = ref_state_numpy(rcfg)
    r_state = jax.tree.map(jnp.asarray, ref)
    p_state = interop.train_state_from_jax(ref, "cpu")
    data = loader(rcfg)
    for i in range(3):
        batch = data.batch(i)
        r_state, r_out = r_step(r_state, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        held = [t.clone() for t in tree_util.flatten(p_state)[0]]
        new_state, p_out = p_step(p_state, batch)
        for a, b in zip(tree_util.flatten(p_state)[0], held):
            assert torch.equal(a, b)       # the step is functional
        p_state = new_state
        assert sorted(p_out) == sorted(r_out)
        want = float(r_out["loss"])
        assert abs(float(p_out["loss"]) - want) <= 1e-4 * abs(want), i
        assert float(p_out["wire_bytes_frac"]) == pytest.approx(
            float(r_out["wire_bytes_frac"]))
        assert float(p_out["lr"]) == pytest.approx(float(r_out["lr"]),
                                                   rel=1e-6)
    assert p_state.opt.step.dtype == torch.int32
    assert int(p_state.opt.step) == int(r_state.opt.step) == 3
    bound = 2 * tc.lr * 3
    for a, b in zip(tree_util.flatten(p_state.params)[0],
                    jax.tree.leaves(r_state.params)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= bound


def test_eval_step_agrees_with_the_reference():
    rcfg, pcfg = f32_smoke("mixtral-8x22b")
    tc = TrainConfig()
    ref = ref_state_numpy(rcfg, seed=2)
    batch = loader(rcfg).batch(5)
    r_out = jax.jit(RS.make_eval_step(rcfg, ref_tc(tc)))(
        jax.tree.map(jnp.asarray, ref.params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    p_out = PS.make_eval_step(pcfg, tc)(
        interop.params_from_jax(ref.params, "cpu"), batch)
    assert sorted(p_out) == sorted(r_out)
    for k, v in r_out.items():
        assert abs(float(p_out[k]) - float(v)) <= 1e-5 * abs(float(v)), k


# ------------------------------------------ the reference's trainer tests


def _small():
    cfg = port_registry.get_config("xlstm-125m", smoke=True)
    tc = TrainConfig(lr=3e-3, total_steps=30, warmup_steps=3)
    return cfg, tc, loader(cfg, seq=32, batch=4)


def test_loss_decreases():
    cfg, tc, data = _small()
    t = Trainer(cfg, tc, data, TrainerConfig(log_every=1000),
                log_fn=lambda *_: None, device="cpu")
    hist = t.run(25)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first, (first, last)
    assert [h["step"] for h in hist] == list(range(25))


def test_microbatching_matches_full_batch():
    cfg = port_registry.get_config("chatglm3-6b", smoke=True)
    batch = loader(cfg, seq=16, batch=4).batch(0)
    s1, _ = PS.init_train_state(0, cfg, device="cpu")
    s2, _ = PS.init_train_state(0, cfg, device="cpu")
    st1 = PS.make_train_step(cfg, TrainConfig(microbatches=1))
    st2 = PS.make_train_step(cfg, TrainConfig(microbatches=2))
    s1, m1 = st1(s1, batch)
    s2, m2 = st2(s2, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-3)
    assert sorted(m2) == ["grad_norm", "loss", "lr", "wire_bytes_frac"]
    for a, b in zip(tree_util.flatten(s1.params)[0],
                    tree_util.flatten(s2.params)[0]):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=5e-3)


def test_trainer_restarts_after_failure(tmp_path):
    cfg, tc, data = _small()
    logs = []
    t = Trainer(cfg, tc, data,
                TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5,
                              log_every=1000),
                failure_plan=FailurePlan(at_steps=(12,)),
                log_fn=logs.append, device="cpu")
    hist = t.run(20)
    steps = [h["step"] for h in hist]
    assert 12 in steps and 19 in steps
    # step 10..11 replayed after restart from the step-10 checkpoint
    assert steps.count(11) >= 2
    assert steps == list(range(12)) + list(range(10, 20))
    assert any("restored step 10" in line for line in logs)
    assert ckpt.latest_step(str(tmp_path)) == 20


def test_tmr_store_heals_corrupted_replica(tmp_path):
    cfg, _, _ = _small()
    state, _ = PS.init_train_state(0, cfg, device="cpu")
    tmr_store.save(state, str(tmp_path), 3, replicas=3)
    shard = os.path.join(str(tmp_path), "replica_1", "step_00000003",
                         "shard_p0.npz")
    with np.load(shard) as z:
        arrays = {k: z[k] for k in z.files}
    raw = arrays["leaf_0"].view(np.uint8).reshape(-1)
    raw[:64] ^= 0xA5
    np.savez(shard, **arrays)
    for use_kernel in (False, True):
        restored, step, healed = tmr_store.restore(state, str(tmp_path),
                                                   use_kernel=use_kernel)
        assert (step, healed) == (3, 1)
        for a, b in zip(tree_util.flatten(state)[0],
                        tree_util.flatten(restored)[0]):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_trainer_restarts_from_the_tmr_store(tmp_path):
    cfg, tc, data = _small()
    t = Trainer(cfg, tc, data,
                TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=4,
                              tmr_replicas=3, log_every=1000),
                failure_plan=FailurePlan(at_steps=(6,)),
                log_fn=lambda *_: None, device="cpu")
    hist = t.run(9)
    assert [h["step"] for h in hist] == list(range(6)) + list(range(4, 9))
    proto = t._fresh_state()
    want, step = ckpt.restore(proto, os.path.join(str(tmp_path),
                                                  "replica_0"))
    got, step2, bad = tmr_store.restore(proto, str(tmp_path))
    assert step == step2 == 9 and bad == 0
    assert int(got.opt.step) == 9 and got.opt.step.dtype == torch.int32
    for a, b in zip(tree_util.flatten(want)[0], tree_util.flatten(got)[0]):
        assert torch.equal(a, b)
    for a, b in zip(tree_util.flatten(t._state)[0],
                    tree_util.flatten(got)[0]):
        assert torch.equal(a, b)


def test_trainer_runs_on_the_card_by_default(monkeypatch):
    """No fallback: without a card the trainer raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, tc, data = _small()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, tc, data)
    t = Trainer(cfg, tc, data, device="cpu")
    assert t.stragglers.n_workers == 1 and t.device.type == "cpu"


# ---------------------------------------------------------------- launcher


def test_launcher_trains_restarts_and_prints_the_reference_line(tmp_path,
                                                                capsys):
    argv = ["--arch", "xlstm-125m", "--smoke", "--steps", "12", "--seq",
            "16", "--batch", "4", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "5", "--tmr", "3", "--fail-at", "7",
            "--device", "cpu"]
    assert launch_train.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert "[trainer] FAILURE: node_loss at step 7; restart 1" in out
    assert "[trainer] restored step 5" in out
    last = out[-1]
    assert last.startswith("[train] xlstm-smoke: loss ")
    assert last.endswith(" over 14 recorded steps")   # 0..6, then 5..11
    first, final = (float(x) for x in
                    last.split("loss ")[1].split(" over")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(final)
    assert sorted(os.listdir(tmp_path)) == ["replica_0", "replica_1",
                                            "replica_2"]


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "xlstm-125m", "--smoke", "--steps",
                           "1"])
