"""The port's ``loss_fn``, its gradients and its remat policies against
the reference's.

Weights are drawn by the reference and carried across with
``interop.params_from_jax``; batches come from a numpy seed.  Every smoke
config runs as a float32 copy.  Tolerances:

* the loss and each metric (``nll``, ``z_loss``, ``moe_aux``): 1e-5
  relative (exact float32 products on both sides; only summation order
  differs);
* each gradient leaf from ``torch.autograd.grad`` against ``jax.grad``:
  1e-4 of that leaf's largest |g| (a leaf the loss does not reach is
  zero in both);
* the remat policies ``none`` / ``full`` / ``dots``: equal gradients
  (the recomputation repeats the same float32 operations).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as ref_registry
from repro.models import model as RM
from repro_torch.configs import registry as port_registry
from repro_torch.core import tree as tree_util
from repro_torch.interop import params_from_jax
from repro_torch.models import model as PM

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def f32_smoke(arch, **kw):
    """(reference, port) float32 copies of an arch's smoke config."""
    return (dataclasses.replace(ref_registry.get_config(arch, smoke=True),
                                dtype="float32", **kw),
            dataclasses.replace(port_registry.get_config(arch, smoke=True),
                                dtype="float32", **kw))


def train_batch(cfg, seed: int, b: int = 2, s: int = 16,
                mask: bool = False) -> dict:
    """Tokens, labels (and patches, a mask) as numpy arrays; a hybrid's
    length is a multiple of its ``ssm_chunk``."""
    if cfg.family == "hybrid":
        s = -(-s // cfg.ssm_chunk) * cfg.ssm_chunk
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.n_codebooks) if cfg.family == "audio" else (b, s)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape, dtype=np.int32),
           "labels": rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if mask:
        out["mask"] = (rng.random((b, s)) < 0.7).astype(np.int32)
    return out


def ref_loss_and_grads(params, batch, cfg):
    fn = jax.jit(jax.value_and_grad(lambda p, b: RM.loss_fn(p, b, cfg),
                                    has_aux=True))
    (loss, metrics), grads = fn(jax.tree.map(jnp.asarray, params),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    return loss, metrics, grads


def port_loss_and_grads(params, batch, cfg):
    leaves, structure = tree_util.flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = PM.loss_fn(tree_util.unflatten(structure, leaves),
                               {k: torch.as_tensor(v)
                                for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


@pytest.mark.parametrize("mask", [False, True], ids=["plain", "mask"])
@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_loss_metrics_and_grads_agree_with_the_reference(arch, mask):
    rcfg, pcfg = f32_smoke(arch)
    rp, _ = RM.init(jax.random.PRNGKey(3), rcfg)
    params = jax.tree.map(np.asarray, rp)
    batch = train_batch(rcfg, 1, mask=mask)
    r_loss, r_metrics, r_grads = ref_loss_and_grads(params, batch, rcfg)
    p_loss, p_metrics, p_grads = port_loss_and_grads(
        params_from_jax(params, "cpu"), batch, pcfg)

    assert p_loss.dtype == torch.float32 and p_loss.shape == ()
    assert abs(float(p_loss) - float(r_loss)) <= LOSS_TOL * abs(
        float(r_loss))
    assert sorted(p_metrics) == sorted(r_metrics)
    for k, v in r_metrics.items():
        want = float(v)
        assert abs(float(p_metrics[k]) - want) <= LOSS_TOL * abs(want), k
    if not rcfg.is_moe:
        assert float(p_metrics["moe_aux"]) == 0.0

    ref_leaves = jax.tree_util.tree_flatten_with_path(r_grads)[0]
    names = [n for n, _ in tree_util.flatten_with_path(params)[0]]
    assert names == [jax.tree_util.keystr(k) for k, _ in ref_leaves]
    for name, g, (_, r) in zip(names, p_grads, ref_leaves):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32, name
        scale = np.abs(r).max()
        err = np.abs(g.numpy() - r).max()
        assert err <= GRAD_TOL * scale if scale > 0 else err == 0, name


def test_mask_of_zeros_takes_the_reference_floor():
    """An all-zero mask divides by max(0, 1) = 1 in both packages."""
    rcfg, pcfg = f32_smoke("chatglm3-6b")
    rp, _ = RM.init(jax.random.PRNGKey(4), rcfg)
    params = jax.tree.map(np.asarray, rp)
    batch = train_batch(rcfg, 2, mask=True)
    batch["mask"][:] = 0
    r_loss, r_metrics = jax.jit(RM.loss_fn, static_argnums=2)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, rcfg)
    p_loss, p_metrics = PM.loss_fn(params_from_jax(params, "cpu"),
                                   {k: torch.as_tensor(v)
                                    for k, v in batch.items()}, pcfg)
    assert float(r_loss) == float(p_loss) == 0.0
    assert float(p_metrics["nll"]) == float(r_metrics["nll"]) == 0.0


@pytest.mark.parametrize("z_loss,aux_coef", [(0.0, None), (1e-2, 0.5)])
def test_loss_options_agree_with_the_reference(z_loss, aux_coef):
    rcfg, pcfg = f32_smoke("mixtral-8x22b")
    rp, _ = RM.init(jax.random.PRNGKey(5), rcfg)
    params = jax.tree.map(np.asarray, rp)
    batch = train_batch(rcfg, 3)
    r_loss, _ = jax.jit(RM.loss_fn, static_argnums=(2, 3, 4))(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, rcfg, z_loss,
        aux_coef)
    p_loss, _ = PM.loss_fn(params_from_jax(params, "cpu"),
                           {k: torch.as_tensor(v) for k, v in batch.items()},
                           pcfg, z_loss=z_loss, aux_coef=aux_coef)
    assert abs(float(p_loss) - float(r_loss)) <= LOSS_TOL * float(r_loss)


# ---------------------------------------------------------------- remat


def _grads_under(arch: str, policy: str):
    _, pcfg = f32_smoke(arch, remat=policy)
    params, _ = PM.init(3, pcfg, device="cpu")
    batch = train_batch(pcfg, 1)
    return port_loss_and_grads(params, batch, pcfg)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_remat_policies_give_equal_grads(arch, policy):
    """The MoE dispatch and combine recompute the same routing, so their
    gradients under ``full`` and ``dots`` equal those under ``none``."""
    loss0, _, g0 = _grads_under(arch, "none")
    loss, _, g = _grads_under(arch, policy)
    assert float(loss) == float(loss0)
    for a, b in zip(g, g0):
        assert torch.equal(a, b)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(arch: str, policy: str) -> dict:
    _, pcfg = f32_smoke(arch, remat=policy)
    params, _ = PM.init(3, pcfg, device="cpu")
    leaves, structure = tree_util.flatten(params)
    leaves = [p.requires_grad_() for p in leaves]
    batch = {k: torch.as_tensor(v) for k, v in train_batch(pcfg, 1).items()}
    loss, _ = PM.loss_fn(tree_util.unflatten(structure, leaves), batch, pcfg)
    with _CountOps() as ops:
        torch.autograd.grad(loss, leaves, allow_unused=True)
    return ops.counts


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mixtral-8x22b",
                                  "zamba2-1.2b", "xlstm-125m"])
def test_remat_recomputes_what_the_policy_does_not_save(arch):
    """``full`` recomputes each layer's forward in the backward pass;
    ``dots`` keeps the plain matrix products, so its backward runs as
    many of them as without remat (the ssm family is checkpointed fully
    under any policy, as in the reference)."""
    mm = torch.ops.aten.mm.default
    none, full, dots = (_backward_ops(arch, p)
                        for p in ("none", "full", "dots"))
    assert sum(full.values()) > sum(none.values())
    assert full[mm] > none[mm]
    if arch == "xlstm-125m":
        assert dots == full
    else:
        assert dots[mm] == none[mm]
        assert sum(none.values()) < sum(dots.values()) < sum(full.values())


def test_remat_is_off_without_autograd():
    """Under ``no_grad`` / ``inference_mode`` (prefill, decode, the
    engine) the layers run plainly, and the logits equal remat-free
    ones."""
    _, pcfg = f32_smoke("chatglm3-6b")
    params, _ = PM.init(3, pcfg, device="cpu")
    batch = {"tokens": torch.as_tensor(train_batch(pcfg, 1)["tokens"])}
    with torch.inference_mode():
        a, _ = PM.forward(params, batch, pcfg)
        b, _ = PM.forward(params, batch, dataclasses.replace(pcfg,
                                                             remat="none"))
    assert torch.equal(a, b)


def test_mamba2_grads_stay_finite_where_the_reference_gives_nan():
    """A Mamba2 chunk whose summed decay passes ~88 overflows ``exp``
    above the diagonal of the reference's intra-chunk form; masking after
    the ``exp`` (``src/repro/models/mamba2.py``) then turns the backward
    pass's 0 * inf into NaN.  The port masks before the ``exp``: the same
    loss, finite gradients, and the reference's finite leaves agree."""
    rcfg, pcfg = f32_smoke("zamba2-1.2b")
    rp, _ = RM.init(jax.random.PRNGKey(3), rcfg)
    params = jax.tree.map(np.asarray, rp)
    # dt ~ 14 a step: a smoke chunk of 8 sums to ~100 > log(FLT_MAX)
    params["blocks"]["dt_bias"] = np.full_like(params["blocks"]["dt_bias"],
                                               14.0)
    batch = train_batch(rcfg, 0)
    r_loss, _, r_grads = ref_loss_and_grads(params, batch, rcfg)
    p_loss, _, p_grads = port_loss_and_grads(params_from_jax(params, "cpu"),
                                             batch, pcfg)
    assert np.isfinite(float(r_loss))
    assert abs(float(p_loss) - float(r_loss)) <= LOSS_TOL * abs(
        float(r_loss))
    r_leaves = [np.asarray(r) for r in jax.tree.leaves(r_grads)]
    assert sum(not np.isfinite(r).all() for r in r_leaves) > 0
    assert all(bool(torch.isfinite(g).all()) for g in p_grads)
    for g, r in zip(p_grads, r_leaves):
        if np.isfinite(r).all() and np.abs(r).max() > 0:
            assert np.abs(g.numpy() - r).max() <= GRAD_TOL * np.abs(r).max()


class _StackSized(TorchDispatchMode):
    """Counts the ops whose output has the shape of a stacked leaf."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes, self.n = shapes, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and tuple(out.shape) in self.shapes:
            self.n += 1
        return out


def _stack_sized_backward_ops(arch: str, n_layers: int) -> int:
    _, pcfg = f32_smoke(arch, n_layers=n_layers, remat="none")
    params, _ = PM.init(3, pcfg, device="cpu")
    leaves, structure = tree_util.flatten(params)
    leaves = [p.requires_grad_() for p in leaves]
    stacked = {tuple(p.shape) for p in leaves
               if p.dim() > 1 and p.shape[0] == n_layers}
    batch = {k: torch.as_tensor(v) for k, v in train_batch(pcfg, 1).items()}
    loss, _ = PM.loss_fn(tree_util.unflatten(structure, leaves), batch, pcfg)
    with _StackSized(stacked) as ops:
        torch.autograd.grad(loss, leaves, allow_unused=True)
    return ops.n


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mixtral-8x22b",
                                  "zamba2-1.2b"])
def test_stacked_params_get_their_gradient_stacked_once(arch):
    """The layers' views of a stacked leaf come from one ``unbind``, so
    the backward pass builds each stacked gradient once, however deep
    the model: no zero-filled whole-stack gradient a layer, summed."""
    assert _stack_sized_backward_ops(arch, 3) == \
        _stack_sized_backward_ops(arch, 6) > 0
