"""Shared model components: norms, initializers, parameter plumbing.

Parameter convention: params are nested dicts of tensors; every init
function returns ``(params, axes)`` where ``axes`` mirrors the params tree
with tuples of *logical* sharding axes (see :mod:`repro_torch.dist.
sharding`).  Layer stacks are stacked along a leading axis, as the
reference stacks them for ``lax.scan``, and get ``None`` prepended to
their logical axes.

Initializers draw from an explicit ``torch.Generator`` on the device the
weights live on; they need not match the reference's bits (weights
cross over through :func:`repro_torch.interop.params_from_jax`).  On the
``meta`` device nothing is drawn or allocated: the tensors carry only
their shapes and dtypes (:func:`repro_torch.models.model.init_abstract`).
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch
import torch.nn.functional as F

Axes = tuple


class _Shapes:
    """Stands in for a generator on the ``meta`` device, where no value
    is drawn."""

    device = torch.device("meta")


def generator(key: Union[int, torch.Generator],
              device="cuda") -> torch.Generator:
    """``key`` itself when it is a generator, else one seeded with it on
    ``device`` (on ``meta``, a stand-in that draws nothing)."""
    if isinstance(key, torch.Generator):
        return key
    if torch.device(device).type == "meta":
        return _Shapes()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return gen


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    if isinstance(gen, _Shapes):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, fan_in: int, shape,
               dtype: torch.dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    return (_normal(gen, shape) * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: float = 0.02) -> torch.Tensor:
    return (_normal(gen, shape) * scale).to(dtype)


def zeros_f32(gen: torch.Generator, n: int) -> torch.Tensor:
    """A float32 norm weight of ``n`` zeros on the generator's device."""
    return torch.zeros((n,), dtype=torch.float32, device=gen.device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMSNorm with a ``(1 + weight)`` gain, computed in float32."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(dtype)


def _const(v: float, x: torch.Tensor) -> torch.Tensor:
    """A Python constant in ``x``'s dtype, as JAX rounds a weak-typed one."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it: ``x * (1 / (1 + exp(-x)))``,
    each step rounded to ``x``'s dtype.

    ``F.silu`` rounds once.  In bfloat16 that one-ulp difference, fed
    into a recurrence (Mamba2's conv and gate, the xLSTM gates), moves a
    model's logits away from the reference's by more than the 3e-2 the
    bfloat16 tests allow; the MLP and MoE paths keep ``F.silu`` (one
    launch, and there the difference stays small)."""
    one = _const(1.0, x)
    return x * (one / (one + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` step by step in ``x``'s dtype
    (see :func:`silu` for why and where)."""
    inner = x + _const(0.044715, x) * (x * x * x)
    cdf = _const(0.5, x) * (_const(1.0, x) + torch.tanh(
        _const(math.sqrt(2 / math.pi), x) * inner))
    return x * cdf


def act_fn(name: str) -> Callable:
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def _map_axes(fn, axes):
    if _is_axes_leaf(axes):
        return fn(axes)
    return {k: _map_axes(fn, v) for k, v in axes.items()}


def stack_params(param_list, axes):
    """Stack per-layer param trees along a new leading axis."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    return stack(param_list), _map_axes(lambda a: (None,) + a, axes)


def layer(tree, i: int):
    """Layer ``i``'s view of a stacked param (or cache) dict."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def layers(tree, n: int) -> list:
    """All ``n`` layers' views of a stacked param dict, from one
    ``unbind`` a leaf.  Under autograd a leaf's gradient is then stacked
    once from the layers' gradients; ``n`` views taken by :func:`layer`
    would each give back a zero-filled gradient of the whole stack, and
    summing those moves ``n`` times the stack's bytes."""
    if isinstance(tree, dict):
        per = {k: layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(tree.unbind(0))
