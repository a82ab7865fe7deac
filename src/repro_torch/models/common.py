"""Shared model components: norms, initializers, parameter plumbing.

Parameter convention: params are nested dicts of tensors; every init
function returns ``(params, axes)`` where ``axes`` mirrors the params tree
with tuples of *logical* sharding axes (see :mod:`repro_torch.dist.
sharding`).  Layer stacks are stacked along a leading axis, as the
reference stacks them for ``lax.scan``, and get ``None`` prepended to
their logical axes.

Initializers draw from an explicit ``torch.Generator`` on the device the
weights live on; they need not match the reference's bits (weights
cross over through :func:`repro_torch.interop.params_from_jax`).
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch
import torch.nn.functional as F

Axes = tuple


def generator(key: Union[int, torch.Generator],
              device="cuda") -> torch.Generator:
    """``key`` itself when it is a generator, else one seeded with it on
    ``device``."""
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return gen


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
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
