"""AdamW with decoupled weight decay, grad clipping, ZeRO-friendly state.

Optimizer state mirrors parameter sharding (m/v get the same logical axes
as their parameter), which combined with the FSDP rules *is* the ZeRO
partitioning — no separate machinery needed.  fp32 master weights are kept
when params are low-precision.

Functional, as the reference's: :func:`apply_updates` returns new
tensors and leaves the ones it was given as they were.  ``step`` is a 0-d
``int32`` tensor, as the reference's, so a checkpoint holds the same
leaves in both packages.  The update runs under ``torch.no_grad()`` and
works in place only on tensors it has just made.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import tree as tree_util


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any
    master: Any  # fp32 copies of low-precision params


def _map(fn, tree):
    leaves, structure = tree_util.flatten(tree)
    return tree_util.unflatten(structure, [fn(x) for x in leaves])


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def init_state(params) -> AdamWState:
    leaves = tree_util.flatten(params)[0]
    device = leaves[0].device if leaves else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=_map(_zeros_f32, params), v=_map(_zeros_f32, params),
        master=_map(lambda p: p.detach().to(torch.float32, copy=True),
                    params))


def state_axes(param_axes) -> AdamWState:
    """Logical axes for the optimizer state (mirrors params)."""
    return AdamWState(step=(), m=param_axes, v=param_axes, master=param_axes)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float()))
              for x in tree_util.flatten(tree)[0]]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-6), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return _map(lambda g: g.float() * scale, grads), norm


def lr_schedule(tc: TrainConfig):
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = tc.lr * (step + 1) / max(tc.warmup_steps, 1)
        prog = torch.clamp((step - tc.warmup_steps)
                           / max(tc.total_steps - tc.warmup_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * tc.lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < tc.warmup_steps, warm,
                           torch.clamp(cos, min=0.1 * tc.lr))
    return lr


@torch.no_grad()
def apply_updates(params, state: AdamWState, grads, tc: TrainConfig):
    """One AdamW step; returns (new_params, new_state, metrics).

    Each gradient is clipped as :func:`clip_by_global_norm` clips it, one
    leaf at a time, so only one float32 copy of a gradient is alive.
    """
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, tc.grad_clip)
    step = state.step + 1
    lr = lr_schedule(tc)(step)
    b1, b2, eps = tc.b1, tc.b2, tc.eps
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(m, v, g, master):
        g = g.float() * scale
        m2 = b1 * m
        m2 += (1 - b1) * g
        v2 = b2 * v
        v2 += (1 - b2) * torch.square(g)
        del g
        delta = (m2 / bc1).div_(torch.sqrt(v2 / bc2).add_(eps))
        delta += tc.weight_decay * master
        return m2, v2, master - lr * delta

    flat_m, structure = tree_util.flatten(state.m)
    flat_v = tree_util.flatten(state.v)[0]
    flat_g = tree_util.flatten(grads)[0]
    flat_w = tree_util.flatten(state.master)[0]
    outs = [upd(m, v, g, w) for m, v, g, w in
            zip(flat_m, flat_v, flat_g, flat_w)]
    new_m, new_v, new_master = (
        tree_util.unflatten(structure, [o[i] for o in outs])
        for i in range(3))
    new_params = tree_util.unflatten(structure, [
        w.to(p.dtype) for w, p in zip(tree_util.flatten(new_master)[0],
                                      tree_util.flatten(params)[0])])
    return new_params, AdamWState(step, new_m, new_v, new_master), {
        "grad_norm": gnorm, "lr": lr}
