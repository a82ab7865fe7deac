"""train_step: loss -> grads -> AdamW, with microbatching and compression.

The step runs eagerly (the reference jits it).  ``jax.value_and_grad``
becomes ``torch.autograd.grad`` over the parameter leaves, and the
reference's microbatch ``scan`` a loop that sums float32 grads, so peak
activation memory is one microbatch (plus the remat policy inside the
model).  A step leaves the state it was given as it was and returns a
new one, as the reference's does.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import tree as tree_util
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    feedback: comp.ErrorFeedback


def init_train_state(key: Union[int, torch.Generator], cfg: ModelConfig,
                     device="cuda") -> tuple[TrainState, Any]:
    """A fresh state on ``device`` (params drawn by ``M.init(key, ...)``)
    and its logical axes; raises where ``device`` is a card and none is
    present."""
    params, axes = M.init(key, cfg, device=device)
    state = TrainState(params=params, opt=adamw.init_state(params),
                       feedback=comp.init_feedback(params))
    state_axes = TrainState(params=axes, opt=adamw.state_axes(axes),
                            feedback=comp.ErrorFeedback(axes))
    return state, state_axes


def _device_of(params) -> torch.device:
    return tree_util.flatten(params)[0][0].device


def batch_to(batch: dict, device) -> dict:
    """The batch's numpy arrays as tensors on ``device`` (tensors moved)."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def _in_layout(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The gradient ``g`` laid out as its param ``p``, as ``jax.grad``
    gives it.  A DTensor gradient may come back pending a sum across
    ranks (``Partial``); left so, every later op that reads it (the
    global norm, then the update) would reduce it again.  A plain
    tensor is returned as is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(g, DTensor) or g.placements == p.placements:
        return g
    return g.redistribute(p.device_mesh, p.placements)


def loss_and_grads(params, batch: dict, cfg: ModelConfig, z_loss: float):
    """``(loss, metrics, grads)`` of ``M.loss_fn`` on a batch of tensors
    (``jax.value_and_grad``'s counterpart); a param the loss does not
    reach gets a zero gradient, as under ``jax.grad``."""
    leaves, structure = tree_util.flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, metrics = M.loss_fn(tree_util.unflatten(structure, leaves),
                                  batch, cfg, z_loss=z_loss)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _in_layout(g, p)
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_util.unflatten(structure, grads)


def _microbatches(v: torch.Tensor, mb: int) -> torch.Tensor:
    """``v`` as ``mb`` microbatches along a new leading dim: consecutive
    rows, as the reference splits them.  A DTensor split along its rows
    has no view that cuts them so (a microbatch would lie on a few
    ranks): its split moves to another dim first (an all-to-all, or a
    gather where no dim divides), the rows are cut, and the split moves
    onto each microbatch's rows (another all-to-all), so every
    microbatch is split over the ranks that split the batch."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    rows = ([i for i, p in enumerate(v.placements) if p.is_shard(0)]
            if isinstance(v, DTensor) else [])
    if not rows:
        return v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
    mesh = v.device_mesh
    parts = math.prod(mesh.size(i) for i in rows)
    split = {p.dim for p in v.placements if p.is_shard()}
    free = [d for d in range(1, v.dim())
            if d not in split and v.shape[d] % parts == 0]
    aside = Shard(free[0]) if free else Replicate()
    v = v.redistribute(mesh, [aside if i in rows else p
                              for i, p in enumerate(v.placements)])
    v = v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
    return v.redistribute(mesh, [Shard(1) if i in rows else p
                                 for i, p in enumerate(v.placements)])


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns fn(state, batch) -> (state, metrics)."""

    def step(state: TrainState, batch):
        batch = batch_to(batch, _device_of(state.params))
        if tc.microbatches > 1:
            mb = tc.microbatches
            batches = {k: _microbatches(v, mb) for k, v in batch.items()}
            leaves, structure = tree_util.flatten(state.params)
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in leaves]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=_device_of(state.params))
            for i in range(mb):
                loss, _, g = loss_and_grads(
                    state.params, {k: v[i] for k, v in batches.items()},
                    cfg, tc.z_loss)
                for acc, gi in zip(gsum, tree_util.flatten(g)[0]):
                    acc += gi.float()
                lsum = lsum + loss
                del g
            grads = tree_util.unflatten(structure, [g / mb for g in gsum])
            loss_val = lsum / mb
            metrics = {}
        else:
            loss_val, metrics, grads = loss_and_grads(state.params, batch,
                                                       cfg, tc.z_loss)

        grads, feedback, cstats = comp.compress(
            grads, state.feedback, tc.compression, tc.topk_frac)
        params, opt, ostats = adamw.apply_updates(
            state.params, state.opt, grads, tc)
        out = {"loss": loss_val, **ostats, **cstats}
        out.update(metrics)
        return TrainState(params, opt, feedback), out

    return step


def make_eval_step(cfg: ModelConfig, tc: TrainConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        batch = batch_to(batch, _device_of(params))
        loss, metrics = M.loss_fn(params, batch, cfg, z_loss=0.0)
        return {"loss": loss, **metrics}
    return eval_step
