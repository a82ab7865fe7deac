"""Abstract inputs and shardings for every (arch x shape) cell.

Everything here is allocation-free: every leaf is a ``meta`` tensor of
the real shape and dtype (``M.init_abstract``, ``fresh_cache(...,
device="meta")``), and the shardings come from the logical-axis rules.
The dry run (:mod:`repro_torch.launch.dryrun`) places these trees as
DTensors and runs

    train_step(state, batch)            for train shapes
    prefill(params, batch)              for prefill shapes
    decode(params, tokens, cache)       for decode shapes (incl. long_500k)

with caches sized to the shape's context length.  A spec entry is
``None`` (replicated), one mesh axis name, or a tuple of them, as
:class:`repro_torch.dist.sharding.Sharding` takes it.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import (Mesh, Sharding, _is_axes_leaf,
                                       sharding_for, tree_shardings)
from repro_torch.models import model as M
from repro_torch.models.attention import KVCache
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp
from repro_torch.train.step import TrainState


def _dp_axes(mesh: Mesh, batch: int | None = None) -> tuple[str, ...]:
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if batch is not None:
        extent = 1
        for a in axes:
            extent *= mesh.shape[a]
        if batch % extent != 0:
            return ()  # e.g. long_500k's global_batch=1: replicate
    return axes


def _entry(axes: tuple[str, ...]):
    """A spec entry for a dim split over ``axes`` (none: replicated)."""
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                with_labels: bool):
    dp = _entry(_dp_axes(mesh, shape.global_batch))
    gb, s = shape.global_batch, shape.seq_len
    tok_shape = (gb, s, cfg.n_codebooks) if cfg.family == "audio" else (gb, s)
    specs = {"tokens": _meta(tok_shape, torch.int32)}
    shardings = {"tokens": Sharding(mesh, (dp,))}
    if with_labels:
        specs["labels"] = _meta(tok_shape, torch.int32)
        shardings["labels"] = Sharding(mesh, (dp,))
    if cfg.family == "vlm":
        specs["patches"] = _meta((gb, cfg.n_patches, cfg.d_model),
                                 torch.float32)
        shardings["patches"] = Sharding(mesh, (dp, None, None))
    return specs, shardings


def params_specs(cfg: ModelConfig, mesh: Mesh):
    abstract, axes = M.init_abstract(cfg)
    return abstract, tree_shardings(axes, mesh), axes


def state_specs(cfg: ModelConfig, mesh: Mesh):
    """Abstract TrainState + shardings (ZeRO: opt state mirrors params)."""
    params_abs, param_axes = M.init_abstract(cfg)
    abstract = TrainState(params=params_abs,
                          opt=adamw.init_state(params_abs),
                          feedback=comp.init_feedback(params_abs))
    st_axes = TrainState(params=param_axes,
                         opt=adamw.state_axes(param_axes),
                         feedback=comp.ErrorFeedback(param_axes))
    return abstract, tree_shardings(st_axes, mesh), st_axes


def cache_axes_tree(cfg: ModelConfig, cache_abstract: M.ServeCache):
    """Logical axes matching a ServeCache structure.

    KV caches: batch over dp, head_dim over tp (head_dim is divisible by
    the TP degree for every assigned arch, and the dynamic-position cache
    update touches only the *unsharded* seq dim — no resharding on decode).
    Mamba states: heads over tp.  xLSTM states: batch only (125M model).
    """
    def kv_axes(stacked: bool):
        lead = (None,) if stacked else ()
        return KVCache(k=lead + ("kv_batch", None, None, "tp"),
                       v=lead + ("kv_batch", None, None, "tp"),
                       pos=lead + ("kv_batch",))

    if cfg.family in ("dense", "moe", "audio", "vlm"):
        return M.ServeCache(kv_axes(stacked=True), None)
    if cfg.family == "hybrid":
        from repro_torch.models.mamba2 import MambaState

        m_axes = [MambaState(h=(None, "kv_batch", "tp", None, None),
                             conv=(None, "kv_batch", None, "tp"))
                  for _ in cache_abstract.layers]
        a_axes = [kv_axes(stacked=False) for _ in (cache_abstract.extra or [])]
        return M.ServeCache(m_axes, a_axes)
    if cfg.family == "ssm":
        from repro_torch.models.xlstm import MLSTMState, SLSTMState

        axes = []
        for st in cache_abstract.layers:
            if isinstance(st, MLSTMState):
                axes.append(MLSTMState(c=("kv_batch", None, None, None),
                                       n=("kv_batch", None, None),
                                       m=("kv_batch", None)))
            else:
                axes.append(SLSTMState(
                    c=("kv_batch", None), n=("kv_batch", None),
                    h=("kv_batch", None), m=("kv_batch", None)))
        return M.ServeCache(axes, None)
    raise ValueError(cfg.family)


def _map_axes(fn, node):
    """``fn`` applied to every logical-axes leaf of an axes tree."""
    if node is None:
        return None
    if _is_axes_leaf(node):
        return fn(node)
    if isinstance(node, dict):
        return type(node)((k, _map_axes(fn, v)) for k, v in node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map_axes(fn, v) for v in node))
    return type(node)(_map_axes(fn, v) for v in node)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh):
    """(tok_spec, cache_spec, tok_sharding, cache_sharding) for decode."""
    dp = _dp_axes(mesh, shape.global_batch)
    gb = shape.global_batch
    tshape = (gb, 1, cfg.n_codebooks) if cfg.family == "audio" else (gb, 1)
    tok_spec = _meta(tshape, torch.int32)
    tok_shard = sharding_for(tshape, ("batch",) + (None,) * (len(tshape) - 1),
                             mesh)
    cache_abs = M.fresh_cache(cfg, gb, shape.seq_len, device="meta")
    axes = cache_axes_tree(cfg, cache_abs)
    if not dp:  # tiny global batch (long_500k): replicate the batch dim
        axes = _map_axes(lambda t: tuple(
            None if a in ("batch", "kv_batch") else a for a in t), axes)
    cache_shard = tree_shardings(axes, mesh)
    return tok_spec, cache_abs, tok_shard, cache_shard
