"""Model assembly: embed -> stacked blocks -> head, for all six families.

Public API (functional, as the reference's):

  init(key, cfg, device=)              -> (params, axes)
  forward(params, batch, cfg)          -> (logits, aux)
  loss_fn(params, batch, cfg, ...)     -> (loss, metrics)
  prefill(params, batch, cfg, max_seq) -> (logits, cache)
  decode(params, tokens, cache, cfg)   -> (logits, cache)   (one step)
  fresh_cache(cfg, batch, max_seq)     -> cache
  init_abstract(cfg)                   -> (params on ``meta``, axes)

Transformer, MoE and Mamba blocks keep the reference's stacked
``(L, ...)`` leaves; where the reference runs ``lax.scan`` over them, a
Python loop runs over layer views.  The ``ssm`` family's blocks are a
list of unlike dicts (mLSTM or sLSTM), and the ``hybrid`` and ``ssm``
caches are lists of NamedTuples, as in the reference.

When autograd records, ``forward`` runs each layer under the config's
rematerialization policy, where the reference wraps its scan body in
``jax.checkpoint``: ``"full"`` keeps only each layer's input
(``torch.utils.checkpoint``), ``"dots"`` also keeps the outputs of the
plain matrix products (selective checkpointing; the reference's
``dots_with_no_batch_dims_saveable``), ``"none"`` keeps everything.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constraint
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, mlp, moe, xlstm
from repro_torch.models.common import (embed_init, generator, layer,
                                       layers, rms_norm, stack_params,
                                       zeros_f32)

#: The families this module runs.
FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
#: The families built of transformer blocks.
_TRANSFORMER = ("dense", "moe", "audio", "vlm")


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _init_tblock(gen: torch.Generator, cfg: ModelConfig):
    """One transformer block (dense or MoE)."""
    a_p, a_ax = attn.init_attention(gen, cfg)
    if cfg.is_moe:
        f_p, f_ax = moe.init_moe(gen, cfg)
        fkey = "moe"
    else:
        f_p, f_ax = mlp.init_mlp(gen, cfg)
        fkey = "mlp"
    params = {"ln1": zeros_f32(gen, cfg.d_model), "attn": a_p,
              "ln2": zeros_f32(gen, cfg.d_model), fkey: f_p}
    axes = {"ln1": (None,), "attn": a_ax, "ln2": (None,), fkey: f_ax}
    return params, axes


def _ffn(p, x, cfg: ModelConfig, **moe_kw):
    """The block's feed-forward half: (output, MoE aux loss or None)."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        return moe.moe_forward(p["moe"], h, cfg, **moe_kw)
    return mlp.mlp_forward(p["mlp"], h, cfg), None


def _tblock_forward(p, x, positions, cfg: ModelConfig):
    h = attn.attention_forward(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                               positions, cfg)
    x = x + h
    sp = "sp" if cfg.seq_shard else None
    x = constraint(x, ("batch", sp, None))
    h, aux = _ffn(p, x, cfg)
    # sequence-parallel carry: the saved residual is seq-sharded
    return constraint(x + h, ("batch", sp, None)), aux


def _tblock_decode(p, x, cache, cfg: ModelConfig):
    h, new_cache = attn.attention_decode(
        p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cache, cfg)
    x = x + h
    h, _ = _ffn(p, x, cfg, **({"capacity": max(x.shape[0], 8)}
                              if cfg.is_moe else {}))
    return x + h, new_cache


def _tblock_prefill(p, x, positions, cfg: ModelConfig, max_seq: int):
    h, cache = attn.prefill_cache(
        p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), positions, cfg,
        max_seq)
    x = x + h
    h, _ = _ffn(p, x, cfg)
    return x + h, cache


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------


def _init_embed(gen: torch.Generator, cfg: ModelConfig):
    dt = cfg.compute_dtype
    if cfg.family == "audio":
        p = {"tok": embed_init(gen, (cfg.n_codebooks, cfg.vocab_size,
                                     cfg.d_model), dt)}
        return p, {"tok": (None, "tp", "fsdp")}
    p = {"tok": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt)}
    return p, {"tok": ("tp", "fsdp")}


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table keeps only its vocabulary
    split (its ``fsdp`` split gathered, as before any use of a ZeRO-3
    weight) and goes through ``F.embedding`` (the same rows): DTensor's
    embedding strategy takes a split vocabulary, where an index's
    backward fails on some torch releases and an embedding of a table
    split two ways computes its mask from the wrong rows.  The masked
    partial rows are summed at once: a mask kept for later checks its
    reuse with ``torch.equal``, which ``meta`` tensors do not run."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(table, DTensor):
        return table[tokens]
    table = table.redistribute(table.device_mesh, [
        p if p.is_shard(0) else Replicate() for p in table.placements])
    x = F.embedding(tokens, table)
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def _embed(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.family == "audio":
        # tokens: (B, S, CB); sum codebook embeddings in the compute
        # dtype, codebook by codebook (delay pattern stub)
        x = torch.zeros(tuple(tokens.shape[:2]) + (cfg.d_model,),
                        dtype=cfg.compute_dtype, device=tokens.device)
        for cb in range(cfg.n_codebooks):
            x = x + _lookup(p["tok"][cb], tokens[..., cb])
    else:
        x = _lookup(p["tok"], tokens)
    if cfg.embed_scale:
        scale = torch.sqrt(torch.tensor(float(cfg.d_model),
                                        dtype=torch.float32))
        x = x * scale.to(device=x.device, dtype=x.dtype)
    return x


def _init_head(gen: torch.Generator, cfg: ModelConfig):
    dt = cfg.compute_dtype
    if cfg.family == "audio":
        p = {"w": embed_init(gen, (cfg.n_codebooks, cfg.d_model,
                                   cfg.vocab_size), dt)}
        return p, {"w": (None, "fsdp", "tp")}
    if cfg.tie_embeddings:
        return {}, {}
    p = {"w": embed_init(gen, (cfg.d_model, cfg.vocab_size), dt)}
    return p, {"w": ("fsdp", "tp")}


def _head(p, embed_p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.family == "audio":
        from torch.distributed.tensor import DTensor

        if isinstance(p["w"], DTensor):
            # DTensor's einsum flattens (codebook, vocab) into one split
            # dim it cannot unflatten: one product a codebook instead
            return torch.stack([x @ w for w in p["w"].unbind(0)], dim=2)
        return torch.einsum("bsd,cdv->bscv", x, p["w"])
    if cfg.tie_embeddings:
        return x @ embed_p["tok"].T
    return x @ p["w"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(key: Union[int, torch.Generator], cfg: ModelConfig, *,
         device="cuda"):
    """``(params, axes)`` drawn from ``key`` (a seed or a generator) on
    ``device``; ``axes`` equals the reference's tree."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    gen = generator(key, device)
    emb_p, emb_ax = _init_embed(gen, cfg)
    head_p, head_ax = _init_head(gen, cfg)
    params: dict[str, Any] = {"embed": emb_p, "head": head_p,
                              "ln_f": zeros_f32(gen, cfg.d_model)}
    axes: dict[str, Any] = {"embed": emb_ax, "head": head_ax, "ln_f": (None,)}
    if cfg.family == "ssm":
        blocks, baxes = [], []
        for i in range(cfg.n_layers):
            if i in cfg.slstm_layers:
                p, ax = xlstm.init_slstm(gen, cfg)
            else:
                p, ax = xlstm.init_mlstm(gen, cfg)
            blocks.append({"ln": zeros_f32(gen, cfg.d_model), "mix": p})
            baxes.append({"ln": (None,), "mix": ax})
        params["blocks"], axes["blocks"] = blocks, baxes
    elif cfg.n_layers == 0:  # the reference's roofline composition point
        params["blocks"], axes["blocks"] = {}, {}
    elif cfg.family == "hybrid":
        layers = [mamba2.init_mamba2(gen, cfg) for _ in range(cfg.n_layers)]
        params["blocks"], axes["blocks"] = stack_params(
            [p for p, _ in layers], layers[0][1])
        params["mamba_ln"] = torch.zeros((cfg.n_layers, cfg.d_model),
                                         dtype=torch.float32,
                                         device=gen.device)
        axes["mamba_ln"] = (None, None)
        # the Zamba *shared* attention block (one set, reused)
        params["shared_attn"], axes["shared_attn"] = _init_tblock(gen, cfg)
    else:
        layers = [_init_tblock(gen, cfg) for _ in range(cfg.n_layers)]
        params["blocks"], axes["blocks"] = stack_params(
            [p for p, _ in layers], layers[0][1])
    return params, axes


def init_abstract(cfg: ModelConfig):
    """``(params, axes)`` with no allocation: every leaf a ``meta``
    tensor of the real shape and dtype."""
    return init(0, cfg, device="meta")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _inputs(params, batch, cfg: ModelConfig):
    """Embedded tokens (patches prepended for a vlm) and positions."""
    tokens = batch["tokens"]
    x = _embed(params["embed"], tokens, cfg)
    if cfg.family == "vlm" and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    return x, positions


def _ssm_mix(bp, x, i: int, cfg: ModelConfig):
    """Layer ``i`` of an ssm stack over a sequence: (output, state)."""
    h = rms_norm(x, bp["ln"], cfg.norm_eps)
    if i in cfg.slstm_layers:
        return xlstm.slstm_forward(bp["mix"], h, cfg)
    return xlstm.mlstm_forward(bp["mix"], h, cfg)


#: The plain matrix products (no batch dimension) that ``"dots"`` keeps.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(fn, policy: str):
    """``fn`` under rematerialization ``policy`` (``none`` / ``full`` /
    ``dots``) while autograd records; ``fn`` itself otherwise."""
    if policy == "none":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        kw = {"context_fn": _save_dots} if policy == "dots" else {}
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def _ssm_layer(bp, x, i: int, cfg: ModelConfig):
    y, _ = _ssm_mix(bp, x, i, cfg)
    return constraint(x + y, ("batch", "sp", None))


def forward(params, batch, cfg: ModelConfig):
    """Logits over the whole sequence, and the summed MoE aux loss."""
    x, positions = _inputs(params, batch, cfg)
    x = constraint(x, ("batch", "sp", None))
    aux_total = _zero(x)
    if cfg.family in _TRANSFORMER:
        block = _remat(_tblock_forward, cfg.remat)
        for lp in layers(params["blocks"], cfg.n_layers):
            x, a = block(lp, x, positions, cfg)
            if a is not None:
                aux_total = aux_total + a
    elif cfg.family == "hybrid":
        x, aux_total = _zamba_forward(params, x, positions, cfg)
    else:
        # the reference checkpoints each ssm layer fully under any policy
        ssm = _remat(_ssm_layer, "none" if cfg.remat == "none" else "full")
        for i, bp in enumerate(params["blocks"]):
            x = ssm(bp, x, i, cfg)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _head(params["head"], params["embed"], x, cfg)
    if cfg.family == "vlm" and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:]
    return logits, aux_total


def _zamba_groups(cfg: ModelConfig):
    per = cfg.attn_every
    n_full = cfg.n_layers // per
    rem = cfg.n_layers - n_full * per
    return n_full, per, rem


def _group_layers(cfg: ModelConfig):
    """The Mamba layer indices of each group: ``n_full`` groups of
    ``per`` (each followed by the shared block), then the remainder."""
    n_full, per, rem = _zamba_groups(cfg)
    groups = [range(g * per, (g + 1) * per) for g in range(n_full)]
    if rem:
        groups.append(range(cfg.n_layers - rem, cfg.n_layers))
    return groups, n_full


def _mamba_layer(params, x, i: int, cfg: ModelConfig, state=None,
                 step: bool = False):
    h = rms_norm(x, params["mamba_ln"][i], cfg.norm_eps)
    lp = layer(params["blocks"], i)
    if step:
        return mamba2.mamba2_decode(lp, h, cfg, state)
    return mamba2.mamba2_forward(lp, h, cfg)


def _stack_states(states: list):
    """Per-layer NamedTuple states -> one of stacked (n, ...) leaves."""
    return type(states[0])(*(torch.stack(leaves) for leaves in zip(*states)))


def _mamba_residual(lp, ln, x, cfg: ModelConfig):
    y, _ = mamba2.mamba2_forward(lp, rms_norm(x, ln, cfg.norm_eps), cfg)
    return constraint(x + y, ("batch", "sp", None))


def _zamba_forward(params, x, positions, cfg: ModelConfig):
    groups, n_full = _group_layers(cfg)
    body = _remat(_mamba_residual, cfg.remat)
    shared = _remat(_tblock_forward, cfg.remat)
    blocks = layers(params["blocks"], cfg.n_layers)
    lns = params["mamba_ln"].unbind(0)
    aux = _zero(x)
    for g, idx in enumerate(groups):
        for i in idx:
            x = body(blocks[i], lns[i], x, cfg)
        if g < n_full:
            x, a = shared(params["shared_attn"], x, positions, cfg)
            if a is not None:
                aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def _logsumexp(lg: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last (vocabulary) dim.  DTensor gathers a
    split dim whole for ``torch.logsumexp``; a split DTensor takes the
    max and the sum of exponentials instead, each reduced across ranks,
    so the logits stay split."""
    from torch.distributed.tensor import DTensor

    last = lg.dim() - 1
    if not (isinstance(lg, DTensor)
            and any(p.is_shard(last) for p in lg.placements)):
        return torch.logsumexp(lg, dim=-1)
    m = lg.detach().amax(dim=-1, keepdim=True)
    return (m + torch.log(torch.exp(lg - m).sum(-1, keepdim=True)))[..., 0]


def _label_logit(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``lg``'s value at each label along the last (vocabulary) dim.

    A plain tensor takes it with ``torch.gather``.  A DTensor whose
    vocabulary dim is split has no gather along it: it contracts with a
    one-hot, as the reference does so that the dim stays split, against
    a vocabulary index split as the logits are (each rank its own range,
    no collective).  Both give the same number for finite logits.
    """
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    last = lg.dim() - 1
    if not (isinstance(lg, DTensor)
            and any(p.is_shard(last) for p in lg.placements)):
        return torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    vocab = distribute_tensor(
        torch.arange(lg.shape[-1], device=lg.to_local().device),
        lg.device_mesh,
        [Shard(0) if p.is_shard(last) else Replicate()
         for p in lg.placements], src_data_rank=None)
    return (lg * (labels.long()[..., None] == vocab)).sum(-1)


def loss_fn(params, batch, cfg: ModelConfig, z_loss: float = 1e-4,
            aux_coef: Optional[float] = None):
    """Mean next-token cross-entropy (masked where ``batch["mask"]`` is
    given) plus ``z_loss`` times the mean squared log-partition, plus the
    MoE aux loss; returns ``(loss, {nll, z_loss, moe_aux})``.

    The log-partition and the label's logit are taken by
    :func:`_logsumexp` and :func:`_label_logit`, which keep a split
    vocabulary split.
    """
    logits, aux = forward(params, batch, cfg)
    labels = batch["labels"]
    lg = logits.float()
    lse = _logsumexp(lg)
    nll = lse - _label_logit(lg, labels)
    if "mask" in batch:
        mask = batch["mask"].float()
        if mask.dim() < nll.dim():
            mask = mask[..., None]
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (nll * mask).sum() / denom
        zl = (torch.square(lse) * mask).sum() / denom
    else:
        loss = nll.mean()
        zl = torch.square(lse).mean()
    total = loss + z_loss * zl
    coef = cfg.router_aux_coef if aux_coef is None else aux_coef
    if cfg.is_moe:
        total = total + coef * aux / cfg.n_layers
    return total, {"nll": loss, "z_loss": zl, "moe_aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


class ServeCache(NamedTuple):
    layers: Any         # stacked per-layer cache, or a list of states
    extra: Any          # family-specific (the shared attention's caches)


def prefill(params, batch, cfg: ModelConfig, max_seq: int):
    """Last-position logits and the cache after the whole prompt."""
    x, positions = _inputs(params, batch, cfg)
    if cfg.family in _TRANSFORMER:
        caches = []
        for i in range(cfg.n_layers):
            x, cache = _tblock_prefill(layer(params["blocks"], i), x,
                                       positions, cfg, max_seq)
            caches.append(cache)
        sc = ServeCache(_stack_states(caches) if caches else None, None)
    elif cfg.family == "hybrid":
        x, sc = _zamba_prefill(params, x, positions, cfg, max_seq)
    else:
        states = []
        for i, bp in enumerate(params["blocks"]):
            y, st = _ssm_mix(bp, x, i, cfg)
            x = x + y
            states.append(st)
        sc = ServeCache(states, None)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _head(params["head"], params["embed"], x[:, -1:], cfg)
    return logits, sc


def _zamba_prefill(params, x, positions, cfg: ModelConfig, max_seq: int):
    groups, n_full = _group_layers(cfg)
    m_states, attn_caches = [], []
    for g, idx in enumerate(groups):
        sts = []
        for i in idx:
            y, st = _mamba_layer(params, x, i, cfg)
            x = x + y
            sts.append(st)
        m_states.append(_stack_states(sts))
        if g < n_full:
            x, cache = _tblock_prefill(params["shared_attn"], x, positions,
                                       cfg, max_seq)
            attn_caches.append(cache)
    return x, ServeCache(m_states, attn_caches)


def decode(params, tokens: torch.Tensor, cache: ServeCache,
           cfg: ModelConfig):
    """One decode step.  tokens: (B, 1) (audio: (B, 1, CB)).  ``cache``
    itself is left as it was."""
    x = _embed(params["embed"], tokens, cfg)
    if cfg.family in _TRANSFORMER:
        new_caches = []
        for i in range(cfg.n_layers):
            x, c = _tblock_decode(layer(params["blocks"], i), x,
                                  attn.KVCache(*(t[i] for t in cache.layers)),
                                  cfg)
            new_caches.append(c)
        layers = _stack_states(new_caches) if new_caches else cache.layers
        new_sc = ServeCache(layers, None)
    elif cfg.family == "hybrid":
        x, new_sc = _zamba_decode(params, x, cache, cfg)
    else:
        states = []
        for i, bp in enumerate(params["blocks"]):
            h = rms_norm(x, bp["ln"], cfg.norm_eps)
            step = (xlstm.slstm_decode if i in cfg.slstm_layers
                    else xlstm.mlstm_decode)
            y, st = step(bp["mix"], h, cfg, cache.layers[i])
            x = x + y
            states.append(st)
        new_sc = ServeCache(states, None)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _head(params["head"], params["embed"], x, cfg)
    return logits, new_sc


def _zamba_decode(params, x, cache: ServeCache, cfg: ModelConfig):
    groups, n_full = _group_layers(cfg)
    new_m, new_a = [], []
    for g, idx in enumerate(groups):
        stacked = cache.layers[g]
        sts = []
        for j, i in enumerate(idx):
            y, st = _mamba_layer(params, x, i, cfg,
                                 state=type(stacked)(*(t[j] for t in stacked)),
                                 step=True)
            x = x + y
            sts.append(st)
        new_m.append(_stack_states(sts))
        if g < n_full:
            x, ac = _tblock_decode(params["shared_attn"], x, cache.extra[g],
                                   cfg)
            new_a.append(ac)
    return x, ServeCache(new_m, new_a)


# ---------------------------------------------------------------------------
# cache constructors (decode-from-scratch path)
# ---------------------------------------------------------------------------


def _broadcast(state, n: int):
    """A NamedTuple state repeated ``n`` times along a new leading axis
    (a view, as the reference's ``broadcast_to``)."""
    return type(state)(*(t[None].expand((n,) + tuple(t.shape))
                         for t in state))


def fresh_cache(cfg: ModelConfig, batch: int, max_seq: int,
                device="cuda") -> ServeCache:
    """A cache as it would exist after prefilling ``max_seq`` tokens."""
    def attn_cache():
        ac = attn.init_cache(cfg, batch, max_seq, device=device)
        return ac._replace(pos=torch.full((batch,), max_seq,
                                          dtype=torch.int32, device=device))

    if cfg.family in _TRANSFORMER:
        layers = _broadcast(attn.init_cache(cfg, batch, max_seq,
                                            device=device), cfg.n_layers)
        layers = layers._replace(pos=torch.full(
            (cfg.n_layers, batch), max_seq, dtype=torch.int32,
            device=device))
        return ServeCache(layers, None)
    if cfg.family == "hybrid":
        groups, n_full = _group_layers(cfg)
        m_states = [_broadcast(mamba2.init_mamba_state(cfg, batch, device),
                               len(idx)) for idx in groups]
        return ServeCache(m_states, [attn_cache() for _ in range(n_full)])
    if cfg.family == "ssm":
        return ServeCache(
            [xlstm.init_slstm_state(cfg, batch, device)
             if i in cfg.slstm_layers
             else xlstm.init_mlstm_state(cfg, batch, device)
             for i in range(cfg.n_layers)], None)
    raise ValueError(cfg.family)
