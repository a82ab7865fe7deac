"""Model assembly: embed -> stacked blocks -> head, for the transformer
families ``dense``, ``audio`` and ``vlm``.

Public API (functional, as the reference's):

  init(key, cfg, device=)              -> (params, axes)
  forward(params, batch, cfg)          -> (logits, aux)
  prefill(params, batch, cfg, max_seq) -> (logits, cache)
  decode(params, tokens, cache, cfg)   -> (logits, cache)   (one step)
  fresh_cache(cfg, batch, max_seq)     -> cache

Blocks keep the reference's stacked ``(L, ...)`` leaves; where the
reference runs ``lax.scan`` over them, a Python loop runs over layer
views.  The ``moe``, ``hybrid`` and ``ssm`` families are not ported yet
(ROADMAP queue 1): their configs load, and these functions raise
``NotImplementedError`` for them.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constraint
from repro_torch.models import attention as attn
from repro_torch.models import mlp
from repro_torch.models.common import (embed_init, generator, layer,
                                       rms_norm, stack_params, zeros_f32)

#: The families this module runs.
FAMILIES = ("dense", "audio", "vlm")


def _require_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP queue 1: the moe, hybrid and ssm families); "
            f"ported: {', '.join(FAMILIES)}")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _init_tblock(gen: torch.Generator, cfg: ModelConfig):
    """One transformer block (dense MLP)."""
    a_p, a_ax = attn.init_attention(gen, cfg)
    f_p, f_ax = mlp.init_mlp(gen, cfg)
    params = {"ln1": zeros_f32(gen, cfg.d_model), "attn": a_p,
              "ln2": zeros_f32(gen, cfg.d_model), "mlp": f_p}
    axes = {"ln1": (None,), "attn": a_ax, "ln2": (None,), "mlp": f_ax}
    return params, axes


def _tblock_forward(p, x, positions, cfg: ModelConfig):
    h = attn.attention_forward(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                               positions, cfg)
    x = x + h
    sp = "sp" if cfg.seq_shard else None
    x = constraint(x, ("batch", sp, None))
    h = mlp.mlp_forward(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return constraint(x + h, ("batch", sp, None))


def _tblock_decode(p, x, cache, cfg: ModelConfig):
    h, new_cache = attn.attention_decode(
        p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cache, cfg)
    x = x + h
    h = mlp.mlp_forward(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + h, new_cache


def _tblock_prefill(p, x, positions, cfg: ModelConfig, max_seq: int):
    h, cache = attn.prefill_cache(
        p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), positions, cfg,
        max_seq)
    x = x + h
    h = mlp.mlp_forward(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
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


def _embed(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.family == "audio":
        # tokens: (B, S, CB); sum codebook embeddings in the compute
        # dtype, codebook by codebook (delay pattern stub)
        x = torch.zeros(tuple(tokens.shape[:2]) + (cfg.d_model,),
                        dtype=cfg.compute_dtype, device=tokens.device)
        for cb in range(cfg.n_codebooks):
            x = x + p["tok"][cb][tokens[..., cb]]
    else:
        x = p["tok"][tokens]
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
    _require_family(cfg)
    gen = generator(key, device)
    emb_p, emb_ax = _init_embed(gen, cfg)
    head_p, head_ax = _init_head(gen, cfg)
    params: dict[str, Any] = {"embed": emb_p, "head": head_p,
                              "ln_f": zeros_f32(gen, cfg.d_model)}
    axes: dict[str, Any] = {"embed": emb_ax, "head": head_ax, "ln_f": (None,)}
    if cfg.n_layers == 0:  # the reference's roofline composition point
        params["blocks"], axes["blocks"] = {}, {}
    else:
        layers = [_init_tblock(gen, cfg) for _ in range(cfg.n_layers)]
        params["blocks"], axes["blocks"] = stack_params(
            [p for p, _ in layers], layers[0][1])
    return params, axes


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


def forward(params, batch, cfg: ModelConfig):
    """Logits over the whole sequence, and the MoE aux loss (0 here)."""
    _require_family(cfg)
    x, positions = _inputs(params, batch, cfg)
    x = constraint(x, ("batch", "sp", None))
    for i in range(cfg.n_layers):
        x = _tblock_forward(layer(params["blocks"], i), x, positions, cfg)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _head(params["head"], params["embed"], x, cfg)
    if cfg.family == "vlm" and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:]
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


class ServeCache(NamedTuple):
    layers: Any         # stacked per-layer cache (a KVCache of (L, ...))
    extra: Any          # family-specific (None for the ported families)


def _stack_caches(caches: list) -> attn.KVCache:
    return attn.KVCache(*(torch.stack(leaves) for leaves in zip(*caches)))


def prefill(params, batch, cfg: ModelConfig, max_seq: int):
    """Last-position logits and the cache after the whole prompt."""
    _require_family(cfg)
    x, positions = _inputs(params, batch, cfg)
    caches = []
    for i in range(cfg.n_layers):
        x, cache = _tblock_prefill(layer(params["blocks"], i), x, positions,
                                   cfg, max_seq)
        caches.append(cache)
    sc = ServeCache(_stack_caches(caches) if caches else None, None)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _head(params["head"], params["embed"], x[:, -1:], cfg)
    return logits, sc


def decode(params, tokens: torch.Tensor, cache: ServeCache,
           cfg: ModelConfig):
    """One decode step.  tokens: (B, 1) (audio: (B, 1, CB)).  ``cache``
    itself is left as it was."""
    _require_family(cfg)
    x = _embed(params["embed"], tokens, cfg)
    new_caches = []
    for i in range(cfg.n_layers):
        x, c = _tblock_decode(layer(params["blocks"], i), x,
                              attn.KVCache(*(t[i] for t in cache.layers)),
                              cfg)
        new_caches.append(c)
    layers = _stack_caches(new_caches) if new_caches else cache.layers
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _head(params["head"], params["embed"], x, cfg)
    return logits, ServeCache(layers, None)


def fresh_cache(cfg: ModelConfig, batch: int, max_seq: int,
                device="cuda") -> ServeCache:
    """A cache as it would exist after prefilling ``max_seq`` tokens."""
    _require_family(cfg)
    one = attn.init_cache(cfg, batch, max_seq, device=device)
    layers = attn.KVCache(
        k=one.k[None].expand((cfg.n_layers,) + one.k.shape),
        v=one.v[None].expand((cfg.n_layers,) + one.v.shape),
        pos=torch.full((cfg.n_layers, batch), max_seq, dtype=torch.int32,
                       device=device))
    return ServeCache(layers, None)
