"""Causal attention: MHA / GQA / MQA, sliding window, RoPE, KV cache.

Three execution paths, numerically cross-checked in tests:

* dense path (train / short prefill): one einsum chain;
* **streaming path** (long prefill, above ``streaming_threshold``
  tokens): nested q-chunk x kv-chunk loops with a running-max softmax
  (the flash-attention recurrence in plain torch), bounding activation
  memory at O(q_chunk x kv_chunk) a step;
* decode path: single-token query against the cache (+ rolling window
  cache for SWA archs).

Casts follow the reference's: RoPE tables in float32, then cast; scores
and softmax in float32, the probabilities cast back to the activations'
dtype before the value product.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (axis_extent, constraint,
                                       gather_unless_divides,
                                       grad_in_layout, run_local,
                                       split_like)
from repro_torch.models.common import dense_init

NEG_INF = -2.0e38

#: Forces the dense (non-streaming) attention path at any length (the
#: reference's roofline cost-mode hook; the card's smoke check holds the
#: streaming path against it).
FORCE_DENSE = False


# ---------------------------------------------------------------------------
# RoPE (standard / partial "2d")
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, rot_dim: int, theta: float):
    """positions: (..., S) int -> cos/sin tables (..., S, rot_dim/2)."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=positions.device) / rot_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot_dim: int) -> torch.Tensor:
    """x: (B, S, H, D); rotates the first rot_dim dims (GLM partial RoPE
    keeps the tail un-rotated when rotary_pct < 1)."""
    rot, rest = x[..., :rot_dim], x[..., rot_dim:]
    r1, r2 = rot[..., 0::2], rot[..., 1::2]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    o1 = r1 * c - r2 * s
    o2 = r2 * c + r1 * s
    rot_out = torch.stack([o1, o2], dim=-1).reshape(rot.shape).to(x.dtype)
    return torch.cat([rot_out, rest], dim=-1) if rest.shape[-1] else rot_out


def _rot_dim(cfg: ModelConfig) -> int:
    return int(cfg.rotary_pct * cfg.hd) // 2 * 2


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig):
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.compute_dtype
    params = {
        "wq": dense_init(gen, d, (d, h * hd), dt),
        "wk": dense_init(gen, d, (d, kvh * hd), dt),
        "wv": dense_init(gen, d, (d, kvh * hd), dt),
        "wo": dense_init(gen, h * hd, (h * hd, d), dt),
    }
    axes = {
        "wq": ("fsdp", "tp"),
        "wk": ("fsdp", "tp"),
        "wv": ("fsdp", "tp"),
        "wo": ("tp", "fsdp"),
    }
    return params, axes


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: int) -> torch.Tensor:
    """(..., Sq, Sk) float32 additive bias: causal (+ sliding window)."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if window:
        ok &= k_pos[..., None, :] > q_pos[..., :, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


# ---------------------------------------------------------------------------
# dense path
# ---------------------------------------------------------------------------


def _repeat_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """(B,S,KVH,D) -> (B,S,H,D): each KV head repeated for its group."""
    kvh = k.shape[2]
    if kvh == h:
        return k
    return torch.repeat_interleave(k, h // kvh, dim=2)


def _attn_shard_mode(h: int) -> str:
    """"heads" TP when the head count divides the TP extent, else
    sequence-parallel attention."""
    tp = axis_extent("tp")
    return "heads" if h % max(tp, 1) == 0 else "seq"


def _softcap(scores: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        scores = torch.tanh(scores / c) * c
    return scores


def _attend_dense(q, k, v, q_pos, k_pos, cfg: ModelConfig):
    """q: (B,Sq,H,D)  k/v: (B,Sk,KVH,D) -> (B,Sq,H,D)."""
    b, sq, h, hd = q.shape
    mode = _attn_shard_mode(h)
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    if mode == "heads":
        k = constraint(k, ("batch", None, "tp", None))
        v = constraint(v, ("batch", None, "tp", None))
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).float()
    scores = scores * (1.0 / math.sqrt(hd))
    scores = _softcap(scores, cfg)
    bias = _mask_bias(q_pos, k_pos, cfg.sliding_window)
    scores = scores + bias[:, None]
    if mode == "heads":
        scores = constraint(scores, ("batch", "tp", None, None))
    else:
        scores = constraint(scores, ("batch", None, "sp", None))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v)
    if mode == "heads":
        return constraint(out, ("batch", None, "tp", None))
    return constraint(out, ("batch", "sp", None, None))


# ---------------------------------------------------------------------------
# streaming (flash-style) path for long sequences
# ---------------------------------------------------------------------------


def _div_chunk(want: int, s: int) -> int:
    """The largest chunk <= ``want`` that divides ``s``."""
    c = min(want, s)
    while s % c:
        c -= 1
    return c


def _attend_streaming(q, k, v, q_pos, k_pos, cfg: ModelConfig,
                      q_chunk: int = 1024, kv_chunk: int = 1024):
    """Flash-style nested-chunk attention on flat heads: for each query
    chunk, a running max, denominator and float32 accumulator over every
    key chunk, as the reference's nested ``lax.scan`` computes them.  The
    keys may be longer than the queries (one rank's rows of a split
    sequence against the whole of it)."""
    b, s, h, hd = q.shape
    sk = k.shape[1]
    mode = _attn_shard_mode(h)
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    if mode == "heads":
        k = constraint(k, ("batch", None, "tp", None))
        v = constraint(v, ("batch", None, "tp", None))
    q_chunk = _div_chunk(q_chunk, s)
    kv_chunk = _div_chunk(kv_chunk, sk)
    scale = 1.0 / math.sqrt(hd)

    outs = []
    for q0 in range(0, s, q_chunk):
        qc = q[:, q0:q0 + q_chunk]
        qpc = q_pos[:, q0:q0 + q_chunk]
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, h, q_chunk, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, sk, kv_chunk):
            kc = k[:, k0:k0 + kv_chunk]
            vc = v[:, k0:k0 + kv_chunk]
            kpc = k_pos[:, k0:k0 + kv_chunk]
            s_ = torch.einsum("bqhd,bshd->bhqs", qc, kc).float()
            s_ = s_ * scale + _mask_bias(qpc, kpc, cfg.sliding_window)[:, None]
            m_new = torch.maximum(m, s_.amax(dim=-1))
            p = torch.exp(s_ - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqs,bshd->bhqd", p.to(qc.dtype), vc).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        # (b, h, qc, hd) -> (b, qc, h, hd)
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Per-layer cache.  For SWA archs the buffer is a rolling window."""

    k: torch.Tensor    # (B, S_buf, KVH, HD)
    v: torch.Tensor
    pos: torch.Tensor  # (B,) int32 next absolute position


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> KVCache:
    buf = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    kvh, hd = cfg.n_kv_heads, cfg.hd
    dt = cfg.compute_dtype
    return KVCache(
        k=torch.zeros((batch, buf, kvh, hd), dtype=dt, device=device),
        v=torch.zeros((batch, buf, kvh, hd), dtype=dt, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def cache_axes() -> KVCache:
    return KVCache(k=("batch", None, None, "tp"),
                   v=("batch", None, None, "tp"),
                   pos=("batch",))


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _qkv(params, x: torch.Tensor, cfg: ModelConfig, positions):
    """Projected (q, k, v), RoPE applied at ``positions``."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = gather_unless_divides(x @ params["wq"], -1, h).reshape(b, s, h, hd)
    k = gather_unless_divides(x @ params["wk"], -1, kvh).reshape(b, s, kvh,
                                                                 hd)
    v = gather_unless_divides(x @ params["wv"], -1, kvh).reshape(b, s, kvh,
                                                                 hd)
    rot = _rot_dim(cfg)
    if rot:
        cos, sin = rope_tables(positions, rot, cfg.rope_theta)
        q = apply_rope(q, cos, sin, rot)
        k = apply_rope(k, cos, sin, rot)
    return q, k, v


def attention_forward(params, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig,
                      streaming_threshold: int = 8192) -> torch.Tensor:
    """Training/prefill attention over a full sequence."""
    q, k, v = _qkv(params, x, cfg, positions)
    return _attend(params, q, k, v, positions, cfg, streaming_threshold)


def _attend_sharded(core, q, k, v, positions, cfg: ModelConfig):
    """``core(q, k, v, q_pos, k_pos, cfg)``; on a DTensor ``q``, over
    each rank's own rows and heads (:func:`run_local`): the keys and
    values repeated to every query head and laid out as ``q``'s batch
    and heads with their whole sequence, the positions as ``q``'s batch
    and sequence.  The attention itself moves nothing between ranks, as
    under the reference's heads / sequence-parallel rules; DTensor has
    no strategy that keeps a split head dim through its products."""
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor):
        return core(q, k, v, positions, positions, cfg)
    h = q.shape[2]
    k = split_like(_repeat_kv(k, h), q, (0, None, 2))
    v = split_like(_repeat_kv(v, h), q, (0, None, 2))
    return run_local(lambda *a: core(*a, cfg), q, q, k, v,
                     split_like(positions, q, (0, 1)),
                     split_like(positions, q, (0,)))


def _attend(params, q, k, v, positions, cfg: ModelConfig,
            streaming_threshold: int = 8192) -> torch.Tensor:
    b, s, h, hd = q.shape
    if _attn_shard_mode(h) == "heads":
        q = constraint(q, ("batch", None, "tp", None))
    else:
        q = constraint(q, ("batch", "sp", None, None))
    core = (_attend_streaming if s > streaming_threshold and not FORCE_DENSE
            else _attend_dense)
    out = _attend_sharded(core, q, k, v, positions, cfg)
    return grad_in_layout(out.reshape(b, s, h * hd)) @ params["wo"]


def _write_slot(buf: torch.Tensor, slot: torch.Tensor,
                new: torch.Tensor) -> torch.Tensor:
    """A copy of ``buf`` (B, S, ...) with row ``b``'s slot ``slot[b]``
    set to ``new[b]``.  A DTensor has no ``index_put`` along a split
    batch dim: it selects by a one-hot of the slot, the same values."""
    from torch.distributed.tensor import DTensor

    if isinstance(buf, DTensor):
        hit = (torch.arange(buf.shape[1], device=slot.device)[None, :]
               == slot[:, None])
        hit = hit.reshape(hit.shape + (1,) * (buf.dim() - 2))
        return torch.where(hit, new[:, None], buf)
    out = buf.clone()
    out[torch.arange(buf.shape[0], device=buf.device), slot] = new
    return out


def attention_decode(params, x: torch.Tensor, cache: KVCache,
                     cfg: ModelConfig):
    """Single-token decode step; x: (B, 1, D).  Returns (out, new_cache);
    ``cache`` itself is left as it was."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.hd
    pos = cache.pos  # (B,)
    q, k, v = _qkv(params, x, cfg, pos[:, None])
    q = constraint(q, ("kv_batch", None, None, None))
    k = constraint(k, ("kv_batch", None, None, None))
    v = constraint(v, ("kv_batch", None, None, None))
    buf = cache.k.shape[1]
    pos64 = pos.long()
    if cfg.sliding_window:
        slot = pos64 % buf
    else:
        slot = torch.clamp(pos64, max=buf - 1)
    k_buf = _write_slot(cache.k, slot, k[:, 0])
    v_buf = _write_slot(cache.v, slot, v[:, 0])
    # absolute positions held in each cache slot (rolling for SWA)
    slots = torch.arange(buf, device=x.device)[None, :]
    cur = pos64[:, None]
    if cfg.sliding_window:
        # slot s holds position: the latest p <= pos with p % buf == s
        k_pos = cur - ((cur - slots) % buf)
    else:
        k_pos = slots.expand(b, buf)
    valid = k_pos <= cur
    # invalid/empty slots get a +huge sentinel so the causal mask
    # (k_pos <= q_pos) rejects them (a negative sentinel would pass it
    # and leak softmax mass onto zeroed cache slots)
    k_pos = torch.where(valid, k_pos, 1_000_000_000)
    kr = _repeat_kv(k_buf, h)
    vr = _repeat_kv(v_buf, h)
    scores = torch.einsum("bqhd,bshd->bhqs", q, kr).float()
    scores = scores * (1.0 / math.sqrt(hd))
    scores = _softcap(scores, cfg)
    bias = _mask_bias(cur, k_pos, cfg.sliding_window)
    scores = scores + bias[:, None]
    scores = constraint(scores, ("kv_batch", None, None, None))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", probs, vr).reshape(b, 1, h * hd)
    out = constraint(out, ("kv_batch", None, None))
    new_cache = KVCache(k=k_buf, v=v_buf, pos=pos + 1)
    return out @ params["wo"], new_cache


def _fill_cache(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``buf`` (zeros) with its first slots set to ``new``.  A DTensor
    ``new`` cannot be written into a plain buffer: the cache is ``new``
    followed by the zero slots instead, the same values."""
    from torch.distributed.tensor import DTensor

    take = new.shape[1]
    if isinstance(new, DTensor):
        if take == buf.shape[1]:
            return new
        return torch.cat([new, buf[:, take:].to(new.dtype)], dim=1)
    buf[:, :take] = new
    return buf


def prefill_cache(params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, max_seq: int):
    """Full-sequence prefill that also materializes the cache."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    out = _attend(params, q, k, v, positions, cfg)
    cache = init_cache(cfg, b, max_seq, device=x.device)
    buf = cache.k.shape[1]
    take = min(s, buf)
    # Rolling-window alignment: position p lives in slot p % buf, so the
    # trailing window is written then rolled by (s - take) % buf (zero for
    # the full-cache case where slot == position).
    shift = (s - take) % buf
    k_buf = _fill_cache(cache.k, k[:, s - take:])
    v_buf = _fill_cache(cache.v, v[:, s - take:])
    if shift:
        k_buf = torch.roll(k_buf, shift, dims=1)
        v_buf = torch.roll(v_buf, shift, dims=1)
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return out, KVCache(k=k_buf, v=v_buf, pos=pos)
