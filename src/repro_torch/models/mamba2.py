"""Mamba2 (SSD) mixer: chunked selective-state-space recurrence.

Implements the Mamba-2 scalar-decay-per-head SSM (arXiv:2405.21060) with the
chunked SSD algorithm: within a chunk the quadratic (attention-like) form,
across chunks the state recurrence — so activation memory is
O(chunk^2 + d_state) instead of O(S * d_state).  Where the reference
scans the chunks with ``lax.scan``, a Python loop runs over them.
Decode is a single O(1) state update.

State per head: h in R^{head_dim x d_state};  per step t:
    h_t = a_t * h_{t-1} + dt_t * x_t (x) B_t      (a_t = exp(-dt_t * A))
    y_t = h_t @ C_t + D * x_t,   gated by silu(z_t)

The casts are the reference's: the decays, B, C and the state in
float32, ``exp`` of the pairwise decay taken before the causal mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import run_local, split_like
from repro_torch.models.common import dense_init, silu


class MambaState(NamedTuple):
    h: torch.Tensor        # (B, H, P, N) SSM state
    conv: torch.Tensor     # (B, K-1, D_inner + 2N) conv tail


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = cfg.n_heads
    p = d_inner // n_heads
    return d_inner, n_heads, p, cfg.ssm_state


def init_mamba2(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    d_inner, nh, p, n = _dims(cfg)
    dt = cfg.compute_dtype
    conv_ch = d_inner + 2 * n
    dev = gen.device
    params = {
        # projects to [z (d_inner), x (d_inner), B (n), C (n), dt (nh)]
        "w_in": dense_init(gen, d, (d, 2 * d_inner + 2 * n + nh), dt),
        "conv_w": dense_init(gen, cfg.ssm_conv, (cfg.ssm_conv, conv_ch), dt),
        "a_log": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, d_inner, (d_inner, d), dt),
    }
    axes = {
        "w_in": ("fsdp", "tp"),
        "conv_w": (None, "tp"),
        "a_log": (None,),
        "dt_bias": (None,),
        "d_skip": (None,),
        "w_out": ("tp", "fsdp"),
    }
    return params, axes


def _split_proj(proj, cfg: ModelConfig):
    d_inner, nh, p, n = _dims(cfg)
    z = proj[..., :d_inner]
    x = proj[..., d_inner:2 * d_inner]
    b = proj[..., 2 * d_inner:2 * d_inner + n]
    c = proj[..., 2 * d_inner + n:2 * d_inner + 2 * n]
    dt_raw = proj[..., 2 * d_inner + 2 * n:]
    return z, x, b, c, dt_raw


def _causal_conv(xbc, conv_w, tail=None):
    """Depthwise causal conv over (B, S, CH); tail = (B, K-1, CH) history."""
    k = conv_w.shape[0]
    if tail is None:
        tail = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[-1]))
    padded = torch.cat([tail, xbc], dim=1)
    s = xbc.shape[1]
    out = padded[:, 0:s] * conv_w[0]
    for i in range(1, k):
        out = out + padded[:, i:i + s] * conv_w[i]
    new_tail = padded[:, -(k - 1):] if k > 1 else tail
    return silu(out), new_tail


def _check_chunks(s: int, cfg: ModelConfig) -> None:
    if s % cfg.ssm_chunk:
        raise ValueError(
            f"{cfg.name}: mamba2_forward takes a multiple of ssm_chunk="
            f"{cfg.ssm_chunk} tokens, got {s} (the reference does not pad "
            f"either: pad the prompt, or serve prompts of such lengths)")


def mamba2_forward(params, x: torch.Tensor, cfg: ModelConfig,
                   state: Optional[MambaState] = None):
    """Full-sequence forward; returns (y, final_state).

    x: (B, S, D).  S must be a multiple of cfg.ssm_chunk (callers pad);
    another length raises ``ValueError``.
    """
    bsz, s, _ = x.shape
    _check_chunks(s, cfg)
    d_inner, nh, p, n = _dims(cfg)
    ch = cfg.ssm_chunk

    proj = x @ params["w_in"]
    z, xin, b, c, dt_raw = _split_proj(proj, cfg)
    xbc, new_tail = _causal_conv(
        torch.cat([xin, b, c], dim=-1), params["conv_w"],
        None if state is None else state.conv)
    xin, b, c = (xbc[..., :d_inner], xbc[..., d_inner:d_inner + n],
                 xbc[..., d_inner + n:])
    dt = F.softplus(dt_raw.float() + params["dt_bias"])   # (B,S,H)
    a = -torch.exp(params["a_log"])                        # (H,)
    loga = dt * a                                          # (B,S,H)
    xh = xin.reshape(bsz, s, nh, p)

    h = (torch.zeros((bsz, nh, p, n), dtype=torch.float32, device=x.device)
         if state is None else state.h)
    y, h = _ssd_sharded(loga, dt, xh, b, c, h, ch)
    y = y + params["d_skip"][None, None, :, None] * xh.float()
    y = y.to(x.dtype).reshape(bsz, s, d_inner)
    y = y * silu(z)
    out = y @ params["w_out"]
    return out, MambaState(h=h, conv=new_tail)


def _ssd_sharded(loga, dt, xh, b, c, h, ch: int):
    """:func:`_ssd`; on a DTensor ``xh``, over each rank's own rows and
    heads (``run_local``), the sequence whole: the chunk recurrence
    moves nothing between ranks."""
    from torch.distributed.tensor import DTensor

    if not isinstance(xh, DTensor):
        return _ssd(loga, dt, xh, b, c, h, ch)
    heads = (0, None, 2)
    ins = (split_like(loga, xh, heads), split_like(dt, xh, heads),
           split_like(xh, xh, heads), split_like(b, xh, (0,)),
           split_like(c, xh, (0,)), split_like(h, xh, (0, 2)))
    return run_local(lambda *a: _ssd(*a, ch), (ins[2], ins[5]), *ins)


def _ssd(loga, dt, xh, b, c, h, ch: int):
    """The chunked SSD over ``(B, S, H, ...)`` inputs from state ``h``:
    ``(y (B, S, H, P) float32, final h)``."""
    bsz, s, nh, p = xh.shape
    n = b.shape[-1]
    nchunks = s // ch
    loga_c = loga.reshape(bsz, nchunks, ch, nh)
    dt_c = dt.reshape(bsz, nchunks, ch, nh)
    x_c = xh.reshape(bsz, nchunks, ch, nh, p)
    b_c = b.reshape(bsz, nchunks, ch, n).float()
    c_c = c.reshape(bsz, nchunks, ch, n).float()
    mask = torch.tril(torch.ones((ch, ch), dtype=torch.bool,
                                 device=xh.device))
    y_chunks = []
    for i in range(nchunks):
        la, dtk, xk = loga_c[:, i], dt_c[:, i], x_c[:, i]
        bk, ck = b_c[:, i], c_c[:, i]
        cum = torch.cumsum(la, dim=1)                      # (B,ch,H)
        # inter-chunk: y_t += (prod decay to t) * C_t . h0
        y_inter = torch.einsum("btn,bhpn->bthp", ck, h)
        y_inter = y_inter * torch.exp(cum)[..., None]
        # intra-chunk quadratic form
        # L[t,s] = exp(cum_t - cum_s) for s <= t  (per head)
        rel = cum[:, :, None, :] - cum[:, None, :, :]      # (B,t,s,H)
        # Masked before the exp (the reference masks after it): above
        # the diagonal rel grows with the chunk's decay, and once its
        # exp overflows, the backward pass's 0 * inf is NaN.  Equal
        # values; finite gradients.
        L = torch.exp(torch.where(mask[None, :, :, None], rel,
                                  torch.tensor(float("-inf"),
                                               device=xh.device)))
        g = torch.einsum("btn,bsn->bts", ck, bk)           # (B,t,s)
        dx = xk.float() * dtk[..., None]                   # (B,s,H,P)
        y_intra = torch.einsum("bts,btsh,bshp->bthp", g, L, dx)
        # state update: h' = exp(sum la) h + sum_s exp(cum_end - cum_s) dx_s B_s
        tot = cum[:, -1]                                   # (B,H)
        w = torch.exp(tot[:, None] - cum)                  # (B,s,H)
        h = torch.exp(tot)[..., None, None] * h + torch.einsum(
            "bshp,bsn,bsh->bhpn", dx, bk, w)
        y_chunks.append(y_inter + y_intra)
    return torch.stack(y_chunks, dim=1).reshape(bsz, s, nh, p), h


def mamba2_decode(params, x: torch.Tensor, cfg: ModelConfig,
                  state: MambaState):
    """Single-token step; x: (B, 1, D)."""
    bsz = x.shape[0]
    d_inner, nh, p, n = _dims(cfg)
    proj = x @ params["w_in"]
    z, xin, b, c, dt_raw = _split_proj(proj, cfg)
    xbc, new_tail = _causal_conv(
        torch.cat([xin, b, c], dim=-1), params["conv_w"], state.conv)
    xin, b, c = (xbc[..., :d_inner], xbc[..., d_inner:d_inner + n],
                 xbc[..., d_inner + n:])
    dt = F.softplus(dt_raw.float() + params["dt_bias"])[:, 0]
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt * a)                              # (B,H)
    xh = xin.reshape(bsz, nh, p).float()
    bf = b[:, 0].float()
    cf = c[:, 0].float()
    h = decay[..., None, None] * state.h + torch.einsum(
        "bhp,bn,bh->bhpn", xh, bf, dt)
    y = torch.einsum("bhpn,bn->bhp", h, cf)
    y = y + params["d_skip"][None, :, None] * xh
    y = y.to(x.dtype).reshape(bsz, 1, d_inner)
    y = y * silu(z)
    return y @ params["w_out"], MambaState(h=h, conv=new_tail)


def init_mamba_state(cfg: ModelConfig, batch: int,
                     device="cuda") -> MambaState:
    d_inner, nh, p, n = _dims(cfg)
    return MambaState(
        h=torch.zeros((batch, nh, p, n), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * n),
                         dtype=cfg.compute_dtype, device=device),
    )


def mamba2_reference(params, x: torch.Tensor, cfg: ModelConfig):
    """Naive per-step recurrence — the oracle for the chunked path."""
    bsz, s, _ = x.shape
    state = init_mamba_state(cfg, bsz, device=x.device)
    ys = []
    for t in range(s):
        y, state = mamba2_decode(params, x[:, t:t + 1], cfg, state)
        ys.append(y)
    return torch.cat(ys, dim=1)
