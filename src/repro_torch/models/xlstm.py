"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Follows arXiv:2405.04517 with stabilized exponential gating:
  mLSTM:  C_t = f_t C_{t-1} + i_t v_t k_t^T ;  n_t = f_t n_{t-1} + i_t k_t
          y_t = (C_t q_t) / max(|n_t . q_t|, 1)
  sLSTM:  scalar cell per unit with hidden-state recurrence feeding gates.

Both use the log-space stabilizer m_t = max(log f_t + m_{t-1}, log i_t),
computed in float32 as the reference computes it.  The mLSTM runs
chunk by chunk (a Python loop where the reference scans chunks); the
sLSTM is strictly sequential by construction (hidden recurrence) and
steps token by token — it is used sparsely (cfg.slstm_layers), as in
the paper's LM configs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import run_local, split_like
from repro_torch.models.common import dense_init, gelu_tanh, silu


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, P, P) matrix memory
    n: torch.Tensor  # (B, H, P) normalizer
    m: torch.Tensor  # (B, H) stabilizer


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, D) cell
    n: torch.Tensor  # (B, D)
    h: torch.Tensor  # (B, D) hidden (recurrent input)
    m: torch.Tensor  # (B, D) stabilizer


def _pdim(cfg: ModelConfig) -> int:
    return (2 * cfg.d_model) // cfg.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    di = 2 * d
    nh = cfg.n_heads
    dt = cfg.compute_dtype
    params = {
        "w_up": dense_init(gen, d, (d, 2 * di), dt),     # [x_in, z-gate]
        "w_qkv": dense_init(gen, di, (di, 3 * di), dt),
        "w_if": dense_init(gen, di, (di, 2 * nh), dt),   # exp gates/head
        "w_down": dense_init(gen, di, (di, d), dt),
    }
    axes = {"w_up": ("fsdp", "tp"), "w_qkv": ("tp", None),
            "w_if": ("tp", None), "w_down": ("tp", "fsdp")}
    return params, axes


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     device="cuda") -> MLSTMState:
    nh, p = cfg.n_heads, _pdim(cfg)
    return MLSTMState(
        c=torch.zeros((batch, nh, p, p), dtype=torch.float32, device=device),
        n=torch.zeros((batch, nh, p), dtype=torch.float32, device=device),
        m=torch.full((batch, nh), -1e30, dtype=torch.float32, device=device),
    )


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on a DTensor its formula, ``min(x, 0) -
    log1p(exp(-|x|))``: DTensor has no strategy for its backward, whose
    saved buffer is empty on a card and whole on the host."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return F.logsigmoid(x)
    return torch.clamp(x, max=0.0) - torch.log1p(torch.exp(-x.abs()))


def _mlstm_step(state: MLSTMState, q, k, v, i_raw, f_raw):
    """One time step; q/k/v: (B,H,P), gates: (B,H) raw logits."""
    logf = _log_sigmoid(f_raw.float())
    logi = i_raw.float()
    m_new = torch.maximum(logf + state.m, logi)
    f_ = torch.exp(logf + state.m - m_new)
    i_ = torch.exp(logi - m_new)
    qf, kf, vf = (t.float() for t in (q, k, v))
    p = qf.shape[-1]
    kf = kf / math.sqrt(p)
    c = f_[..., None, None] * state.c + i_[..., None, None] * (
        vf[..., :, None] * kf[..., None, :])
    n = f_[..., None] * state.n + i_[..., None] * kf
    num = torch.einsum("bhpq,bhq->bhp", c, qf)
    # Stabilized normalizer: with n normalized by exp(m), the |n.q| >= 1
    # floor of the raw recurrence becomes exp(-m) (official xLSTM form).
    den = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", n, qf)),
                        torch.exp(-m_new))
    y = num / den[..., None]
    return MLSTMState(c=c, n=n, m=m_new), y


def _pick_chunk(s: int, want: int) -> int:
    """Largest divisor of s that is <= want (chunked scans need s % c == 0)."""
    c = min(want, s)
    while s % c:
        c -= 1
    return c


def _mlstm_inputs(params, x: torch.Tensor, cfg: ModelConfig):
    """(q, k, v) (B,S,H,P), the raw gates (B,S,H) each, and the z gate."""
    b, s, d = x.shape
    nh, p = cfg.n_heads, _pdim(cfg)
    di = 2 * d
    up = x @ params["w_up"]
    xin, z = up[..., :di], up[..., di:]
    qkv = (xin @ params["w_qkv"]).reshape(b, s, 3, nh, p)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    gates = (xin @ params["w_if"]).reshape(b, s, 2, nh)
    return q, k, v, gates[:, :, 0], gates[:, :, 1], z


def mlstm_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[MLSTMState] = None, chunk: int = 128):
    """x: (B,S,D) -> (y, final_state).

    Chunked gated-linear-attention form of the mLSTM recurrence: within a
    chunk the quadratic (t,s) form, across chunks the normalized-state
    carry — algebraically identical to the per-step recurrence (including
    the log-space stabilizer).
    """
    b, s, d = x.shape
    nh, p = cfg.n_heads, _pdim(cfg)
    di = 2 * d
    q, k, v, i_raw, f_raw, z = _mlstm_inputs(params, x, cfg)
    st = state if state is not None else init_mlstm_state(cfg, b, x.device)

    c = _pick_chunk(s, chunk)
    nc = s // c
    qf = q.float().reshape(b, nc, c, nh, p)
    kf = (k.float() / math.sqrt(p)).reshape(b, nc, c, nh, p)
    vf = v.float().reshape(b, nc, c, nh, p)
    logi = i_raw.float().reshape(b, nc, c, nh)
    logf = _log_sigmoid(f_raw.float()).reshape(b, nc, c, nh)
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    neg_inf = torch.tensor(float("-inf"), device=x.device)

    c_n, n_n, m_in = st.c, st.n, st.m        # (b,h,p,p),(b,h,p),(b,h)
    ys = []
    for i in range(nc):
        qc, kc, vc = qf[:, i], kf[:, i], vf[:, i]   # (b,c,h,p)
        lic, lfc = logi[:, i], logf[:, i]           # (b,c,h)
        bcum = torch.cumsum(lfc, dim=1)             # inclusive cumulative logf
        # D[t,s] = b_t - b_s + logi_s for s <= t
        D = bcum[:, :, None, :] - bcum[:, None, :, :] + lic[:, None, :, :]
        D = torch.where(tril[None, :, :, None], D, neg_inf)
        m_intra = D.amax(dim=2)                     # (b,c,h)
        m_tot = torch.maximum(bcum + m_in[:, None, :], m_intra)
        alpha = torch.exp(bcum + m_in[:, None, :] - m_tot)
        W = torch.exp(D - m_tot[:, :, None, :])     # (b,t,s,h)
        G = torch.einsum("bthk,bshk->btsh", qc, kc)
        y_inter = alpha[..., None] * torch.einsum("bhvk,bthk->bthv", c_n, qc)
        y_num = y_inter + torch.einsum("btsh,bshv->bthv", W * G, vc)
        n_t = (alpha[..., None] * n_n[:, None]
               + torch.einsum("btsh,bshk->bthk", W, kc))
        dot = torch.einsum("bthk,bthk->bth", n_t, qc)
        denom = torch.maximum(torch.abs(dot), torch.exp(-m_tot))
        ys.append(y_num / denom[..., None])         # (b,c,h,p)
        # carry update
        total = bcum[:, -1]                         # (b,h)
        w_end = total[:, None, :] - bcum + lic      # (b,s,h)
        m_out = torch.maximum(total + m_in, w_end.amax(dim=1))
        decay = torch.exp(total + m_in - m_out)
        wexp = torch.exp(w_end - m_out[:, None, :])
        c_n = (decay[..., None, None] * c_n
               + torch.einsum("bsh,bshv,bshk->bhvk", wexp, vc, kc))
        n_n = decay[..., None] * n_n + torch.einsum("bsh,bshk->bhk", wexp, kc)
        m_in = m_out
    y = torch.stack(ys, dim=1).to(x.dtype).reshape(b, s, di)
    y = y * silu(z)
    return y @ params["w_down"], MLSTMState(c=c_n, n=n_n, m=m_in)


def mlstm_forward_reference(params, x: torch.Tensor, cfg: ModelConfig,
                            state: Optional[MLSTMState] = None):
    """Per-step oracle for the chunked path (tests)."""
    b, s, d = x.shape
    di = 2 * d
    q, k, v, i_raw, f_raw, z = _mlstm_inputs(params, x, cfg)
    st = state if state is not None else init_mlstm_state(cfg, b, x.device)
    ys = []
    for t in range(s):
        st, y = _mlstm_step(st, q[:, t], k[:, t], v[:, t], i_raw[:, t],
                            f_raw[:, t])
        ys.append(y)
    y = torch.stack(ys, dim=1).to(x.dtype).reshape(b, s, di)
    y = y * silu(z)
    return y @ params["w_down"], st


def mlstm_decode(params, x: torch.Tensor, cfg: ModelConfig,
                 state: MLSTMState):
    b = x.shape[0]
    nh, p = cfg.n_heads, _pdim(cfg)
    di = 2 * x.shape[-1]
    up = x[:, 0] @ params["w_up"]
    xin, z = up[..., :di], up[..., di:]
    qkv = (xin @ params["w_qkv"]).reshape(b, 3, nh, p)
    gates = (xin @ params["w_if"]).reshape(b, 2, nh)
    st, y = _mlstm_step(state, qkv[:, 0], qkv[:, 1], qkv[:, 2],
                        gates[:, 0], gates[:, 1])
    y = y.to(x.dtype).reshape(b, di) * silu(z)
    return (y @ params["w_down"])[:, None], st


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    dt = cfg.compute_dtype
    f = max(cfg.d_ff, (8 * d) // 3)
    params = {
        "w_x": dense_init(gen, d, (d, 4 * d), dt),   # i,f,z,o from input
        "r_h": dense_init(gen, d, (d, 4 * d), dt),   # recurrent
        "w_ff1": dense_init(gen, d, (d, f), dt),
        "w_ff2": dense_init(gen, f, (f, d), dt),
    }
    axes = {"w_x": ("fsdp", "tp"), "r_h": ("fsdp", "tp"),
            "w_ff1": ("fsdp", "tp"), "w_ff2": ("tp", "fsdp")}
    return params, axes


def init_slstm_state(cfg: ModelConfig, batch: int,
                     device="cuda") -> SLSTMState:
    d = cfg.d_model
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z, h=z,
                      m=torch.full((batch, d), -1e30, dtype=torch.float32,
                                   device=device))


def _slstm_step(params, state: SLSTMState, xt: torch.Tensor) -> SLSTMState:
    """xt: (B, D)."""
    pre = (xt @ params["w_x"]).float() \
        + (state.h.to(xt.dtype) @ params["r_h"]).float()
    i_raw, f_raw, z_raw, o_raw = torch.chunk(pre, 4, dim=-1)
    logf = _log_sigmoid(f_raw)
    m_new = torch.maximum(logf + state.m, i_raw)
    i_ = torch.exp(i_raw - m_new)
    f_ = torch.exp(logf + state.m - m_new)
    c = f_ * state.c + i_ * torch.tanh(z_raw)
    n = f_ * state.n + i_
    # ``maximum`` as the reference's ``jnp.maximum``: where n is exactly 1
    # (the first step) both split the gradient in two; ``clamp`` does not
    h = torch.sigmoid(o_raw) * c / torch.maximum(n, n.new_ones(()))
    return SLSTMState(c=c, n=n, h=h, m=m_new)


def _slstm_ff(params, y: torch.Tensor) -> torch.Tensor:
    return gelu_tanh(y @ params["w_ff1"]) @ params["w_ff2"]


def slstm_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[SLSTMState] = None):
    """Strictly-sequential sLSTM over the whole sequence, token by token
    (the reference nests its steps in chunks only to bound the backward
    pass's memory; the recurrence is the same)."""
    b, s, d = x.shape
    st = state if state is not None else init_slstm_state(cfg, b, x.device)
    y, st = _slstm_scan_sharded(params["w_x"], params["r_h"], x, st)
    return _slstm_ff(params, y), st


def _slstm_scan(w_x, r_h, x: torch.Tensor, st: SLSTMState):
    """The sLSTM's time steps over ``x`` from state ``st``: the hidden
    states ``(B, S, D)`` in ``x``'s dtype, and the last state."""
    hs = []
    for t in range(x.shape[1]):
        st = _slstm_step({"w_x": w_x, "r_h": r_h}, st, x[:, t])
        hs.append(st.h)
    return torch.stack(hs, dim=1).to(x.dtype), st


def _slstm_scan_sharded(w_x, r_h, x: torch.Tensor, st: SLSTMState):
    """:func:`_slstm_scan`; on a DTensor ``x``, over each rank's own rows
    (``run_local``), the two weights whole: the recurrence moves nothing
    between ranks once they are gathered."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return _slstm_scan(w_x, r_h, x, st)
    x = split_like(x, x, (0,))
    st = SLSTMState(*(split_like(t, x, (0,)) for t in st))
    y, *last = run_local(
        lambda w, r, xs, *s: _flat_scan(w, r, xs, SLSTMState(*s)),
        (x,) * 5, split_like(w_x, x, ()), split_like(r_h, x, ()), x, *st)
    return y, SLSTMState(*last)


def _flat_scan(w_x, r_h, x, st: SLSTMState):
    y, last = _slstm_scan(w_x, r_h, x, st)
    return (y, *last)


def slstm_decode(params, x: torch.Tensor, cfg: ModelConfig,
                 state: SLSTMState):
    st = _slstm_step(params, state, x[:, 0])
    y = st.h.to(x.dtype)[:, None]
    return _slstm_ff(params, y), st
