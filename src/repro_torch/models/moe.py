"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Dispatch layout: tokens are grouped by their data shard — the buffer is
``(G, E, C, D)`` with ``G`` the DP extent of the current mesh (1 off a
mesh), as the reference lays it out for its sharded expert einsum.

**Gather-only dataflow.**  Because the kept (token, slot) -> (expert,
cap) mapping is a bijection, every backward scatter can be rewritten as
the opposite-direction gather; :class:`_Dispatch` / :class:`_Combine`
are ``torch.autograd.Function``s whose ``backward`` is the reference's
gather-only VJP, so the whole layer (forward and backward) is batched
gathers and einsums only.

Routing (:func:`route`) takes the top-k experts of the float32 router
logits; each expert keeps its first ``capacity`` tokens in token order
(FCFS, by a top-k over ``tg - t`` priority scores, which are distinct
for every member, so only the masked ``-inf`` slots of a short queue
tie).  Tokens overflowing an expert's capacity are dropped (standard;
the aux loss drives balance).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import _current_mesh, constraint
from repro_torch.models.common import dense_init


def init_moe(gen: torch.Generator, cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.compute_dtype
    ep = "expert" if cfg.moe_shard_experts else None
    tp_in = None if cfg.moe_shard_experts else "tp"
    params = {
        "router": dense_init(gen, d, (d, e), torch.float32),
        "w_gate": dense_init(gen, d, (e, d, f), dt),
        "w_up": dense_init(gen, d, (e, d, f), dt),
        "w_down": dense_init(gen, f, (e, f, d), dt),
    }
    axes = {
        "router": ("fsdp", None),
        "w_gate": (ep, "fsdp", tp_in),
        "w_up": (ep, "fsdp", tp_in),
        "w_down": (ep, tp_in, "fsdp"),
    }
    return params, axes


def _dp_groups(t: int) -> int:
    mesh = _current_mesh()
    if mesh is None:
        return 1
    g = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            g *= mesh.shape[a]
    return g if t % g == 0 else 1


# ---------------------------------------------------------------------------
# gather-only dispatch / combine
# ---------------------------------------------------------------------------


def _flat_gather(src: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """src: (G, N, D); flat_idx: (G, M) -> (G, M, D): one gather along
    one axis, with no broadcast of the operand over extra index dims."""
    return torch.gather(src, 1, flat_idx.long()[..., None].expand(
        -1, -1, src.shape[-1]))


def _masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class _Dispatch(torch.autograd.Function):
    """buf[g,e,c,:] = xt[g, idx[g,e,c], :]  (invalid slots zeroed)."""

    @staticmethod
    def forward(ctx, xt, idx, slot_valid, ej, pos, keep):
        g, e, c = idx.shape
        buf = _flat_gather(xt, idx.reshape(g, e * c)).reshape(g, e, c, -1)
        ctx.save_for_backward(ej, pos, keep)
        ctx.cap = c
        return _masked(buf, slot_valid)

    @staticmethod
    def backward(ctx, dbuf):
        ej, pos, keep = ctx.saved_tensors  # each (k, G, Tg)
        g_, e_, c_, d_ = dbuf.shape
        flat = dbuf.reshape(g_, e_ * c_, d_)
        dxt = None
        for j in range(ej.shape[0]):
            # gather the slot gradient back to its (unique) source token
            grad = _masked(_flat_gather(flat, ej[j] * c_ + pos[j]), keep[j])
            dxt = grad if dxt is None else dxt + grad
        return dxt, None, None, None, None, None


class _Combine(torch.autograd.Function):
    """out[g,t,:] = sum_j weights[g,t,j] * y[g, ej[j], pos[j], :]."""

    @staticmethod
    def forward(ctx, y, weights, idx, slot_valid, wsel, ej, pos, keep):
        g_, e_, c_, d_ = y.shape
        flat = y.reshape(g_, e_ * c_, d_)
        out = None
        for j in range(ej.shape[0]):
            gath = _masked(_flat_gather(flat, ej[j] * c_ + pos[j]), keep[j])
            term = gath * weights[..., j][..., None]
            out = term if out is None else out + term
        ctx.save_for_backward(y, weights, idx, slot_valid, wsel, ej, pos,
                              keep)
        return out

    @staticmethod
    def backward(ctx, dout):
        y, weights, idx, slot_valid, wsel, ej, pos, keep = ctx.saved_tensors
        g_, e_, c_, d_ = y.shape
        # dy[g,e,c,:] = wsel[g,e,c] * dout[g, idx[g,e,c], :]   (gather,
        # not scatter: each kept slot has exactly one source token)
        dsrc = _flat_gather(dout, idx.reshape(g_, e_ * c_)).reshape(
            g_, e_, c_, d_)
        dy = _masked(dsrc * wsel[..., None], slot_valid).to(y.dtype)
        # dweights[g,t,j] = <dout[g,t], y[g, ej, pos]>
        flat = y.reshape(g_, e_ * c_, d_)
        dws = []
        for j in range(ej.shape[0]):
            gath = _masked(_flat_gather(flat, ej[j] * c_ + pos[j]), keep[j])
            dws.append(torch.sum(dout * gath, dim=-1))
        dweights = torch.stack(dws, dim=-1).to(weights.dtype)
        return dy, dweights, None, None, None, None, None, None


def _dispatch(xt, idx, slot_valid, ej, pos, keep):
    return _Dispatch.apply(xt, idx, slot_valid, ej, pos, keep)


def _combine(y, weights, idx, slot_valid, wsel, ej, pos, keep):
    return _Combine.apply(y, weights, idx, slot_valid, wsel, ej, pos, keep)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def route(params, xt: torch.Tensor, cfg: ModelConfig):
    """Float32 router logits of the grouped tokens ``xt`` (G, Tg, D) and
    their top-k ``(values, expert indices)``, each (G, Tg, k)."""
    logits = torch.einsum("gtd,de->gte", xt.float(), params["router"])
    topv, topi = torch.topk(logits, cfg.top_k, dim=-1)
    return logits, topv, topi


def _slots(topi: torch.Tensor, e: int, capacity: int, ep=None):
    """FCFS expert queues via top-k on priority score (gathers only).

    From the (G, Tg, k) expert choices: ``idx`` (G, E, C), the token in
    each capacity slot, and ``slot_valid``, whether the slot holds one
    (a member's score is ``tg - t``, distinct within an expert, so only
    the ``-inf`` scores of unfilled slots tie, and those are masked);
    ``ej``, ``pos`` and ``keep`` (k, G, Tg), each choice's expert, its
    slot there and whether it fit under ``capacity``.
    """
    g, tg, k = topi.shape
    dev = topi.device
    member = torch.zeros((g, tg, e), dtype=torch.int32, device=dev)
    for j in range(k):
        member = member + F.one_hot(topi[..., j], e).to(torch.int32)
    pos_in_e = torch.cumsum(member, dim=1, dtype=torch.int32) - 1  # (G,Tg,E)
    t_idx = torch.arange(tg, dtype=torch.int32, device=dev)
    score = torch.where(member.permute(0, 2, 1) > 0,
                        (tg - t_idx)[None, None, :].float(),
                        torch.tensor(float("-inf"), device=dev))  # (G,E,Tg)
    score = constraint(score, ("batch", ep, None))
    top_scores, idx = torch.topk(score, capacity, dim=-1)  # (G, E, C)
    slot_valid = top_scores > float("-inf")

    ej, pos, keep = [], [], []
    for j in range(k):
        e_j = topi[..., j]
        p_j = torch.gather(pos_in_e, 2, e_j[..., None])[..., 0]
        k_j = p_j < capacity
        ej.append(e_j)
        pos.append(torch.where(k_j, p_j, capacity - 1))
        keep.append(k_j)
    return idx, slot_valid, torch.stack(ej), torch.stack(pos), \
        torch.stack(keep)


def moe_forward(params, x: torch.Tensor, cfg: ModelConfig,
                capacity: Optional[int] = None):
    """x: (B, S, D) -> (B, S, D), plus aux loss (scalar float32)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    g = _dp_groups(t)
    tg = t // g
    xt = constraint(x.reshape(g, tg, d), ("batch", None, None))
    dev = x.device

    logits, topv, topi = route(params, xt, cfg)            # (G, Tg, k)
    weights = torch.softmax(topv, dim=-1).to(x.dtype)

    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(topi[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)

    if capacity is None:
        capacity = max(int(cfg.capacity_factor * tg * k / e), 8)
    capacity = min(capacity, tg)

    ep = "expert" if cfg.moe_shard_experts else None
    buf_axes = ("batch", ep, None, None)

    idx, slot_valid, ej, pos, keep = _slots(topi, e, capacity, ep)
    buf = _dispatch(xt, idx, slot_valid, ej, pos, keep)
    buf = constraint(buf, buf_axes)

    gate = torch.einsum("gecd,edf->gecf", buf, params["w_gate"])
    up = torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    h = F.silu(gate) * up
    out_buf = torch.einsum("gecf,efd->gecd", h, params["w_down"])
    out_buf = constraint(out_buf, buf_axes)

    # per-slot combine weight (for the gather-only backward)
    w_e = torch.zeros((g, tg, e), dtype=x.dtype, device=dev)
    for j in range(k):
        w_e = w_e + (F.one_hot(topi[..., j], e).to(x.dtype)
                     * weights[..., j][..., None])
    wsel = torch.gather(w_e.permute(0, 2, 1), 2, idx)

    out = _combine(out_buf, weights, idx, slot_valid, wsel, ej, pos, keep)
    out = constraint(out, ("batch", None, None))
    return out.reshape(b, s, d), aux.float()
