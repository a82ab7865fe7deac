"""Gradient compression with error feedback (distributed-optimization trick).

Two codecs, both with residual error feedback so compression error does not
accumulate (Karimireddy et al., 2019):

* **int8**: per-tensor symmetric quantization of the gradient before the
  (conceptual) all-reduce — 4x wire traffic reduction at bf16 training.
* **top-k**: magnitude sparsification keeping ``frac`` of entries.

On one card there is no all-reduce; the codec is applied between the
gradient computation and the optimizer, and its *wire-format byte count*
is reported, as the reference reports it.  ``torch.round`` rounds half to
even, as ``jnp.round`` does; the top-k threshold is the k-th largest
magnitude and every entry at or above it is kept (ties included), as
``jax.lax.top_k`` with ``>=`` keeps them.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import tree as tree_util


class ErrorFeedback(NamedTuple):
    residual: Any


def init_feedback(params) -> ErrorFeedback:
    leaves, structure = tree_util.flatten(params)
    return ErrorFeedback(tree_util.unflatten(structure, [
        torch.zeros_like(p, dtype=torch.float32) for p in leaves]))


def _quant_int8(g: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-8) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def _topk(g: torch.Tensor, frac: float) -> torch.Tensor:
    flat = g.reshape(-1)
    k = max(int(flat.numel() * frac), 1)
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    return torch.where(torch.abs(g) >= thresh, g, 0.0)


@torch.no_grad()
def compress(grads, fb: ErrorFeedback, method: str,
             topk_frac: float = 0.01):
    """Returns (decoded grads as seen post-allreduce, new feedback, stats)."""
    if method == "none":
        return grads, fb, {"wire_bytes_frac": 1.0}
    if method not in ("int8", "topk"):
        raise ValueError(method)

    def one(g, r):
        gf = g.float() + r
        dec = _quant_int8(gf) if method == "int8" else _topk(gf, topk_frac)
        return dec, gf - dec

    flat_g, structure = tree_util.flatten(grads)
    flat_r = tree_util.flatten(fb.residual)[0]
    outs = [one(g, r) for g, r in zip(flat_g, flat_r)]
    dec = tree_util.unflatten(structure, [o[0] for o in outs])
    res = tree_util.unflatten(structure, [o[1] for o in outs])
    frac = {"int8": 0.25, "topk": topk_frac * 2.5}[method]  # idx overhead
    return dec, ErrorFeedback(res), {"wire_bytes_frac": frac}
