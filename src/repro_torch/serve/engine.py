"""Serving engine: continuous batching over prefill/decode steps.

A fixed-width decode batch of ``slots``; finished sequences free their slot
and queued requests are prefilled into it (continuous batching a la Orca /
vLLM).  Greedy sampling.  All model math lives in
:mod:`repro_torch.models.model`; the engine is pure scheduling, and runs
the model on ``device`` (the card unless the caller names another).

PUD hooks: the engine's integrity work (replica vote-healing and
bit-level verification) runs through a :class:`~repro_torch.serve.service.
PudService` — the engine is a thin *client* submitting typed
:class:`~repro_torch.serve.queue.HealRequest` / :class:`~repro_torch.serve.
queue.IntegrityRequest` work, so engine votes share the service's session
pool, schedule cache, continuous batching, and SLO accounting with
every other tenant.  The offload planner's verdict (where the vote
*would* run on PUD-capable memory) rides back on each heal result.

Integrity votes must be error-free, so healing on a non-ideal
:class:`~repro_torch.backends.context.ExecutionContext` (a stochastic
backend can corrupt the very bits it claims to heal) emits
:class:`IntegrityContextWarning` — or raises
:class:`IntegrityContextError` under ``strict_integrity=True``.
Non-ideal contexts are for fidelity studies, never serving deployments.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.backends import ExecutionContext
from repro_torch.configs.base import ModelConfig
from repro_torch.core import bitplanes as bp
from repro_torch.core import tree as tree_util
from repro_torch.models import model as M
from repro_torch.serve.queue import HealRequest, IntegrityRequest, ServeError
from repro_torch.serve.service import PudService, ServiceConfig

#: Words a row of the packed parameter tile: the reference's widest
#: column block (``tiling.MAX_BLOCK_C``), so heal and verify tiles equal
#: the reference's word for word.
HEAL_TILE_WORDS = 4096


class IntegrityContextError(ServeError):
    """heal_params refused to run on a non-ideal context (strict mode)."""


class IntegrityContextWarning(UserWarning):
    """heal_params is running on a non-ideal (stochastic) context."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32 (audio: (S, CB))
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.ascontiguousarray(leaf))


class Engine:
    """Single-slot-group engine (batch = the requests prefilled together).

    ``params`` is a tree (nested dicts and lists) of tensors on
    ``device`` for serving; the integrity hooks take any tree of tensors
    or arrays.
    Without ``pud_ctx``/``pud_service`` the engine owns a one-session
    service on ``pud_backend`` with an ideal context on ``device``.
    """

    def __init__(self, params, cfg: ModelConfig, max_seq: int = 256,
                 greedy: bool = True, seed: int = 0,
                 pud_backend: str = "cuda",
                 pud_ctx: Optional[ExecutionContext] = None,
                 pud_service: Optional[PudService] = None,
                 strict_integrity: bool = False,
                 tenant: str = "engine", device="cuda"):
        self.params = params
        self.cfg = cfg
        self.max_seq = max_seq
        self.greedy = greedy
        self.seed = seed
        self.device = torch.device(device)
        # Integrity work runs through a PudService; pass a shared
        # ``pud_service`` to pool votes with other engines/tenants, or
        # let the engine own a single-session service.  The service
        # defaults to an ideal context (see module docstring).
        self.service = pud_service or PudService(ServiceConfig(
            backend=pud_backend,
            ctx=pud_ctx or ExecutionContext(ideal=True,
                                            device=str(self.device)),
            pool_size=1))
        self.strict_integrity = strict_integrity
        self.tenant = tenant
        #: Compat: the first pooled session still answers the whole
        #: Backend surface (``engine.pud.ctx`` etc.).
        self.pud = self.service.sessions[0]
        self.pud_decisions: list = []

    @torch.inference_mode()
    def _prefill(self, params, batch):
        return M.prefill(params, batch, self.cfg, self.max_seq)

    @torch.inference_mode()
    def _decode(self, params, tokens, cache):
        return M.decode(params, tokens, cache, self.cfg)

    # ------------------------------------------------------------ PUD hooks
    def _check_integrity_ctx(self) -> None:
        """Enforce the ideal-context-by-default healing rule.

        Warns on a non-ideal context; raises under ``strict_integrity``.
        """
        if self.service.ctx.ideal:
            return
        msg = (f"heal_params is running on a non-ideal ExecutionContext "
               f"(mfr={self.service.ctx.mfr!r}, ideal=False): a "
               f"stochastic backend can corrupt the very bits it claims "
               f"to heal. Use ExecutionContext(ideal=True) for serving; "
               f"non-ideal contexts are for fidelity studies only.")
        if self.strict_integrity:
            raise IntegrityContextError(msg)
        warnings.warn(msg, IntegrityContextWarning, stacklevel=3)

    def _pack_pytree(self, tree):
        """Tree -> ((rows, width) uint32 tile, metas, total_words, width).

        Leaves pack in JAX's leaf order, each as its raw words, into one
        zero-padded tile of :data:`HEAL_TILE_WORDS`-word rows, on the
        leaves' device; the tile comes back to the host for the request.
        """
        metas = []  # (n_words, shape, dtype) per leaf, for re-splitting
        words = []
        for leaf in tree_util.flatten(tree)[0]:
            w, shape, dtype = bp.bitcast_to_planes(_as_tensor(leaf))
            metas.append((int(w.numel()), shape, dtype))
            words.append(w.reshape(-1))
        flat = torch.cat([w.to(words[0].device) for w in words])
        total = int(flat.numel())
        width = min(HEAL_TILE_WORDS, total)
        rows = -(-total // width)
        tile = torch.zeros(rows * width, dtype=torch.int32,
                           device=flat.device)
        tile[:total] = flat
        del flat, words
        return bp.to_u32(tile.reshape(rows, width)), metas, total, width

    def heal_params(self, replicas: Sequence) -> int:
        """Majority-vote parameter replicas through the PUD service.

        ``replicas``: >= 3 (odd) trees with the engine's param
        structure.  Installs the healed params (tensors on the service
        session's device) and returns the number of bits corrected in
        ``replicas[0]``.

        The engine is a thin client: every replica's packed words
        become one tile of a single typed
        :class:`~repro_torch.serve.queue.HealRequest`, and the service's
        batcher lowers it (coalesced with any concurrent tenants'
        same-shape votes) to ONE single-level fused Program — one
        batched MAJX launch on the ``cuda`` backend, schedule-cached
        across repeat votes.  The offload planner's verdict for the
        fused program is appended to ``self.pud_decisions``.
        """
        self._check_integrity_ctx()
        tiles, metas, total, _ = self._pack_pytree(replicas[0])
        rep_tiles = [tiles] + [self._pack_pytree(r)[0]
                               for r in replicas[1:]]
        stacked = np.stack(rep_tiles)
        del tiles, rep_tiles
        [result] = self.service.serve([HealRequest(
            replicas=stacked, tenant=self.tenant)])
        del stacked
        voted = result.healed.reshape(-1)[:total]

        healed_leaves, off = [], 0
        structure = tree_util.flatten(replicas[0])[1]
        for n_words, shape, dtype in metas:
            healed_leaves.append(bp.bitcast_from_planes(
                voted[off:off + n_words], shape, dtype))
            off += n_words
        self.params = tree_util.unflatten(structure, healed_leaves)
        self.pud_decisions.append(result.decision)
        return result.fixed_bits

    def verify_params(self, reference) -> float:
        """Bit-level success rate of live params vs a reference tree.

        One typed :class:`~repro_torch.serve.queue.IntegrityRequest`
        through the service (the tiles' zero padding matches on both
        sides, so the packed comparison equals the per-leaf one; the
        rate is normalized by the real parameter bits, not the padding).
        """
        live, _, total, _ = self._pack_pytree(self.params)
        ref, _, _, _ = self._pack_pytree(reference)
        [result] = self.service.serve([IntegrityRequest(
            live=live, reference=ref, tenant=self.tenant)])
        return 1.0 - result.mismatch_bits / max(total * 32, 1)

    # ------------------------------------------------------------ serving
    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy tokens: the argmax in numpy over float32 logits, so ties
        break as the reference's do.  (B,) or, for audio, (B, CB)."""
        lg = logits.float().cpu().numpy()
        return lg.argmax(-1)[:, 0]

    def _tokens(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=torch.int64, device=self.device)

    def generate(self, requests: list[Request]) -> list[Request]:
        """Serve a list of requests with continuous batching."""
        queue = list(requests)
        active: list[Request] = []
        cache = None
        while queue or active:
            # (re)fill the batch: group requests with equal prompt lengths
            # into one prefill; simple policy: batch all queued requests
            # of the most common length.
            if not active and queue:
                lens = [len(r.prompt) for r in queue]
                target = max(set(lens), key=lens.count)
                batch_reqs = [r for r in queue if len(r.prompt) == target]
                queue = [r for r in queue if len(r.prompt) != target]
                toks = self._tokens(np.stack([r.prompt for r in batch_reqs]))
                logits, cache = self._prefill(self.params, {"tokens": toks})
                first = self._sample(logits)
                for i, r in enumerate(batch_reqs):
                    r.out_tokens.append(first[i])
                active = batch_reqs
            # decode until every active request finishes
            while active and not all(r.done for r in active):
                last = np.stack([r.out_tokens[-1] for r in active])
                if self.cfg.family == "audio":
                    toks = self._tokens(last.reshape(len(active), 1, -1))
                else:
                    toks = self._tokens(last.reshape(len(active), 1))
                logits, cache = self._decode(self.params, toks, cache)
                nxt = self._sample(logits)
                for i, r in enumerate(active):
                    if r.done:
                        continue
                    r.out_tokens.append(nxt[i])
                    tok_scalar = (int(np.asarray(nxt[i]).flat[0])
                                  if np.ndim(nxt[i]) else int(nxt[i]))
                    if (len(r.out_tokens) >= r.max_new_tokens
                            or (r.eos_id is not None
                                and tok_scalar == r.eos_id)):
                        r.done = True
            active = []
            cache = None
        return requests
