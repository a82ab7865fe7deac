"""Data pipeline: deterministic synthetic token streams + packing.

Production posture: the loader is an iterator of already-sharded global
batches keyed by (step, host) so that restarts resume mid-epoch
deterministically (checkpoint stores the step counter only — no loader
state to snapshot) and elastic re-meshes re-shard cleanly.  The synthetic
source is a fixed-seed Markov-ish token process with enough structure that
cross-entropy demonstrably falls during the example runs (examples/).
The module is a copy of the reference's (numpy only): its batches are
byte-equal to the reference's, and the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_codebooks: int = 0     # audio
    n_patches: int = 0       # vlm
    d_model: int = 0         # vlm patch dim


def _structured_tokens(rng: np.random.Generator, shape, vocab: int):
    """Tokens with learnable structure: x[t+1] = (a*x[t] + b + noise) % V."""
    a = 31, 7
    base = rng.integers(0, vocab, size=shape[:-1] + (1,), dtype=np.int64)
    steps = np.arange(shape[-1], dtype=np.int64)
    seq = (base * a[0] + steps * a[1]) % vocab
    noise = rng.integers(0, vocab, size=shape)
    use_noise = rng.random(shape) < 0.1
    return np.where(use_noise, noise, seq).astype(np.int32)


class SyntheticLM:
    """Deterministic synthetic LM batches; batch(step) is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        if c.n_codebooks:
            shape = (c.global_batch, c.seq_len + 1, c.n_codebooks)
            toks = _structured_tokens(rng, (c.global_batch, c.n_codebooks,
                                            c.seq_len + 1), c.vocab_size)
            toks = toks.transpose(0, 2, 1)
            out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        else:
            toks = _structured_tokens(rng, (c.global_batch, c.seq_len + 1),
                                      c.vocab_size)
            out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if c.n_patches:
            out["patches"] = rng.standard_normal(
                (c.global_batch, c.n_patches, c.d_model)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def loader_for(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
               global_batch: Optional[int] = None) -> SyntheticLM:
    return SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=shape.seq_len,
        global_batch=global_batch or shape.global_batch,
        seed=seed,
        n_codebooks=cfg.n_codebooks,
        n_patches=cfg.n_patches if cfg.family == "vlm" else 0,
        d_model=cfg.d_model,
    ))


def pack_documents(docs: list[np.ndarray], seq_len: int, pad_id: int = 0):
    """Greedy sequence packing with boundary masks (standard pretraining
    packing; exercised by tests as the 'real data path' stand-in)."""
    out_tokens, out_mask, out_segments = [], [], []
    cur, seg, seg_id = [], [], 1
    for doc in docs:
        d = list(doc)
        while d:
            space = seq_len - len(cur)
            take, d = d[:space], d[space:]
            cur.extend(take)
            seg.extend([seg_id] * len(take))
            if len(cur) == seq_len:
                out_tokens.append(cur)
                out_mask.append([1] * seq_len)
                out_segments.append(seg)
                cur, seg = [], []
                seg_id += 1
        seg_id += 1
    if cur:
        pad = seq_len - len(cur)
        out_tokens.append(cur + [pad_id] * pad)
        out_mask.append([1] * len(cur) + [0] * pad)
        out_segments.append(seg + [0] * pad)
    return (np.asarray(out_tokens, np.int32), np.asarray(out_mask, np.int32),
            np.asarray(out_segments, np.int32))
