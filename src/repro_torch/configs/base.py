"""Model/config dataclasses for all assigned architectures."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None      # default d_model // n_heads
    # --- attention ---
    sliding_window: int = 0             # 0 = full attention
    rotary_pct: float = 1.0             # fraction of head_dim rotated
    rope_theta: float = 10000.0
    attn_logit_softcap: float = 0.0
    # --- mlp ---
    mlp_act: str = "swiglu"             # swiglu | geglu | gelu
    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    moe_shard_experts: bool = True      # EP over tp axis (False: TP-in-expert)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- ssm / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 64
    attn_every: int = 0                 # zamba: shared attn period (0 = off)
    slstm_layers: Tuple[int, ...] = ()  # xlstm: which layers are sLSTM
    # --- audio ---
    n_codebooks: int = 0
    # --- vlm ---
    n_patches: int = 0                  # stub frontend patches (prefill)
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    embed_scale: bool = False           # gemma: embeddings * sqrt(d_model)
    dtype: str = "bfloat16"
    #: rematerialization policy for the scanned blocks.  "full" saves only
    #: the (sequence-sharded) residual carry — the memory-fit default at
    #: 4k x 256 batch; "dots" additionally saves projection outputs (fewer
    #: recompute FLOPs, ~25 GB/chip more live activations at chatglm scale).
    remat: str = "full"                 # none | dots | full
    #: sequence-parallel residual carries ("sp" on the seq dim).  Saves
    #: 16x carry memory but costs backward re-gathers; §Perf measures both.
    seq_shard: bool = True
    # long-context capability: sub-quadratic attention path exists
    # (SWA / SSM / hybrid); gates the long_500k shape (DESIGN.md §4).
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        dtype = getattr(torch, self.dtype, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dtype

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.n_codebooks:
            emb = self.n_codebooks * self.vocab_size * d * 2
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.is_moe:
            ff = self.n_experts * 3 * d * self.d_ff
        elif self.mlp_act in ("swiglu", "geglu"):
            ff = 3 * d * self.d_ff
        else:
            ff = 2 * d * self.d_ff
        per_layer = attn + ff + 2 * d
        if self.family == "hybrid":
            di = self.ssm_expand * d
            per_layer = 2 * d * di + di * d + di * self.ssm_state * 2 + 2 * d
        if self.family == "ssm":
            di = 2 * d
            per_layer = d * 3 * di + di * d + 4 * di + 2 * d
        return emb + self.n_layers * per_layer

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        total = self.n_params()
        ff_all = self.n_layers * self.n_experts * 3 * d * self.d_ff
        ff_active = self.n_layers * self.top_k * 3 * d * self.d_ff
        return total - ff_all + ff_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape x step-kind) cell of the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    microbatches: int = 1
    z_loss: float = 1e-4
    seed: int = 0
    # gradient compression (optional, benchmarked in EXPERIMENTS.md)
    compression: str = "none"  # none | int8 | topk
    topk_frac: float = 0.01
