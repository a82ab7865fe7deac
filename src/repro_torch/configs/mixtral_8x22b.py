"""mixtral-8x22b [moe] — 8 experts top-2, GQA kv=8, SWA [arXiv:2401.04088; hf].

56L d_model=6144 48H (kv=8) d_ff=16384 vocab=32768, sliding window 4096.
Sharding note: 8 experts < 16 TP chips, so expert FFN hidden is
tensor-parallel *within* each expert (moe_shard_experts=False); SWA gives a
sub-quadratic path, so long_500k runs with a 4096-token live window.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    n_experts=8,
    top_k=2,
    moe_shard_experts=False,
    sliding_window=4096,
    mlp_act="swiglu",
    rope_theta=1e6,
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    n_experts=4,
    top_k=2,
    moe_shard_experts=False,
    sliding_window=16,
    mlp_act="swiglu",
    subquadratic=True,
)
