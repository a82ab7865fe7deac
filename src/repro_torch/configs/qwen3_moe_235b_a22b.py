"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936.
Fine-grained experts: the 128-expert dim shards over the TP axis (EP, 8
experts per chip at model=16).  Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    n_experts=128,
    top_k=8,
    moe_shard_experts=True,
    mlp_act="swiglu",
    rope_theta=1e6,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=32,
    vocab_size=256,
    head_dim=8,
    n_experts=8,
    top_k=2,
    moe_shard_experts=True,
    mlp_act="swiglu",
    subquadratic=False,
)
