"""chatglm3-6b [dense] — partial RoPE ("2d"), GQA kv=2 [arXiv:2406.12793; hf].

28L d_model=4096 32H (kv=2) d_ff=13696 vocab=65024.  GLM applies rotary to
half the head dims (rotary_pct=0.5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rotary_pct=0.5,
    mlp_act="swiglu",
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="chatglm3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    rotary_pct=0.5,
    mlp_act="swiglu",
    subquadratic=False,
)
