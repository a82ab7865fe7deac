"""glm4-9b [dense] — RoPE (partial), GQA kv=2 [hf:THUDM/glm-4-9b; hf].

40L d_model=4096 32H (kv=2) d_ff=13696 vocab=151552.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    rotary_pct=0.5,
    mlp_act="swiglu",
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="glm4-smoke",
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
