"""deepseek-coder-33b [dense] — llama arch [arXiv:2401.14196; hf].

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    mlp_act="swiglu",
    rope_theta=100000.0,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="deepseek-coder-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    mlp_act="swiglu",
    subquadratic=False,
)
