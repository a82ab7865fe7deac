"""zamba2-1.2b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
One *shared* full-attention block (params reused) interleaved every 6
Mamba2 layers — the Zamba trick.  Sub-quadratic: long_500k runs.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_chunk=64,
    attn_every=6,
    mlp_act="gelu",
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_chunk=8,
    attn_every=2,
    mlp_act="gelu",
    subquadratic=True,
)
