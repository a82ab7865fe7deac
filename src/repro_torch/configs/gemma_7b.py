"""gemma-7b [dense] — GeGLU, head_dim=256 [arXiv:2403.08295; hf].

28L d_model=3072 16H (kv=16, i.e. MHA on 7b; MQA is the 2b variant)
d_ff=24576 vocab=256000.  Embeddings scaled by sqrt(d_model).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    mlp_act="geglu",
    embed_scale=True,
    tie_embeddings=True,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="gemma-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=32,
    mlp_act="geglu",
    embed_scale=True,
    tie_embeddings=True,
    subquadratic=False,
)
