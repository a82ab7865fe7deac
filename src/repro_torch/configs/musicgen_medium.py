"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048 (per codebook, 4
codebooks, delay pattern).  The EnCodec frontend is a STUB per the
assignment: input_specs() provides token ids per codebook (training) or
precomputed frame embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    n_codebooks=4,
    mlp_act="gelu",
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=64,
    head_dim=16,
    n_codebooks=4,
    mlp_act="gelu",
    subquadratic=False,
)
