"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP stub
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.  The CLIP vision
frontend is a STUB per the assignment: input_specs() provides precomputed
patch embeddings (n_patches x d_model) prepended at prefill.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    n_patches=576,
    mlp_act="swiglu",
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="phi3v-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    n_patches=16,
    mlp_act="swiglu",
    subquadratic=False,
)
