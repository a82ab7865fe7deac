"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H (kv=4) d_ff=0 (projections live inside the xLSTM
blocks) vocab=50304.  sLSTM at layers {3, 7, 11} (sparse placement as in
the paper's LM configs); the rest are mLSTM (matrix-memory) blocks.
Pure recurrent state -> long_500k runs.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_layers=(3, 7, 11),
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=256,
    slstm_layers=(1, 3),
    subquadratic=True,
)
