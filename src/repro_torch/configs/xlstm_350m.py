"""xlstm-350m [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks.

24 blocks in 3 groups of 8 (7 mLSTM + 1 sLSTM, the paper's 7:1 ratio).
d_ff=0: the blocks carry their own up/down projections.  Recurrent state ⇒
long_500k decode runs (O(1) state, no KV growth).  Parsa's parameter-side
placement is inapplicable (no sparse data↔param interaction) — DESIGN §7."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-350m",
    family="xlstm",
    num_layers=24,
    xlstm_group=8,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    rope_theta=0.0,
    parsa_embedding=False,
    microbatches=2,
))
