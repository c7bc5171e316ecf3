"""qwen3-14b [hf:Qwen/Qwen3-8B family] — GQA kv=8, per-head qk RMSNorm."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    norm="rmsnorm",
    mlp="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    microbatches=2,
))
