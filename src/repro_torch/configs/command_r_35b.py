"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01; unverified] — GQA, no bias,
LayerNorm, tied embeddings, 256k vocab."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    norm="layernorm",
    mlp="swiglu",
    use_bias=False,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    fsdp=True,
    microbatches=4,
))
