"""whisper-medium [arXiv:2212.04356; unverified] — enc-dec; the conv/mel
frontend is a STUB per the assignment: input_specs() supplies precomputed
frame embeddings (B, 1500, d_model). 24 encoder + 24 decoder layers."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,            # decoder layers
    encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    norm="layernorm",
    mlp="gelu",
    use_bias=True,
    rope_theta=0.0,           # sinusoidal absolute positions, no rope
))
