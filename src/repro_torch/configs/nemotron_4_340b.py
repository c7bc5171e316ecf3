"""nemotron-4-340b [arXiv:2402.16819; unverified] — dense GQA, squared-ReLU MLP.

The training fields (``fsdp``, ``opt_dtype``, ``microbatches``) are kept
as the reference has them; training reads ``opt_dtype`` (bf16 AdamW
moments) and ``microbatches``, and ``fsdp`` has no meaning on one card."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    norm="layernorm",
    mlp="squared_relu",
    rope_theta=10_000.0,
    fsdp=True,
    opt_dtype="bfloat16",
    microbatches=16,
))
