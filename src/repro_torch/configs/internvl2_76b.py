"""internvl2-76b [arXiv:2404.16821; unverified] — InternViT + InternLM2.

The LLM backbone only (80L InternLM2-style); InternViT is the stubbed
modality frontend: a training batch's ``patches`` (B, 256, d_model) are
prepended to the text sequence.  Loss is masked to text positions."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    num_patches=256,
    rope_theta=1_000_000.0,
    fsdp=True,
    opt_dtype="bfloat16",
    microbatches=8,
))
