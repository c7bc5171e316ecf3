"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B] — qwen1.5 arch (attention bias, MHA)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,          # GQA kv=32 == MHA
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    norm="rmsnorm",
    mlp="swiglu",
    use_bias=True,            # qwen1.5 keeps qkv bias
    rope_theta=1_000_000.0,
    microbatches=2,
))
