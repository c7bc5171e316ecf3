"""zamba2-2.7b [arXiv:2411.15242] — Mamba2 backbone + shared attention block.

54 layers = 9 groups × (5 Mamba2 + 1 weight-tied shared attention block);
we drop the per-invocation LoRA deltas on the shared block (DESIGN §7).
SSM state ⇒ long_500k decode runs."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    hybrid_group=6,           # 5 mamba + 1 shared attn per group
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    rope_theta=10_000.0,
    parsa_embedding=False,
    microbatches=2,
))
