"""mixtral-8x22b [arXiv:2401.04088] — 8-expert top-2 MoE, GQA kv=8, SWA.

Sliding window (4096) keeps decode KV bounded ⇒ long_500k runs for this arch.
Parsa expert placement applies (DESIGN §3.2)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    num_experts_per_tok=2,
    swa_window=4096,
    rope_theta=1_000_000.0,
    fsdp=True,
    parsa_experts=True,
    microbatches=8,
))
