"""deepseek-v2-236b [arXiv:2405.04434] — MLA (kv_lora=512) + 160-expert top-6
MoE with 2 shared experts; d_ff=1536 is the per-expert width.

Deviation (DESIGN §7): the HF model keeps layer 0 dense; we make all 60
layers MoE so the stack scans homogeneously."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,        # MLA: kv head count == heads (latent cache)
    head_dim=128,            # nope head dim
    d_ff=1536,               # per routed expert
    vocab_size=102400,
    num_experts=160,
    num_experts_per_tok=6,
    num_shared_experts=2,
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    fsdp=True,
    opt_dtype="bfloat16",
    parsa_experts=True,
    microbatches=8,
))
