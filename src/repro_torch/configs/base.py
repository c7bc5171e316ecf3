"""ModelConfig: the port's copy of the reference's one dataclass for every
architecture.

Every field that differs across the pool is explicit; families select which
block stack ``build_model`` emits (see models/model.py).  The port builds
every family; the distribution fields (``fsdp``, ``scan_layers``) are kept
so that a configuration reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "register", "get_config", "list_configs", "REGISTRY"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | encdec | xlstm | hybrid | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # block details
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    mlp: str = "swiglu"          # swiglu | squared_relu | gelu
    qk_norm: bool = False
    use_bias: bool = False
    rope_theta: float = 1e4
    swa_window: Optional[int] = None     # sliding-window attention
    tie_embeddings: bool = False

    # mixture of experts
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25

    # multi-head latent attention (deepseek-v2)
    mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    v_head_dim: int = 128

    # ssm / hybrid / xlstm
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    hybrid_group: int = 6        # zamba2: 5 mamba + 1 shared attn per group
    xlstm_group: int = 8         # xlstm: 7 mLSTM + 1 sLSTM per group

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500      # precomputed frame embeddings (stub frontend)

    # vlm (internvl): stub patch embeddings prepended to the text sequence
    num_patches: int = 0

    # numerics / distribution policy
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"          # none | full | dots
    fsdp: bool = False           # shard weights over the data axis (ZeRO-3)
    opt_dtype: str = "float32"   # adam moment dtype (bf16 for the giants)
    attn_impl: str = "chunked"   # chunked | naive
    attn_chunk: int = 1024
    scan_layers: bool = True
    grad_compress: bool = False  # int8 + error-feedback on the DP all-reduce
    microbatches: int = 1        # gradient accumulation (activation memory ÷ n)

    # which Parsa features apply (DESIGN §3 / §7)
    parsa_embedding: bool = True
    parsa_experts: bool = False

    @property
    def group_dim(self) -> int:
        """GQA group size."""
        return self.num_heads // self.num_kv_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the vocab axis shards over tp=16 with
        128-lane-aligned shards (whisper 51865→51968, qwen3 151936→152064,
        xlstm 50304→50432; the rest are already multiples)."""
        return int(-(-self.vocab_size // 256) * 256)

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test config of the same family (small widths, few layers)."""
        small = dict(
            num_layers=max(2, self.hybrid_group if self.family == "hybrid" else 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=256,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_layers else self.encoder_seq,
            num_patches=8 if self.num_patches else 0,
            num_experts=4 if self.num_experts else 0,
            num_experts_per_tok=min(2, self.num_experts_per_tok) if self.num_experts else 0,
            num_shared_experts=min(1, self.num_shared_experts),
            kv_lora_rank=32,
            q_lora_rank=48,
            rope_head_dim=8,
            v_head_dim=16,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            hybrid_group=3,
            xlstm_group=4,
            attn_impl="naive",
            remat="none",
            fsdp=False,
            scan_layers=True,
            dtype="float32",
        )
        if self.family == "hybrid":
            small["num_layers"] = 6   # 2 groups of (2 mamba + 1 shared attn)
        if self.family == "xlstm":
            small["num_layers"] = 8   # 2 groups of (3 mLSTM + 1 sLSTM)
        small.update(overrides)
        return dataclasses.replace(self, **small)


REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import _load_all  # noqa: F401  (populate registry lazily)

    _load_all()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_configs() -> list[str]:
    from . import _load_all

    _load_all()
    return sorted(REGISTRY)
