"""Roofline arithmetic of a cell on the card: the port of
``repro/launch/roofline.py`` without its HLO parser.

  compute    = FLOPs per device / the dense bf16 peak
  memory     = bytes per device / the HBM bandwidth
  collective = wire bytes per device / the NVLink bandwidth

``MODEL_FLOPS`` is 6·N·D for a train step (6·N_active·D for MoE), 2·N·D
for a prefill and 2·N per decoded token, from the configuration's
parameter counts (``count_params``); the useful-compute ratio
``model_flops / (flops × chips)`` shows remat and dispatch waste.

The reference reads its per-device FLOPs, bytes and collectives from a
compiled XLA module (``parse_collectives`` parses its HLO).  The port has
no XLA module, so that parser is not ported: a caller passes the counts,
and ``collectives`` as a given dict.
"""
from __future__ import annotations

import dataclasses
import json

__all__ = ["HW", "Roofline", "model_flops", "count_params", "save_report"]

# One NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet), at its 700 W power
# limit; a card set below it runs slower under load.
HW = {
    "peak_flops_bf16": 989e12,   # dense bf16 tensor-core FLOP/s
    "hbm_bw": 3.35e12,           # HBM3 bytes/s
    # NVLink 4, bytes/s a card (both directions, 18 links).  A one-card
    # cell has no collective, so its collective term is 0.
    "ici_bw": 900e9,
}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    collectives: dict
    model_flops: float
    peak_memory_per_device: float

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / HW["peak_flops_bf16"]

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HW["hbm_bw"]

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_device / HW["ici_bw"]

    @property
    def bottleneck(self) -> str:
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def useful_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The share of the bf16 peak that useful FLOPs reach at the
        dominant term's time."""
        t_star = max(self.t_compute, self.t_memory, self.t_collective)
        if t_star == 0:
            return 0.0
        return (self.model_flops / self.chips / HW["peak_flops_bf16"]) / t_star

    def as_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "peak_memory_per_device": self.peak_memory_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collectives": self.collectives,
        }


def model_flops(cfg, shape_info: dict, n_params: float,
                n_active: float) -> float:
    """6·N·D for training; 2·N·D·S for prefill; 2·N·D per decoded token
    (N the active parameters)."""
    B, S = shape_info["batch"], shape_info["seq"]
    if shape_info["kind"] == "train":
        return 6.0 * n_active * B * S
    if shape_info["kind"] == "prefill":
        return 2.0 * n_active * B * S
    return 2.0 * n_active * B * 1  # decode: one token per sequence


def count_params(cfg) -> tuple[float, float]:
    """(total, active) parameter counts from the configuration's
    arithmetic, as the reference counts them: the matrices (embedding,
    head, attention, MLP or experts and router, the recurrent cells'
    projections); not the norm scales, biases, the recurrent cells'
    per-head vectors or the Mamba2 conv weights; an encoder layer as two
    attentions and an MLP, and the hybrid's weight-tied attention layer
    and MLP once a group.  ``Model.param_count`` counts what is built."""
    D, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    embed = V * D * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "xlstm":
        G = L // cfg.xlstm_group
        n_m = cfg.xlstm_group - 1
        per_m = 4 * D * H * hd + 2 * D * H + H * hd * D
        per_s = 4 * (D * H * hd + H * hd * hd) + H * hd * D
        total = embed + G * (n_m * per_m + per_s)
        return float(total), float(total)
    if cfg.family == "hybrid":
        G = L // cfg.hybrid_group
        n_m = cfg.hybrid_group - 1
        d_in = cfg.ssm_expand * D
        Hs = d_in // cfg.ssm_headdim
        per_mamba = 2 * D * d_in + 2 * D * cfg.ssm_state + D * Hs + d_in * D
        attn = D * (H + 2 * KV) * hd + H * hd * D
        mlp = 3 * D * cfg.d_ff
        total = embed + G * (n_m * per_mamba + attn + mlp)
        return float(total), float(total)
    if cfg.mla:
        attn = (D * cfg.q_lora_rank
                + cfg.q_lora_rank * H * (hd + cfg.rope_head_dim)
                + D * (cfg.kv_lora_rank + cfg.rope_head_dim)
                + cfg.kv_lora_rank * H * (hd + cfg.v_head_dim)
                + H * cfg.v_head_dim * D)
    else:
        attn = D * (H + 2 * KV) * hd + H * hd * D
    if cfg.num_experts:
        per_expert = 3 * D * cfg.d_ff
        shared = 3 * D * cfg.d_ff * cfg.num_shared_experts
        router = D * cfg.num_experts
        mlp_total = cfg.num_experts * per_expert + shared + router
        mlp_active = cfg.num_experts_per_tok * per_expert + shared + router
    else:
        nmat = 3 if cfg.mlp == "swiglu" else 2
        mlp_total = mlp_active = nmat * D * cfg.d_ff
    enc = (cfg.encoder_layers * (attn * 2 + mlp_total)
           if cfg.family == "encdec" else 0)
    xattn = attn if cfg.family == "encdec" else 0
    total = embed + L * (attn + xattn + mlp_total) + enc
    active = embed + L * (attn + xattn + mlp_active) + enc
    return float(total), float(active)


def save_report(path: str, rows: list[dict]) -> None:
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
