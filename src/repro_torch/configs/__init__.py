"""Architecture registry of the port: the dense configurations,
mixtral-8x22b and deepseek-v2-236b (the MoE family, the latter with MLA),
whisper-medium (the encoder-decoder family), internvl2-76b (the VLM),
xlstm-350m (xLSTM) and zamba2-2.7b (the Mamba2 hybrid).

The port's own copy of ``repro.configs``' model configurations (the port
imports nothing of ``repro``).
"""
from .base import REGISTRY, ModelConfig, get_config, list_configs, register  # noqa: F401

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (  # noqa: F401
        codeqwen15_7b,
        command_r_35b,
        deepseek_v2_236b,
        internvl2_76b,
        mixtral_8x22b,
        nemotron_4_340b,
        qwen3_14b,
        whisper_medium,
        xlstm_350m,
        zamba2_2p7b,
    )
