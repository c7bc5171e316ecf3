"""Architecture registry of the port: the dense configurations,
mixtral-8x22b and deepseek-v2-236b (the MoE family, the latter with MLA)
and whisper-medium (the encoder-decoder family).

The port's own copy of ``repro.configs`` for the families it builds (the
port imports nothing of ``repro``).  The other families' configurations
come with the slices that port their blocks (``ROADMAP.md`` Queue 1, the
other model families).
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
        mixtral_8x22b,
        nemotron_4_340b,
        qwen3_14b,
        whisper_medium,
    )
