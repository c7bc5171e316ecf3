"""The optimizer of LM training: AdamW with dtype-policied moments and
global-norm clipping (``adamw``), and int8 gradient compression with error
feedback (``compression``)."""
from .adamw import AdamWConfig, apply_updates, global_norm, init_opt_state  # noqa: F401
from .compression import CompressionState, compress_grads, init_compression  # noqa: F401
