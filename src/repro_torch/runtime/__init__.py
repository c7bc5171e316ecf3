"""``repro_torch.runtime``: straggler mitigation (the bounded-delay
accumulator and the per-worker EWMA the elastic stream routes blocks by).
The fault-tolerant training loop of ``repro.runtime.fault`` is not ported
yet (``ROADMAP.md`` Queue 1)."""
from .straggler import (  # noqa: F401
    BoundedDelayAccumulator,
    StragglerConfig,
    StragglerEWMA,
)
