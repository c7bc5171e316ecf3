"""``repro_torch.runtime``: straggler mitigation (the bounded-delay
accumulator and the per-worker EWMA the elastic stream routes blocks by)
and the serving pull path's fault handling (``RetryPolicy``,
``CircuitBreaker``).  Of ``repro.runtime.fault``, the checkpointed training
loop (``TrainLoop``, with ``FaultConfig`` and ``SimulatedFailure``) is not
ported yet (``ROADMAP.md`` Queue 1)."""
from .fault import CircuitBreaker, RetryPolicy  # noqa: F401
from .straggler import (  # noqa: F401
    BoundedDelayAccumulator,
    StragglerConfig,
    StragglerEWMA,
)
