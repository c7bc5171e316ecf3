"""``repro_torch.runtime``: fault tolerance (the checkpointed training loop
``TrainLoop`` with ``FaultConfig`` and ``SimulatedFailure``, and the
serving pull path's ``RetryPolicy`` and ``CircuitBreaker``) and straggler
mitigation (the bounded-delay accumulator and the per-worker EWMA the
elastic stream routes blocks by)."""
from .fault import (  # noqa: F401
    CircuitBreaker,
    FaultConfig,
    RetryPolicy,
    SimulatedFailure,
    TrainLoop,
)
from .straggler import (  # noqa: F401
    BoundedDelayAccumulator,
    StragglerConfig,
    StragglerEWMA,
)
