"""``repro_torch.stream``: online incremental Parsa over growing graphs, on
the card.

One session per stream; feeds are O(1) dispatches (one ``parsa_scan``
launch) against the live packed server sets; drift-triggered
repartitions are matched back onto the live labels with metered
migration.  See ``online.py`` for the full story.
"""
from .arena import StreamArena  # noqa: F401
from .drift import DriftDecision, DriftTracker  # noqa: F401
from .migrate import MigrationPlan, plan_migration  # noqa: F401
from .online import (  # noqa: F401
    ParsaStreamConfig,
    StreamSession,
    StreamUpdate,
    stream_partition,
)
