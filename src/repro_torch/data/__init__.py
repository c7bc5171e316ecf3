"""Data pipelines of the port: deterministic synthetic token streams and
Parsa-aware document sharding."""
from .pipeline import ParsaShardedData, SyntheticLMData  # noqa: F401
