"""Data pipelines of the port: Parsa-aware document sharding."""
from .pipeline import ParsaShardedData  # noqa: F401
