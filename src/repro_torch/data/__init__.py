"""Data of the port (``repro.data``): the deterministic synthetic stream."""
from .pipeline import Prefetcher, batch_to, shard_batch, synthetic_batch

__all__ = ["Prefetcher", "batch_to", "shard_batch", "synthetic_batch"]
