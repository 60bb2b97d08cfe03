"""Tardis timestamp coherence in PyTorch (the port of ``repro.core``).

  * :mod:`.protocol`     -- Tables I-III as torch functions,
  * :mod:`.timestamps`   -- the ts_bits rebase guard (section IV-B),
  * :mod:`.policy`       -- CoherencePolicy (consistency model, leases),
  * :mod:`.lease_engine` -- LeaseEngine: int32 block tables + paged KV
                            pool on the card, transitions in the kernels,
  * :mod:`.store`        -- TardisStore / Replica: the weight lease,
  * :mod:`.shard_directory` -- ShardedLeaseDirectory: one lease table and
                            home KV pool hashed across hosts' shards.

The engine and directory names load on first access: the kernels' plain
versions import :mod:`.protocol`, and the engine imports the kernels.
"""
from .policy import CONSISTENCY_MODELS, CoherencePolicy

_ENGINE = ("LeaseEngine", "LeaseStats", "ReadManyResult", "ReadResult")
_DIRECTORY = ("DirStats", "DirWaveResult", "FetchedPage", "NumpyTransport",
              "ShardedLeaseDirectory")

__all__ = ["CONSISTENCY_MODELS", "CoherencePolicy", *_ENGINE, *_DIRECTORY]


def __getattr__(name):
    if name in _ENGINE:
        from . import lease_engine
        return getattr(lease_engine, name)
    if name in _DIRECTORY:
        from . import shard_directory
        return getattr(shard_directory, name)
    raise AttributeError(name)
