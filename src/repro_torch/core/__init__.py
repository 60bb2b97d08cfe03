"""Tardis timestamp coherence in PyTorch (the port of ``repro.core``).

  * :mod:`.protocol`     -- Tables I-III as torch functions,
  * :mod:`.timestamps`   -- the ts_bits rebase guard (section IV-B),
  * :mod:`.policy`       -- CoherencePolicy (consistency model, leases),
  * :mod:`.lease_engine` -- LeaseEngine: int32 block tables + paged KV
                            pool on the card, transitions in the kernels,
  * :mod:`.store`        -- TardisStore / Replica: the weight lease,
  * :mod:`.shard_directory` -- ShardedLeaseDirectory: one lease table and
                            home KV pool hashed across hosts' shards,
  * :mod:`.simulator`    -- the paper's multi-core coherence simulator
                            (Tardis; :mod:`.directory`: full-map MSI and
                            Ackwise), one K9 launch a run on the card,
  * :mod:`.geometry`, :mod:`.traces`, :mod:`.check` -- its machine shape,
                            SPLASH-2-like traces and SC validators.

The engine, directory and simulator names load on first access: the
kernels' plain versions import :mod:`.protocol`, and the engine and the
simulator import the kernels.
"""
from .policy import CONSISTENCY_MODELS, CoherencePolicy

_ENGINE = ("LeaseEngine", "LeaseStats", "ReadManyResult", "ReadResult")
_DIRECTORY = ("DirStats", "DirWaveResult", "FetchedPage", "NumpyTransport",
              "ShardedLeaseDirectory")
_SIMULATOR = {"SimConfig": "simulator", "SimResult": "simulator",
              "simulate": "simulator", "Geometry": "geometry",
              "Trace": "traces", "make_trace": "traces",
              "TRACE_GENERATORS": "traces"}

__all__ = ["CONSISTENCY_MODELS", "CoherencePolicy", *_ENGINE, *_DIRECTORY,
           *_SIMULATOR]


def __getattr__(name):
    if name in _ENGINE:
        from . import lease_engine
        return getattr(lease_engine, name)
    if name in _DIRECTORY:
        from . import shard_directory
        return getattr(shard_directory, name)
    if name in _SIMULATOR:
        import importlib
        return getattr(importlib.import_module(f".{_SIMULATOR[name]}",
                                               __name__), name)
    raise AttributeError(name)
