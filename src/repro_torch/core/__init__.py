"""Tardis timestamp coherence in PyTorch (the port of ``repro.core``).

  * :mod:`.protocol`     -- Tables I-III as torch functions,
  * :mod:`.timestamps`   -- the ts_bits rebase guard (section IV-B),
  * :mod:`.policy`       -- CoherencePolicy (consistency model, leases),
  * :mod:`.lease_engine` -- LeaseEngine: int32 block tables + paged KV
                            pool on the card, transitions in the kernels,
  * :mod:`.store`        -- TardisStore / Replica: the weight lease.

The engine names load on first access: the kernels' plain versions import
:mod:`.protocol`, and the engine imports the kernels.
"""
from .policy import CONSISTENCY_MODELS, CoherencePolicy

_ENGINE = ("LeaseEngine", "LeaseStats", "ReadManyResult", "ReadResult")

__all__ = ["CONSISTENCY_MODELS", "CoherencePolicy", *_ENGINE]


def __getattr__(name):
    if name in _ENGINE:
        from . import lease_engine
        return getattr(lease_engine, name)
    raise AttributeError(name)
