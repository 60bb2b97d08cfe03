"""Distribution layer of the port (``repro.dist``).

Only the deterministic host mirrors of the device collectives
(:mod:`.collectives`) are ported: the sharded lease directory's per-wave
shard exchange rides them.  The device collectives, sharding rules and
gradient compression belong to the training side and are not ported yet.
"""
from . import collectives

__all__ = ["collectives"]
