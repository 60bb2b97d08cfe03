"""Distribution layer of the port (``repro.dist``).

:mod:`.collectives` holds the gradient collectives of one process -- int8
error-feedback compression and microbatch accumulation -- and the
deterministic host mirrors of the device collectives (the sharded lease
directory's per-wave shard exchange rides them).  The device collectives
themselves and the sharding rules are not ported yet (``ROADMAP.md``
§1 item 1).
"""
from . import collectives

__all__ = ["collectives"]
