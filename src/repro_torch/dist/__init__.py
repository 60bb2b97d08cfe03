"""Distribution layer of the port (``repro.dist``): sharding rules,
gradient and device collectives, activation annotations.

  * :mod:`.sharding`    -- specs for params / optimizer state / batches /
    decode caches (divisibility-guarded, expert-parallel MoE placement,
    pod-axis fallback) and their ``DTensor`` placements on a
    ``DeviceMesh``,
  * :mod:`.collectives` -- int8 error-feedback gradient compression,
    microbatch accumulation, the device collectives over a
    ``torch.distributed`` group and their deterministic numpy mirrors
    (the sharded lease directory's per-wave shard exchange rides them),
  * :mod:`.annotate`    -- activation placements bound to the ambient
    mesh (no-ops outside one, so model code runs unchanged on one
    device).
"""
from . import annotate, collectives, sharding

__all__ = ["annotate", "collectives", "sharding"]
