"""The plain loop of K9: the JAX package's ``lax.while_loop`` over the
simulator's step (``repro.core.simulator``: ``cond`` and ``step``), run
on the tensors of the state in place by the port's plain step
(:mod:`repro_torch.core.simulator`, :mod:`repro_torch.core.directory`)."""
from __future__ import annotations

from ...core import simulator as S


def sim_run_ref(st, geom, proto: str):
    """Step ``st`` while some core is not done and ``steps < max_steps``
    (the JAX loop's condition, read before every step).  Returns ``st``."""
    step = S._make_step(geom, S.mem_fn_of(proto))
    cfg = S.host_cfg(st)
    while S.running(st):
        step(st, cfg)
    return st
