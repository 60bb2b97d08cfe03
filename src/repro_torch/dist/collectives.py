"""Deterministic numpy mirrors of the tiled device collectives.

The port of ``repro.dist.collectives.np_psum`` / ``np_all_gather`` /
``np_reduce_scatter`` / ``np_all_to_all`` (``collectives.py:144-176``):
lists of per-device arrays in, the same out, with the shapes and semantics
of the tiled ``psum`` / ``all_gather`` / ``psum_scatter`` /
``all_to_all``.  :class:`repro_torch.core.shard_directory.NumpyTransport`
routes every directory wave's per-shard flit counts through
:func:`np_all_to_all`, the one-message-per-peer exchange.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["np_psum", "np_all_gather", "np_reduce_scatter",
           "np_all_to_all"]


def np_psum(shards: Sequence[np.ndarray]) -> List[np.ndarray]:
    total = np.sum(np.stack([np.asarray(s) for s in shards]), axis=0)
    return [total.copy() for _ in shards]


def np_all_gather(shards: Sequence[np.ndarray]) -> List[np.ndarray]:
    full = np.concatenate([np.asarray(s) for s in shards], axis=0)
    return [full.copy() for _ in shards]


def np_reduce_scatter(shards: Sequence[np.ndarray]) -> List[np.ndarray]:
    n = len(shards)
    total = np.sum(np.stack([np.asarray(s) for s in shards]), axis=0)
    if total.shape[0] % n:
        raise ValueError(
            f"reduce_scatter dim 0 ({total.shape[0]}) not divisible by "
            f"device count {n}")
    return [p.copy() for p in np.split(total, n, axis=0)]


def np_all_to_all(shards: Sequence[np.ndarray]) -> List[np.ndarray]:
    n = len(shards)
    pieces = []
    for s in shards:
        s = np.asarray(s)
        if s.shape[0] % n:
            raise ValueError(
                f"all_to_all dim 0 ({s.shape[0]}) not divisible by "
                f"device count {n}")
        pieces.append(np.split(s, n, axis=0))
    # device j receives piece j of every device, in device order
    return [np.concatenate([pieces[i][j] for i in range(n)], axis=0)
            for j in range(n)]
