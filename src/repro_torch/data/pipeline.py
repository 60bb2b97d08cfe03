"""Deterministic synthetic data pipeline with background prefetch (the port
of ``repro.data.pipeline``; numpy only, so a batch here is byte for byte
the JAX package's on the same numpy).

Batches are a pure function of (seed, step) so every restart replays the
exact token stream (a checkpoint stores only the step).  The token stream
is a mixture of Zipf unigrams and repeated n-grams so small models show a
real, declining loss.  ``Generator.zipf`` draws other samples on other
numpy versions, so a batch (and a loss) is comparable only within one
installation.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def synthetic_batch(seed: int, step: int, batch: int, seq: int,
                    vocab: int, extras: Optional[Dict] = None):
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    # zipfian unigrams
    z = rng.zipf(1.3, size=(batch, seq + 1))
    toks = (z % (vocab - 2)) + 1
    # inject copyable n-grams (predictable structure to learn)
    for b in range(batch):
        pat_len = int(rng.integers(4, 12))
        pat = rng.integers(1, vocab - 1, pat_len)
        reps = (seq + 1) // (pat_len * 2)
        for _r in range(reps):
            at = int(rng.integers(0, seq + 1 - pat_len))
            toks[b, at:at + pat_len] = pat
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    out = {"tokens": tokens, "labels": labels}
    if extras:
        for k, spec in extras.items():
            out[k] = rng.normal(size=spec["shape"]).astype(spec.get(
                "dtype", np.float32))
    return out


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (the port's ``shard_batch``
    on one device)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class Prefetcher:
    """Host-side background prefetch of the next N batches."""

    def __init__(self, make_batch, start_step: int = 0, depth: int = 2):
        self._make = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        s = self._step
        while not self._stop.is_set():
            try:
                self._q.put((s, self._make(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()


def shard_batch(batch: Dict[str, np.ndarray], shardings):
    """Place a host batch onto the mesh with the given shardings
    (``dist.sharding.NamedSharding``s by key): each leaf becomes a
    ``DTensor`` on its sharding's mesh, moved to the mesh's device."""
    from ..dist.sharding import shard
    out = {}
    for k, v in batch.items():
        ns = shardings[k]
        t = torch.as_tensor(np.asarray(v)).to(ns.mesh.device_type)
        out[k] = shard(t, ns)
    return out
