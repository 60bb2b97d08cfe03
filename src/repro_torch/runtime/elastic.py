"""Elastic data-parallel training with Tardis-leased parameters (the port of
``repro.runtime.elastic``, over the port's :mod:`repro_torch.core.store`).

The learner publishes parameter versions into a TardisStore; each worker
computes gradients against its *leased* copy.  Because a publish jumps
ahead of outstanding leases instead of broadcasting, workers that are
mid-step keep a consistent (slightly stale) version and renew at their
next step: bounded logical staleness, with the global order of versions
explicit in the timestamps.  Joining is a first acquire (full payload);
leaving is no protocol action at all.  ``adamw.update`` returns new
tensors, so a version a worker still holds is never changed under it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List

from ..core.store import Replica, TardisStore
from ..optim import adamw
from ..tree import leaves, tree_map


@dataclasses.dataclass
class ElasticReport:
    steps: int
    losses: List[float]
    versions_used: List[int]
    max_staleness: int
    renewals: int
    data_less: int
    joins: int
    leaves: int
    # on-wire traffic incl. metadata headers (protocol.MESSAGE_FLITS)
    wire_flits: int = 0
    wire_bytes: int = 0
    payload_bytes: int = 0


class ElasticWorker:
    def __init__(self, store: TardisStore, name: str, grad_fn,
                 selfinc_period: int = 1):
        self.reader = Replica(store, name, selfinc_period=selfinc_period)
        self.grad_fn = grad_fn

    def step(self, batch):
        params = self.reader.read("params")
        wts = self.reader.cached_version("params")
        loss, grads = self.grad_fn(params, batch)
        return loss, grads, wts


class ElasticTrainer:
    """Learner + dynamic worker pool (cooperative simulation of a fleet)."""

    def __init__(self, params, grad_fn, make_batch, *, lease: int = 2,
                 lr: float = 1e-2):
        self.store = TardisStore(lease=lease)
        self.pub = Replica(self.store, "learner")
        self.nbytes = sum(x.numel() * x.element_size()
                          for x in leaves(params))
        self.pub.write("params", params, nbytes=self.nbytes)
        self.params = params
        self.opt = adamw.init(params)
        self.grad_fn = grad_fn
        self.make_batch = make_batch
        self.lr = lr
        self.workers: List[ElasticWorker] = []
        self._wid = 0
        self.joins = 0
        self.leaves = 0

    def scale_to(self, n: int):
        while len(self.workers) < n:
            self.workers.append(ElasticWorker(
                self.store, f"w{self._wid}", self.grad_fn))
            self._wid += 1
            self.joins += 1
        while len(self.workers) > n:
            self.workers.pop()            # no protocol action on leave
            self.leaves += 1

    def run(self, steps: int,
            schedule: Callable[[int], int] = lambda s: 2) -> ElasticReport:
        losses, versions = [], []
        max_stale = 0
        for s in range(steps):
            self.scale_to(max(1, schedule(s)))
            grad_sum = None
            cur_wts = self.store.versions()["params"]
            for i, w in enumerate(self.workers):
                loss, grads, wts = w.step(self.make_batch(s, i))
                versions.append(wts)
                max_stale = max(max_stale, cur_wts - wts)
                g32 = tree_map(lambda g: g.float(), grads)
                grad_sum = g32 if grad_sum is None else tree_map(
                    lambda a, b: a + b, grad_sum, g32)
                losses.append(float(loss))
            grads = tree_map(lambda g: g / len(self.workers), grad_sum)
            self.params, self.opt, _ = adamw.update(
                self.params, grads, self.opt, lr=self.lr, weight_decay=0.0)
            self.pub.write("params", self.params, nbytes=self.nbytes)
        st = self.store.stats
        return ElasticReport(
            steps=steps, losses=losses, versions_used=versions,
            max_staleness=max_stale, renewals=st.renews,
            data_less=st.renew_data_less, joins=self.joins,
            leaves=self.leaves, wire_flits=st.flits,
            wire_bytes=st.wire_bytes, payload_bytes=st.bytes_transferred)
