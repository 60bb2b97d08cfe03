"""The litmus suite's sharded-directory lane on the port's directory: the
twin of ``tests/test_litmus.py:454-492``.  The classic litmus programs
(SB, MP, LB, IRIW, CoRR) run every interleaving with X and Y on DIFFERENT
owner shards of the port's ``ShardedLeaseDirectory`` (every core its own
host) and must produce bit-for-bit the outcomes, tables and timestamps of
the JAX package's single-engine oracle, never the forbidden outcome, with
at most one request/response per op and zero multicast or invalidation
messages -- on the port's ``"numpy"`` directory, its ``"device"`` one on
the CPU (the kernels' plain versions), and the ``"numpy"`` one with
decode-time re-reads and timestamp-ordered page migration of a dual-stack
payload (write-behind publish + fetch-on-read).  The programs, the
interleaving runner and the oracle are the litmus suite's own."""
import numpy as np
import pytest
import torch

from repro_torch.core import ShardedLeaseDirectory
from test_litmus import (KV_POOLS, LITMUS, N_ADDR, EngineManager,
                         interleavings, run_litmus)


class ShardedManager:
    """The litmus suite's ``ShardedManager`` on the port's directory: the
    two litmus addresses on different owner shards (``owner(addr) = addr %
    2``), every core its own host, each protocol op one directory wave."""

    def __init__(self, lease: int, n_cores: int, pools: bool = False,
                 sanitize: bool = False, backend: str = "numpy"):
        self.dirx = ShardedLeaseDirectory(
            N_ADDR, 2, n_hosts=n_cores, lease=lease, backend=backend,
            kv_pools=KV_POOLS if pools else None, kv_dtype=torch.float32,
            sanitize=sanitize or None, device="cpu")
        self.pools = pools

    def port(self, ci: int) -> "_ShardPort":
        return _ShardPort(self, ci)

    def state(self):
        return self.dirx.wts.tolist(), self.dirx.rts.tolist()


class _ShardPort:
    """One core's view of the sharded directory (core index = host id)."""

    def __init__(self, mgr: ShardedManager, host: int):
        self.mgr = mgr
        self.host = host

    def read(self, addr, pts, req):
        d = self.mgr.dirx
        fetch = [addr] if (self.mgr.pools and d.home_ok(addr)) else []
        res = d.wave(self.host, pts, read_groups=[[addr]],
                     req_wts={addr: req}, fetch_bids=fetch)
        assert res.shards_contacted <= 1 and res.msgs <= 2, res
        w, r = res.leases[addr]
        if addr in res.fetched:    # the migrated page serves that version
            page = res.fetched[addr]
            assert (page.wts, page.rts) == (w, r)
            for name, arr in page.blocks.items():
                assert isinstance(arr, torch.Tensor)
                assert bool((arr == w).all()), (addr, name, w, arr)
        return w, r, int(res.new_pts)

    def write(self, addr, pts):
        d = self.mgr.dirx
        res = d.wave(self.host, pts, write_bids=[addr],
                     tag_writes_with_ts=True)
        assert res.shards_contacted <= 1 and res.msgs <= 2, res
        ts = res.write_ts[addr]
        if self.mgr.pools:         # write-behind: payload rides a flush
            d.defer_publish(self.host, addr,
                            {n: torch.full((1,) + s, float(ts))
                             for n, s in KV_POOLS.items()}, tag=ts)
            d.flush_deferred(self.host)
        return ts


@pytest.mark.parametrize("shape", sorted(LITMUS))
@pytest.mark.parametrize("backend,lease,decode_reads,pools",
                         [("numpy", 4, 0, False),
                          ("device", 4, 0, False),
                          ("numpy", 4, 1, True)])
def test_litmus_sharded_directory_matches_single_host_oracle(
        shape, backend, lease, decode_reads, pools):
    progs, forbidden = LITMUS[shape]
    n_cores = len(progs)
    for schedule in interleavings(progs):
        mgr = ShardedManager(lease, n_cores, pools=pools,
                             sanitize=pools, backend=backend)
        res = run_litmus(progs, schedule, lambda: mgr, decode_reads)
        oracle = run_litmus(
            progs, schedule,
            lambda: EngineManager("numpy", lease), decode_reads)
        assert res == oracle, (shape, schedule)
        regs = res[0]
        assert not forbidden(regs), (shape, schedule, regs)
        d = mgr.dirx
        assert d.stats.multicasts == 0
        assert d.stats.invalidation_msgs == 0
        assert d.max_msgs_per_wave() <= 2    # one shard touched per op
        if pools:
            assert d.stats.publishes > 0
            assert d.stats.migrations > 0
            assert d.sanitize_checks > 0
        assert np.array_equal(d.wts, np.asarray(oracle[3][0], np.int32))
