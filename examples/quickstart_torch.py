"""Quickstart of the PyTorch port: the Tardis protocol end to end.

1. run the paper's Listing-1 litmus through the coherence simulator,
2. compare Tardis vs. full-map MSI on a SPLASH-2-like workload,
3. use the TardisStore to share versioned objects without invalidations.

On the card each simulation is one launch of K9, the simulator's whole
loop; ``--device cpu`` runs its plain loop instead.  The JAX package's
quickstart (``examples/quickstart.py``) also trains a tiny LM; the port
has no training loop yet, so that part is left out here.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.core import SimConfig, make_trace, simulate
from repro_torch.core.check import check_sc
from repro_torch.core.store import Replica, TardisStore
from repro_torch.core.traces import _Builder


def litmus(device):
    print("== 1. Listing-1 litmus (store A; load B || store B; load A) ==")
    b = _Builder(2)
    b.store(0, 0)
    b.load(0, 1)
    b.store(1, 1)
    b.load(1, 0)
    tr = b.build(4, "litmus")
    res = simulate(tr, "tardis", SimConfig(), log=True, device=device)
    check_sc(res.log, 2)
    loads = {(int(c), int(a)): int(v) for c, a, v, k in zip(
        res.log["core"], res.log["addr"], res.log["ver"], res.log["kind"])
        if k == 0}
    print(f"   loads observed versions: {loads}  (A=B=0 impossible)")
    print("   sequential consistency: VERIFIED\n")


def protocol_comparison(device):
    print("== 2. Tardis vs MSI on a volrend-like workload (16 cores) ==")
    tr = make_trace("volrend", 16, scale=0.5)
    msi = simulate(tr, "directory", SimConfig(), device=device)
    trd = simulate(tr, "tardis", SimConfig(), device=device)
    print(f"   MSI   : {msi.cycles} cycles, traffic {msi.traffic:.0f}")
    print(f"   Tardis: {trd.cycles} cycles, traffic {trd.traffic:.0f} "
          f"({trd.stats['n_renew']:.0f} renewals, "
          f"{trd.stats['n_renew_ok']:.0f} data-less)")
    print(f"   relative throughput {msi.cycles / trd.cycles:.3f} "
          f"(paper: ~1.00), traffic x{trd.traffic / msi.traffic:.2f}\n")


def store_demo():
    print("== 3. TardisStore: invalidation-free version sharing ==")
    store = TardisStore(lease=4)
    writer = Replica(store, "trainer")
    readers = [Replica(store, f"r{i}", selfinc_period=1) for i in range(3)]
    writer.write("weights", "v1", nbytes=1 << 20)
    for r in readers:
        r.read("weights")
    writer.write("weights", "v2", nbytes=1 << 20)   # no broadcast!
    for _ in range(8):
        vals = [r.read("weights") for r in readers]
    print(f"   all readers converged to: {set(vals)}")
    s = store.stats
    print(f"   renewals={s.renews} data-less={s.renew_data_less} "
          f"payload transfers={s.payload_transfers} "
          f"(directory would have sent {s.dir_invalidations} invalidations)\n")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="default: the card (raises without one)")
    dev = ap.parse_args().device
    litmus(dev)
    protocol_comparison(dev)
    store_demo()
    print("== 4. fault-tolerant training: left out (the port has no "
          "training loop yet) ==\n")
    print("quickstart complete.")
