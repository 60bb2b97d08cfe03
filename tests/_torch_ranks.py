"""Run a function on N CPU ranks of a gloo process group, for the port's
multi-rank tests: spawned processes, a ``file://`` rendezvous in a fresh
temporary directory (no TCP port), every join under its own timeout, and
each rank's return value (or its traceback) handed back."""
import multiprocessing as mp
import os
import tempfile
import traceback

MAX_RANKS = 4


def _child(fn, rank, world, rdv, q, args):
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                rank=rank, world_size=world)
        try:
            q.put((rank, "ok", fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))


def run_ranks(fn, world: int, *args, timeout: float = 60.0):
    """``[fn(rank, world, *args) for each rank]`` (``fn`` importable at
    module level), each in its own process; raises if a rank fails or a
    join times out."""
    assert 1 <= world <= MAX_RANKS
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        rdv = os.path.join(d, "rendezvous")
        procs = [ctx.Process(target=_child, args=(fn, r, world, rdv, q, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        results = {}
        try:
            for _ in range(world):
                rank, status, value = q.get(timeout=timeout)
                if status != "ok":
                    raise AssertionError(f"rank {rank} failed:\n{value}")
                results[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
    return [results[r] for r in range(world)]
