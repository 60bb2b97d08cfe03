"""The port's tracer (``repro_torch.obs``) on the paged serving path, on
the tiny paged configuration the serving tests build: off it records and
allocates nothing; on, its spans nest under their causes, its emissions
add up to every request's output, its ``host.syncs`` follow the site list
(PERF.md §3) and nothing served changes.  The card lane holds the sites
to what CUDA's own sync check reports.  This file imports no JAX."""
import functools
import time
import warnings
from collections import deque

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_arch, reduced
from repro_torch.core import CoherencePolicy
from repro_torch.models import init_params
from repro_torch.runtime import Request, ServingCluster


@functools.lru_cache(maxsize=None)
def _arch(dtype=torch.float32):
    cfg = reduced(get_arch("tinyllama-1.1b"), n_layers=2, d_model=64,
                  vocab=128)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), dtype)


def _prompts(seed, vocab, n):
    """Shared system prompts, random suffixes, staggered decode budgets
    (as ``test_torch_serving._prompts``, with longer answers)."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, vocab, 4 * int(rng.integers(1, 4)))
                .astype(np.int32) for _ in range(2)]
    out = []
    for _ in range(n):
        p = prefixes[int(rng.integers(0, 2))]
        suffix = rng.integers(1, vocab, int(rng.integers(1, 9))) \
            .astype(np.int32)
        out.append((np.concatenate([p, suffix]), int(rng.integers(1, 7))))
    return out


def _cluster(device="cpu", dtype=torch.float32, **kw):
    """Two replicas over a small pool; a lease of 2 renews in decode and a
    small content region evicts."""
    cfg, params = _arch(dtype)
    for k, v in dict(prefix_block_tokens=4, n_prefix_blocks=6,
                     n_decode_pages=64, max_pages=16, n_replicas=2,
                     max_batch=3).items():
        kw.setdefault(k, v)
    return ServingCluster(cfg, lambda: params,
                          policy=CoherencePolicy(lease=2), device=device,
                          sanitize=False, **kw)


def _serve(traced, seed=3, n=12):
    """One run of ``n`` requests; the tracer on for it when ``traced``.
    Returns (requests, coherence_report, the trace hook, the export)."""
    cl = _cluster()
    cl.trace = []
    reqs = [Request(i, p, max_new=m)
            for i, (p, m) in enumerate(_prompts(seed, cl.cfg.vocab, n))]
    obs.reset()
    if traced:
        obs.enable()
    try:
        _, rep = cl.run(reqs)
    finally:
        obs.disable()
    return reqs, dict(rep), cl.trace, obs.export()


@pytest.fixture(autouse=True)
def _tracer_off():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@functools.lru_cache(maxsize=None)
def _traced():
    return _serve(True)


def _spans(ex):
    s = ex["spans"]
    return [dict(zip(s, row)) | {"id": i}
            for i, row in enumerate(zip(*s.values()))]


def test_off_records_nothing_and_allocates_no_span(monkeypatch):
    assert obs.span("tick") is obs.NOOP
    assert obs.span("host.sync", "decode.tokens", 1) is obs.NOOP

    def no_span(*a):
        raise AssertionError("a span object was allocated with tracing off")
    monkeypatch.setattr(obs, "_Span", no_span)
    reqs, *_, ex = _serve(False)
    assert all(r.done for r in reqs)
    assert ex["spans"]["name"] == [] and ex["counters"] == {}
    assert ex["emits"] == [] and ex["events"] == {}
    assert obs.to_host(torch.arange(3), "x").tolist() == [0, 1, 2]


# the span each span (or each host.sync site) nests in
PARENTS = {
    "tick": {None}, "sched.admit": {"tick"}, "decode.step": {"tick"},
    "lease.wave": {"sched.admit"}, "model.prefill": {"sched.admit"},
    "model.prefill_suffix": {"sched.admit"}, "pool.read": {"sched.admit"},
    "pool.write_back": {"sched.admit"}, "pool.append": {"sched.admit"},
    "decode.renew": {"decode.step"}, "decode.prep": {"decode.step"},
    "decode.forward": {"decode.step"}, "decode.finish": {"decode.step"},
    "lease.read_many": {"lease.wave", "decode.renew"},
    "lease.write_many": {"lease.wave"},
}
SITE_PARENTS = {
    "admit.tokens": {"sched.admit"}, "admit.first_token": {"sched.admit"},
    "decode.page_rows": {"decode.prep"}, "decode.lengths": {"decode.prep"},
    "decode.tokens_in": {"decode.prep"}, "decode.tokens": {"decode.step"},
    "rebase.max_ts": {"tick"}, "lease.write.mask": {"lease.write_many"},
    "lease.write.ts": {"lease.write_many"},
    # an eviction relocates a pinned block inside the lease wave
    "gather_blocks.ids": {"pool.read", "lease.wave"},
    "append_rows.ids": {"pool.write_back", "pool.append", "lease.wave"},
    "lease_check.pts": {"lease.read_many"},
}


def test_spans_nest_under_their_causes():
    _reqs, _rep, _trace, ex = _traced()
    spans = _spans(ex)
    assert spans and all(s["t1"] >= s["t0"] > 0 for s in spans)
    names = {s["name"] for s in spans}
    assert set(PARENTS) | {"host.sync"} == names
    for s in spans:
        up = spans[s["parent"]] if s["parent"] >= 0 else None
        if s["name"] == "host.sync":
            site = s["attrs"][0]
            want = (SITE_PARENTS.get(site) if not site.startswith(
                "lease.read_many.") else {"lease.read_many"})
        else:
            want = PARENTS[s["name"]]
        assert (up and up["name"]) in want, (s, up)
        if up is not None:
            assert up["t0"] <= s["t0"] <= s["t1"] <= up["t1"]
            assert up["id"] < s["id"]
    assert all(s["attrs"] == [] for s in spans if s["name"] != "host.sync")
    assert any(s["name"] == "model.prefill_suffix" for s in spans)


def test_emissions_add_up_to_each_output():
    reqs, _rep, _trace, ex = _traced()
    got = {}
    last = {}
    for rid, t, n in ex["emits"]:
        got[rid] = got.get(rid, 0) + n
        assert t >= last.get(rid, 0)
        last[rid] = t
    assert got == {r.rid: len(r.output) for r in reqs}
    admitted = dict(ex["events"]["sched.admitted"])
    assert set(admitted) == set(got)
    first = {}
    for rid, t, _n in ex["emits"]:
        first.setdefault(rid, t)
    assert all(admitted[rid] <= first[rid] for rid in got)


# the sites that copy to the host (the rest copy host data to the device)
TO_HOST_SITES = {"decode.tokens", "rebase.max_ts", "admit.first_token",
                 "lease.write.ts"} | {
    f"lease.read_many.{k}" for k in ("expired", "renew_ok", "wts", "rts",
                                     "new_pts")}


def test_host_syncs_follow_the_site_list():
    """Each site's count as the site list predicts it from the spans."""
    _reqs, rep, _trace, ex = _traced()
    names = {}
    for s in _spans(ex):
        names[s["name"]] = names.get(s["name"], 0) + 1
    reloc = rep["pinned_relocations"]
    assert reloc > 0
    want = {"rebase.max_ts": names["tick"],
            "admit.tokens": names["model.prefill"]
            + names["model.prefill_suffix"],
            "admit.first_token": names["model.prefill"]
            + names["model.prefill_suffix"],
            "append_rows.ids": names["pool.append"]
            + names["pool.write_back"] + reloc,
            "gather_blocks.ids": names["pool.read"] + reloc,
            "lease_check.pts": names["lease.read_many"],
            "lease.write.mask": names["lease.write_many"],
            "lease.write.ts": names["lease.write_many"]}
    for site in ("page_rows", "lengths", "tokens_in", "tokens"):
        want[f"decode.{site}"] = names["decode.step"]
    for site in ("req", "masks", "ids", "expired", "renew_ok", "wts", "rts",
                 "new_pts"):
        want[f"lease.read_many.{site}"] = names["lease.read_many"]
    assert ex["counters"] == {"host.syncs": want}
    assert sum(want.values()) == names["host.sync"]
    to_host = {s["attrs"][0]: s["attrs"][1] for s in _spans(ex)
               if s["name"] == "host.sync"}
    assert {k for k, v in to_host.items() if v} == TO_HOST_SITES


def test_tracing_changes_no_result():
    """Outputs, ``coherence_report()`` and the ``trace`` debug hook are the
    same with the tracer on and off."""
    off = _serve(False)
    on = _traced()
    for a, b in zip(off[0], on[0]):
        assert a.rid == b.rid and a.done and b.done
        np.testing.assert_array_equal(a.output, b.output)
    assert off[1] == on[1]
    assert len(off[2]) == len(on[2]) > 0
    for a, b in zip(off[2], on[2]):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert torch.equal(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k])


def test_anchors_map_spans_onto_realtime():
    obs.enable()
    before = time.time_ns()
    with obs.span("tick"):
        time.sleep(0.002)
    after = time.time_ns()
    obs.disable()
    ex = obs.export()
    assert len(ex["anchors"]) == 2
    to_real = obs.realtime(ex)
    t0, t1 = ex["spans"]["t0"][0], ex["spans"]["t1"][0]
    assert before - 1e6 <= to_real(t0) <= to_real(t1) <= after + 1e6
    assert abs((to_real(t1) - to_real(t0)) - (t1 - t0)) < 1e5


# --- card lane: no host sync on the paged path escapes the helpers --------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_every_sync_on_the_paged_path_is_counted(cuda):
    """Ticks with admissions (cold and suffix prefills, write-backs, an
    eviction) and decode renewals, under CUDA's sync check: every
    synchronising call it reports is one ``host.syncs``."""
    cl = _cluster(device=cuda, dtype=torch.bfloat16)
    prompts = _prompts(5, cl.cfg.vocab, 16)
    queues = [deque() for _ in cl.replicas]
    for i, (p, m) in enumerate(prompts[:6]):           # warm: builds, caches
        queues[i % 2].append(Request(i, p, max_new=m))
    for tick in range(4):
        cl._paged_tick(queues, tick)
    torch.cuda.synchronize()
    for i, (p, m) in enumerate(prompts[6:], start=6):
        queues[i % 2].append(Request(i, p, max_new=m))
    obs.enable()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            for tick in range(4, 10):
                cl._paged_tick(queues, tick)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        obs.disable()
    syncs = [w for w in seen if "synchronizing" in str(w.message)]
    counted = obs.export()["counters"]["host.syncs"]
    where = sorted({f"{w.filename}:{w.lineno}" for w in syncs})
    assert len(syncs) == sum(counted.values()), (counted, where)
    assert counted["decode.tokens"] > 0 and counted["admit.first_token"] > 0
