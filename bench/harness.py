"""One run of one cell: set-up, the measured window, its device trace and
the check against the plain reference.

The system under test is the port's paged serving cluster
(``repro_torch.runtime.serve_loop.ServingCluster``: replicas over one
shared ``LeaseEngine`` pool on the card, bf16 weights and pool).  The
window drives its scheduler tick, ``ServingCluster._paged_tick(queues,
tick)``, with the harness's own per-replica queues; a tick ends in the
decode step's host copy of the argmax, so the host clock after a tick is
when its tokens exist.

Everything that belongs to one configuration, mix or metric is a file the
harness finds by name: ``configs/<config>.json``, ``mixes/<mix>.json``,
``metrics/<metric>.py`` and ``checks/<cell>.json`` (the limits of the
comparison).
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import flops
import judge
import stats
import traffic
import weights as bench_weights

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_config(name: str) -> Dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def load_check(cell: str) -> Dict:
    return load_json(BENCH / "checks" / f"{cell}.json")


def metric_reader(name: str) -> Callable[[Dict], Optional[float]]:
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: the
    process's ``sys.modules``), each compared whole."""
    tops = {name.split(".")[0] for name in list(modules or sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def port_arch(conf: Dict):
    """The port's configuration the file names, held to its ``run``
    block."""
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(conf["port_arch"])
    run = conf["run"]
    got = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.head_dim(), "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "rope_theta": cfg.rope_theta, "norm_eps": cfg.norm_eps,
           "family": cfg.family, "tie_embeddings": cfg.tie_embeddings}
    diff = {k: (v, run[k]) for k, v in got.items() if run[k] != v}
    if diff:
        raise ValueError(f"{conf['port_arch']}: the port runs {diff} "
                         f"(port, file)")
    return cfg


@dataclasses.dataclass
class Track:
    """One request from its send to its last token."""
    req: Any
    client: int
    sent: float
    times: List[float]
    done_at: Optional[float] = None
    skipped: Optional[int] = None   # prompt tokens served from leased blocks


class Driver:
    """Closed-loop clients over the cluster's scheduler tick."""

    def __init__(self, cluster, loop: traffic.ClosedLoop, replicas: int,
                 now: Callable[[], float]):
        from repro_torch.runtime import Request
        self._request = Request
        self.cluster = cluster
        self.loop = loop
        self.replicas = replicas
        self.now = now
        self.queues = [deque() for _ in range(replicas)]
        self.tick_no = 0
        self.tracks: List[Track] = []
        self.inflight: Dict[int, Track] = {}
        self.tick_ends: List[float] = []
        self.tick_tokens: List[int] = []
        self.block_tokens = cluster.prefix_block_tokens

    def _send(self, s: traffic.Send, t: float) -> None:
        req = self._request(len(self.tracks), s.prompt, max_new=s.max_new)
        tr = Track(req, s.client, t, [])
        self.tracks.append(tr)
        self.inflight[req.rid] = tr
        self.queues[s.client % self.replicas].append(req)

    def start(self) -> None:
        t = self.now()
        for c in self.loop.start_order:
            self._send(self.loop.first(int(c)), t)

    def tick(self) -> float:
        self.cluster._paged_tick(self.queues, self.tick_no)
        self.tick_no += 1
        t = self.now()
        streams = {s.req.rid: s for act in self.cluster._active for s in act}
        finished, new = [], 0
        for rid, tr in list(self.inflight.items()):
            s = streams.get(rid)
            if s is not None:
                n = len(s.emitted)
                if tr.skipped is None:       # its admission's covered run
                    tr.skipped = self.block_tokens * (len(s.shared_bids)
                                                      + len(s.reloc_pages))
            elif tr.req.done:
                n = len(tr.req.output)
            else:
                continue                      # still queued
            new += n - len(tr.times)
            tr.times.extend([t] * (n - len(tr.times)))
            if tr.req.done:
                tr.done_at = t
                del self.inflight[rid]
                finished.append(tr)
        for tr in sorted(finished, key=lambda x: x.client):
            self._send(self.loop.next(tr.client, tr.req.output), t)
        self.tick_ends.append(t)
        self.tick_tokens.append(new)
        return t


class Spans:
    """Host spans around the calls into each layer, on the cluster's own
    instances (the traced run only).  Durations on the monotonic clock;
    start and end also on the realtime clock, the profiler's, for labelling
    the device's idle gaps."""

    def __init__(self, cluster, now):
        from repro_torch.runtime import serve_loop
        self.now = now
        self.admits: List = []         # (seconds, requests admitted)
        self.decodes: List = []        # (seconds, stream lengths)
        self.lease: List[float] = []   # read_many / write_many seconds
        self.prefills: List = []       # (computed, skipped, n_q, n_kv)
        self.timeline: List = []       # (label, t0_ns, t1_ns)
        self._undo: List = []
        eng = cluster.prefix_engine
        self._wrap(cluster, "_admit", self._on_admit)
        self._wrap(cluster, "_decode_tick", self._on_decode)
        self._wrap(eng, "read_many", self._on_lease)
        self._wrap(eng, "write_many", self._on_lease)
        self._wrap(serve_loop, "prefill", self._on_prefill, module=True)
        self._wrap(serve_loop, "prefill_suffix", self._on_suffix,
                   module=True)

    def _wrap(self, obj, name, hook, module=False):
        inner = getattr(obj, name)

        def wrapped(*a, **k):
            return hook(inner, *a, **k)
        setattr(obj, name, wrapped)
        self._undo.append((obj, name, inner, module))

    def close(self) -> None:
        for obj, name, inner, module in reversed(self._undo):
            if module:
                setattr(obj, name, inner)
            else:
                delattr(obj, name)
        self._undo = []

    def _timed(self, label, fn, *a, **k):
        t0, n0 = self.now(), time.time_ns()
        out = fn(*a, **k)
        t1, n1 = self.now(), time.time_ns()
        self.timeline.append((label, n0, n1))
        return out, t1 - t0

    def _on_admit(self, inner, r, rep, queue, act, tick):
        before = len(queue)
        _, dt = self._timed("admit", inner, r, rep, queue, act, tick)
        self.admits.append((dt, before - len(queue)))

    def _on_decode(self, inner, rep, act, tick):
        lengths = [s.length for s in act]
        _, dt = self._timed("decode_tick", inner, rep, act, tick)
        self.decodes.append((dt, lengths))

    def _on_lease(self, inner, *a, **k):
        out, dt = self._timed("lease", inner, *a, **k)
        self.lease.append(dt)
        return out

    def _on_prefill(self, inner, cfg, params, batch, cache_len, *a, **k):
        n_q = int(batch["tokens"].shape[1])
        last = k.get("last_idx")
        computed = n_q if last is None else int(last) + 1
        self.prefills.append((computed, 0, n_q, n_q))
        out, _ = self._timed("prefill", inner, cfg, params, batch,
                             cache_len, *a, **k)
        return out

    def _on_suffix(self, inner, cfg, params, batch, cache, prefix_len, *a,
                   **k):
        n_q = int(batch["tokens"].shape[1])
        last = k.get("last_idx")
        computed = n_q if last is None else int(last) + 1
        self.prefills.append((computed, int(prefix_len), n_q,
                              int(prefix_len) + n_q))
        out, _ = self._timed("prefill", inner, cfg, params, batch, cache,
                             prefix_len, *a, **k)
        return out


def _union_busy(intervals: List) -> float:
    busy, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def read_profile(prof, t0_ns: int, t1_ns: int, timeline: List) -> Dict:
    """Device activity of the profiled window, summed straight from the
    profiler's events (``key_averages`` builds a tree of every event, far
    too slow for 10^5 kernels): busy seconds as the union of the device's
    intervals, seconds by kernel name, and idle time by the host span open
    at each gap's midpoint."""
    from torch.autograd import DeviceType
    iv, by_name, calls = [], {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_async():
            continue
        a, b = e.start_ns(), e.end_ns()
        iv.append((a, b))
        by_name[e.name()] = by_name.get(e.name(), 0) + (b - a)
        calls[e.name()] = calls.get(e.name(), 0) + 1
    iv.sort()
    in_slice = sum(1 for a, _ in iv if t0_ns - 1e9 <= a <= t1_ns + 1e9)
    aligned = bool(iv) and in_slice >= 0.9 * len(iv)
    gaps: Dict[str, int] = {}
    spans = sorted(timeline, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    prev_end = t0_ns
    for a, b in iv + [(t1_ns, t1_ns)]:
        if a > prev_end:
            label = "unaligned"
            if aligned:
                mid = (a + prev_end) // 2
                label = "between_ticks"
                i = bisect.bisect_right(starts, mid)
                # the innermost span open at mid: the latest start before it
                for j in range(i - 1, max(-1, i - 64), -1):
                    lab, s0, s1 = spans[j]
                    if s0 <= mid <= s1:
                        label = lab
                        break
            gaps[label] = gaps.get(label, 0) + (a - prev_end)
        prev_end = max(prev_end, b)
    return {"slice_s": (t1_ns - t0_ns) / 1e9,
            "busy_s": _union_busy(iv) / 1e9,
            "kernels_s": {k: v / 1e9 for k, v in by_name.items()},
            "kernel_calls": calls,
            "idle_by_span_s": {k: v / 1e9 for k, v in gaps.items()},
            "events": len(iv), "aligned": aligned}


def _kernel_seconds(prof: Dict, key: str) -> float:
    return sum(v for k, v in prof["kernels_s"].items() if key in k)


def _kernel_calls(prof: Dict, key: str) -> int:
    return sum(v for k, v in prof["kernel_calls"].items() if key in k)


class WindowProfile:
    """``torch.profiler`` on the card's activity over the whole traced
    window, from its first tick to its last, between device
    synchronisations, with the spans' records of the same ticks.  CUPTI is
    started once in set-up (``warm``), so the start costs the window
    little; the events are read after the window has closed.  The K4 and
    K6 launches the trace holds are counted beside those the spans made,
    so a trace that lost events shows."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.mark: List = []

    @staticmethod
    def warm() -> None:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            (torch.ones(8, device="cuda") * 2).sum().item()

    def _marks(self):
        return (time.time_ns(), len(self.spans.decodes),
                len(self.spans.prefills))

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        self.prof.start()
        self.mark = [self._marks()]

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.mark.append(self._marks())
        self.prof.stop()

    def read(self, run: Dict) -> Optional[Dict]:
        if len(self.mark) != 2:
            return None
        (n0, d0, p0), (n1, d1, p1) = self.mark
        pr = read_profile(self.prof, n0, n1, self.spans.timeline)
        self.prof = None
        k4 = [flops.k4_work(run, ls) for _, ls in self.spans.decodes[d0:d1]]
        k6 = [flops.k6_work(run, nq, off, nkv)
              for _c, off, nq, nkv in self.spans.prefills[p0:p1]]
        n = run["n_layers"]         # each call below runs once a layer
        pr["k4_work"] = [n * sum(x[0] for x in k4), n * sum(x[1] for x in k4)]
        pr["k6_work"] = [n * sum(x[0] for x in k6), n * sum(x[1] for x in k6)]
        pr["k4_s"] = _kernel_seconds(pr, "paged_decode")
        pr["k6_s"] = _kernel_seconds(pr, "flash_prefill")
        pr["k4_calls"], pr["k6_calls"] = n * len(k4), n * len(k6)
        pr["k4_events"] = _kernel_calls(pr, "paged_decode")
        pr["k6_events"] = _kernel_calls(pr, "flash_prefill")
        return pr


def content_occupancy(cluster) -> float:
    """Share of the pool's content-addressed blocks that hold a prefix
    block's KV (tagged and valid)."""
    n = cluster.n_prefix_blocks
    held = (cluster._tags[:n] != -1) & cluster.prefix_engine._kv_valid[:n]
    return float(held.sum()) / n


@dataclasses.dataclass
class Served:
    """A run's window, with what the check and the result line need."""
    cuda: bool
    run: Dict
    weights: Dict
    finished: List[Track]
    attempted: int
    failed: int
    rec: Dict
    peak: int
    window: Dict


def serve(cell: str, seed: int, seconds: float, trace: bool, *,
          device: str = "cuda", t_start: Optional[float] = None,
          bench: Optional[Dict] = None, conf: Optional[Dict] = None,
          mix: Optional[Dict] = None, log=None) -> Served:
    """Set-up and the measured window of one run of ``cell``; the
    program's state is freed before it returns.  ``bench``, ``conf`` and
    ``mix`` default to the files the names give (tests pass small ones)."""
    now = time.perf_counter
    if t_start is None:
        t_start = now()
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = bench or load_benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    conf = conf or load_config(entry["config"])
    mix = mix or traffic.load_mix(entry["traffic"])
    cuda = device.startswith("cuda")
    cfg = port_arch(conf)
    run, srv = conf["run"], conf["serving"]

    from repro_torch.runtime import ServingCluster
    w = bench_weights.draw(run, seed, device)
    params = bench_weights.port_params(w)
    cluster = ServingCluster(
        cfg, lambda: params, n_replicas=srv["replicas"],
        n_prefix_blocks=srv["n_prefix_blocks"],
        prefix_block_tokens=srv["block_tokens"],
        n_decode_pages=srv["n_decode_pages"], max_pages=srv["max_pages"],
        sanitize=False, device=device, max_batch=srv["max_batch"])
    clients = srv["replicas"] * srv["max_batch"]
    loop = traffic.ClosedLoop(mix, seed, clients, cfg.vocab)
    drv = Driver(cluster, loop, srv["replicas"], now)
    if trace and cuda:
        WindowProfile.warm()
    drv.start()
    for _ in range(int(mix["warmup_ticks"])):
        drv.tick()
    t0 = drv.tick_ends[-1] if drv.tick_ends else now()
    setup_s = t0 - t_start
    first_tick = drv.tick_no
    rep0 = dict(cluster.coherence_report())
    occ0 = content_occupancy(cluster)
    log(f"set-up {setup_s:.3f} s ({first_tick} warm-up ticks); window "
        f"{seconds} s")

    spans = Spans(cluster, now) if trace else None
    sl = WindowProfile(spans) if trace and cuda else None
    if sl is not None:
        sl.start()
    while True:
        t = drv.tick()
        if t - t0 >= seconds:
            break
    t_end = drv.tick_ends[-1]
    if sl is not None:
        sl.stop()
    if spans is not None:
        spans.close()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_loaded()
    if found:
        raise RuntimeError(f"modules loaded in the run's process: {found}")

    rec = window_record(drv, cluster, rep0, first_tick, t0, t_end, setup_s,
                        run, srv)
    if spans is not None:
        rec["spans"] = spans_record(spans)
    if sl is not None:
        rec["profile"] = sl.read(run)
    finished = [tr for tr in drv.tracks
                if tr.done_at is not None and t0 < tr.done_at <= t_end]
    failed = sum(1 for tr in finished
                 if len(tr.req.output) != tr.req.max_new
                 or not all(0 <= int(x) < cfg.vocab for x in tr.req.output))
    window = {"seconds": t_end - t0, "ticks": rec["ticks"],
              "tokens": rec["tokens"], "requests_finished": len(finished),
              "pool_bytes": cluster.prefix_engine._kv_pool.nbytes,
              "weight_bytes": bench_weights.nbytes(w),
              "content_blocks": cluster.n_prefix_blocks,
              "content_occupancy": [occ0, content_occupancy(cluster)],
              "coherence": {k: rec["coherence"].get(k) for k in (
                  "prefix_block_hits", "prefix_block_misses",
                  "prefix_evictions", "pinned_relocations",
                  "paged_admission_deferrals",
                  "prefix_prefill_tokens_skipped")}}
    served = Served(cuda, run, w, finished,
                    sum(1 for tr in drv.tracks if t0 <= tr.sent < t_end),
                    failed, rec, int(peak), window)
    # the program's state goes before the reference runs
    del cluster, drv, params, sl, spans
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return served


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             check: Optional[Dict] = None, log=None, **kw) -> Dict:
    """One run of ``cell``: the result line's object (``checks`` last)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = kw.get("bench") or load_benchmark()
    kw["bench"] = bench
    sv = serve(cell, seed, seconds, trace, log=log, **kw)
    check = check or load_check(cell)
    sample = judge.sample(sv.finished, seed)
    t_ref = time.perf_counter()
    verdict = judge.judge(sv.run, sv.weights, sample, check,
                          kw.get("device", "cuda"),
                          suffix_due=int(any(tr.skipped
                                             for tr in sv.finished)))
    log(f"reference over {len(sample)} requests "
        f"({verdict['served_tokens']} served tokens) in "
        f"{time.perf_counter() - t_ref:.3f} s")
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        v = metric_reader(m["name"])(sv.rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if sv.cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if sv.cuda else "cpu",
           "count": 1, "memory_peak_bytes": sv.peak}
    out = {"correct": bool(verdict["correct"] and sv.failed == 0
                           and sv.finished),
           "attempted": sv.attempted, "failed": sv.failed,
           "metrics": metrics, "device": dev}
    pr = sv.rec.get("profile")
    if pr:
        dev.update(busy_s=pr["busy_s"], window_s=pr["slice_s"])
        out["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in pr["kernels_s"].items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in
                                 pr["idle_by_span_s"].items()),
                                key=lambda kv: -kv[1])[:10]}
        sv.window["profile"] = {k: pr[k] for k in (
            "events", "aligned", "k4_s", "k6_s", "k4_work", "k6_work",
            "k4_calls", "k6_calls", "k4_events", "k6_events")}
    out["window"] = sv.window
    out["checks"] = verdict["checks"]
    return out


def window_record(drv: Driver, cluster, rep0: Dict, first_tick: int,
                  t0: float, t_end: float, setup_s: float, run: Dict,
                  srv: Dict) -> Dict:
    """What the metric readers read: the window's latencies, tokens and
    the coherence counters' deltas."""
    rep1 = cluster.coherence_report()
    delta = {k: rep1[k] - rep0.get(k, 0) for k, v in rep1.items()
             if isinstance(v, (int, float, np.integer))
             and not isinstance(v, bool)}
    ends = drv.tick_ends[first_tick:]
    tokens = sum(drv.tick_tokens[first_tick:])
    ttft = stats.ttft_samples(
        ((tr.sent, tr.times[0] if tr.times else None) for tr in drv.tracks),
        t0, t_end)
    itl = stats.itl_samples((tr.times for tr in drv.tracks), t0, t_end,
                            (tr.done_at is None for tr in drv.tracks))
    return {"run": run, "serving": srv, "setup_s": setup_s,
            "window_s": t_end - t0, "ticks": len(ends), "tokens": tokens,
            "ttft_s": ttft, "itl_s": itl, "coherence": delta}


def spans_record(spans: Spans) -> Dict:
    return {"admits": spans.admits, "decodes": spans.decodes,
            "lease_s": spans.lease, "prefills": spans.prefills}
