"""The port's own spans and counters (``repro_torch.obs``) read beside the
benchmark's records: one run of a cell with the program's tracer on over
its measured window, and the readings the tracer gives.

    python3 bench/program_trace.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout, on a card.  The run is ``bench/run.py``'s
(the same set-up, window, check and result line), with the tracer enabled
at the window's first tick and exported when the window closes, before the
cluster is freed; ``bench/run.py`` on the same seed is the run without
it.  The last line of standard output is the result line with
one more key, ``program``: the readings below (``None`` where the program
has no tracer or, for the device's, where the run was not traced), the
window's ``host.syncs`` per tick by site, its idle seconds by the program
span open at each gap of the device trace (the spans pinned to the
device's clock at each copy to the host: ``device_clock``), and the checks
that the spans cover what the harness times from outside.

Readings (the layer and the end-to-end metric each moves: PERF.md §3):

- ``decode.enqueue_ms``: host ms inside ``decode.forward`` a decode step
  (the step's kernels enqueued, nothing waited for);
- ``decode.device_ms``: device-busy ms (the union of the device's
  intervals) inside a ``decode.step`` span, mean over steps;
- ``decode.kernels_per_step``: device kernels that start inside a
  ``decode.step`` span, mean over steps;
- ``host.syncs_per_tick``: ``host.syncs`` over the window's ticks;
- ``sched.queue_wait_p95_ms``: p95 of ``sched.admitted`` less the send
  time, over the requests sent in the window (unadmitted ones to its end);
- ``ttft_p95_ms.token``, ``itl_p95_ms.token``: ``stats.ttft_samples`` /
  ``stats.itl_samples`` over the ``emit`` times, where each token became
  known on the host.
"""
from __future__ import annotations

import argparse
import bisect
import importlib
import json
import sys
import types
from typing import Callable, Dict, List, Optional

import numpy as np

import harness
import stats

# the spans a decode step is made of, directly under ``decode.step``
STEP_PARTS = ("decode.renew", "decode.prep", "decode.forward", "host.sync",
              "decode.finish")
PROGRAM_READINGS = ("decode.enqueue_ms", "decode.device_ms",
                    "decode.kernels_per_step", "host.syncs_per_tick",
                    "sched.queue_wait_p95_ms", "ttft_p95_ms.token",
                    "itl_p95_ms.token")


def load_obs():
    """The program's tracer module, or None where the program has none."""
    try:
        return importlib.import_module("repro_torch.obs")
    except ImportError:
        return None


def _spans(ex: Dict) -> List[Dict]:
    s = ex["spans"]
    return [dict(zip(s, row)) for row in zip(*s.values())]


def _children(spans: List[Dict]) -> Dict[int, List[int]]:
    kids: Dict[int, List[int]] = {}
    for i, s in enumerate(spans):
        kids.setdefault(s["parent"], []).append(i)
    return kids


def decode_enqueue_ms(ex: Dict) -> Optional[float]:
    spans = _spans(ex)
    kids = _children(spans)
    steps = [i for i, s in enumerate(spans) if s["name"] == "decode.step"]
    if not steps:
        return None
    fwd = sum(spans[k]["t1"] - spans[k]["t0"] for i in steps
              for k in kids.get(i, ()) if spans[k]["name"] == "decode.forward")
    return fwd / len(steps) / 1e6


def host_syncs_per_tick(ex: Dict) -> Optional[float]:
    ticks = ex["spans"]["name"].count("tick")
    if not ticks:
        return None
    return sum(ex["counters"].get("host.syncs", {}).values()) / ticks


def _sent_at(reqs: Dict, at: Dict):
    """(sent, at[rid] in seconds or None) of every request; ``at`` in ns."""
    return ((sent, at[rid] / 1e9 if rid in at else None)
            for rid, (sent, _done) in reqs.items())


def queue_wait_p95_ms(ex: Dict, reqs: Dict, t0: float,
                      t_end: float) -> Optional[float]:
    adm = {rid: t for rid, t in ex["events"].get("sched.admitted", ())}
    xs = stats.ttft_samples(_sent_at(reqs, adm), t0, t_end)
    return 1e3 * stats.percentile(xs, 95) if xs else None


def _token_times(ex: Dict) -> Dict[int, List[float]]:
    times: Dict[int, List[float]] = {}
    for rid, t, n in ex["emits"]:
        times.setdefault(rid, []).extend([t / 1e9] * n)
    return times


def ttft_p95_ms_token(ex: Dict, reqs: Dict, t0: float,
                      t_end: float) -> Optional[float]:
    first = {rid: ts[0] * 1e9 for rid, ts in _token_times(ex).items()}
    xs = stats.ttft_samples(_sent_at(reqs, first), t0, t_end)
    return 1e3 * stats.percentile(xs, 95) if xs else None


def itl_p95_ms_token(ex: Dict, reqs: Dict, t0: float,
                     t_end: float) -> Optional[float]:
    times = _token_times(ex)
    rids = list(reqs)
    xs = stats.itl_samples((times.get(rid, []) for rid in rids), t0, t_end,
                           (reqs[rid][1] is None for rid in rids))
    return 1e3 * stats.percentile(xs, 95) if xs else None


class _Event(tuple):
    """A device event read once from the profile, ``(start, end, name)``,
    with the accessors ``harness.read_profile`` calls on kineto's."""
    __slots__ = ()
    cuda = None                     # DeviceType.CUDA, set by device_events

    def device_type(self):
        return self.cuda

    def is_async(self) -> bool:
        return False

    def start_ns(self) -> int:
        return self[0]

    def end_ns(self) -> int:
        return self[1]

    def name(self) -> str:
        return self[2]


def device_events(prof) -> List[_Event]:
    """The card's events in a profile, sorted, as ``harness.read_profile``
    selects them: the one walk over the profiler's events."""
    from torch.autograd import DeviceType
    cuda = _Event.cuda = DeviceType.CUDA
    evs = [_Event((e.start_ns(), e.end_ns(), e.name()))
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda and not e.is_async()]
    evs.sort()
    return evs


def _read_events(events: List[_Event]):
    """A stand-in for a profile whose events are ``events``."""
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def device_clock(iv, spans: List[Dict], to_real: Callable[[int], int]):
    """The map of a ``perf_counter_ns`` reading onto the profile's device
    clock, and how it was made.  The export's anchors put the spans on the
    realtime clock; the profiler's device times drift from it by up to
    ~12 ms within seconds (measured on an H100).  Every blocking copy to the
    host is one ``host.sync`` span (``to_host`` 1) and one ``Memcpy DtoH``
    on the card, in the same order, and the copy ends as the host's wait
    does: where the two counts agree the map is pinned to each copy's end
    and linear between copies (``anchored`` true); where they do not, it
    is the anchors' line alone.  ``monotone``: the pinned map keeps the
    order of time (host waits and device copies both in order), without
    which a gap can fall under the wrong span."""
    syncs = [to_real(s["t1"]) for s in spans if s["name"] == "host.sync"
             and s["attrs"][1:] == [1]]
    ends = [b for _a, b, n in iv if "Memcpy DtoH" in n]
    info = {"anchored": bool(syncs) and len(syncs) == len(ends),
            "host_copies": len(syncs), "device_copies": len(ends)}
    if not info["anchored"]:
        return to_real, info
    x = np.asarray(syncs, np.float64)
    off = np.asarray(ends, np.float64) - x
    info["offset_us"] = [float(v) / 1e3 for v in
                         np.percentile(off, [0, 50, 100])]
    info["monotone"] = bool(np.all(np.diff(x) > 0)
                            and np.all(np.diff(x + off) >= 0))
    return (lambda t: int(round(to_real(t) + np.interp(to_real(t), x, off))),
            info)


def _label(span: Dict) -> str:
    if span["name"] == "host.sync":
        return f"host.sync:{span['attrs'][0]}"
    return span["name"]


def device_readings(iv, ex: Dict, t0_ns: int, t1_ns: int,
                    k4_key: str = "paged_decode") -> Dict:
    """Per ``decode.step`` span, the kernels that start inside it (and the
    K4 ones) and the device-busy ns inside it (``harness._union_busy``);
    idle seconds of [t0_ns, t1_ns] by the innermost program span open at
    each gap's midpoint (``outside_program`` where none is; a copy's by
    its site), and how many of them fall inside a decode step.  ``iv``:
    the device's events, sorted.  Spans go onto the device's clock by
    :func:`device_clock`."""
    spans = _spans(ex)
    clock, alignment = device_clock(iv, spans, load_obs().realtime(ex))
    r0 = [clock(s["t0"]) for s in spans]
    r1 = [clock(s["t1"]) for s in spans]
    starts = [e[0] for e in iv]
    k4 = [e[0] for e in iv if k4_key in e[2]]
    longest = max((e[1] - e[0] for e in iv), default=0)
    steps = []
    for i, s in enumerate(spans):
        if s["name"] != "decode.step":
            continue
        lo, hi = r0[i], r1[i]
        first = bisect.bisect_left(starts, lo)
        last = bisect.bisect_left(starts, hi)
        near = iv[bisect.bisect_left(starts, lo - longest):last]
        steps.append({
            "kernels": last - first,
            "k4": bisect.bisect_left(k4, hi) - bisect.bisect_left(k4, lo),
            "busy_ns": harness._union_busy(
                [(max(a, lo), min(b, hi)) for a, b, _n in near if b > lo])})
    alignment["k4_outside_steps"] = len(k4) - sum(s["k4"] for s in steps)
    # spans are in start order (ids grow as they open), parents first
    in_step = []
    for s in spans:
        in_step.append(s["name"] == "decode.step"
                       or (s["parent"] >= 0 and in_step[s["parent"]]))
    gaps: Dict[str, int] = {}
    idle_in_steps = 0
    prev = t0_ns
    for a, b, _n in iv + [(t1_ns, t1_ns, "")]:
        a = min(a, t1_ns)
        if a > prev:
            mid = (a + prev) // 2
            j = bisect.bisect_right(r0, mid) - 1
            while j >= 0 and not r0[j] <= mid <= r1[j]:
                j = spans[j]["parent"]
            label = _label(spans[j]) if j >= 0 else "outside_program"
            gaps[label] = gaps.get(label, 0) + (a - prev)
            idle_in_steps += (a - prev) if j >= 0 and in_step[j] else 0
        prev = max(prev, b)
    return {"decode_steps": steps,
            "idle_by_program_span_s": {k: v / 1e9 for k, v in
                                       sorted(gaps.items(),
                                              key=lambda kv: -kv[1])},
            "idle_in_steps_s": idle_in_steps / 1e9,
            "alignment": alignment}


class Hooks:
    """The tracer switched on over the harness's measured window, from
    outside the harness: on at the start of the window's first tick, off
    and exported as the window's record is taken (the window has closed,
    the cluster not yet freed); in a traced run, the profile's events
    read once for the harness's ``read_profile`` and the device readings
    both."""

    def __init__(self, harness_mod, warmup_ticks: int):
        self.harness = harness_mod
        self.warmup = int(warmup_ticks)
        self.obs = load_obs()
        self.export: Optional[Dict] = None
        self.rec: Optional[Dict] = None
        self.window = None
        self.device: Optional[Dict] = None
        self.harness_profile: Optional[Dict] = None

    def install(self, patch: Callable = setattr) -> "Hooks":
        h = self.harness
        tick, record, read = h.Driver.tick, h.window_record, h.read_profile
        hooks = self

        def driver_tick(drv):
            if hooks.obs is not None and drv.tick_no == hooks.warmup:
                hooks.obs.reset()
                hooks.obs.enable()
            return tick(drv)

        def window_record(drv, *a, **k):
            rec = record(drv, *a, **k)
            if hooks.obs is not None:
                hooks.obs.disable()
                hooks.export = hooks.obs.export()
            hooks.rec = rec
            ends = drv.tick_ends
            hooks.window = (ends[hooks.warmup - 1], ends[-1], {
                tr.req.rid: (tr.sent, tr.done_at) for tr in drv.tracks})
            return rec

        def read_profile(prof, t0_ns, t1_ns, timeline):
            events = device_events(prof)
            pr = read(_read_events(events), t0_ns, t1_ns, timeline)
            if hooks.export is not None:
                hooks.device = device_readings(events, hooks.export, t0_ns,
                                               t1_ns)
            hooks.harness_profile = pr | {"decode_tick_s": sum(
                n1 - n0 for lab, n0, n1 in timeline
                if lab == "decode_tick") / 1e9}
            return pr

        patch(h.Driver, "tick", driver_tick)
        patch(h, "window_record", window_record)
        patch(h, "read_profile", read_profile)
        return self

    def readings(self, n_layers: int) -> Dict:
        """The program's readings of the window (every one None where the
        program has no tracer), with the checks of its spans."""
        out = {k: None for k in PROGRAM_READINGS}
        ex = self.export
        if ex is None or self.window is None:
            return out | {"detail": None}
        t0, t_end, reqs = self.window
        out["decode.enqueue_ms"] = decode_enqueue_ms(ex)
        out["host.syncs_per_tick"] = host_syncs_per_tick(ex)
        out["sched.queue_wait_p95_ms"] = queue_wait_p95_ms(ex, reqs, t0,
                                                           t_end)
        out["ttft_p95_ms.token"] = ttft_p95_ms_token(ex, reqs, t0, t_end)
        out["itl_p95_ms.token"] = itl_p95_ms_token(ex, reqs, t0, t_end)
        spans = _spans(ex)
        ticks = sum(1 for s in spans if s["name"] == "tick")
        syncs = ex["counters"].get("host.syncs", {})
        out["detail"] = {
            "spans": len(spans), "ticks": ticks,
            "emitted_tokens": sum(n for _r, _t, n in ex["emits"]),
            "host_syncs_per_tick_by_site": {
                k: v / ticks for k, v in sorted(syncs.items())}
            if ticks else {},
            "ms_per_step_by_part": _step_parts_ms(spans),
            "checks": self._checks(spans, n_layers)}
        if self.device is not None:
            steps = self.device["decode_steps"]
            if steps:
                out["decode.device_ms"] = (sum(s["busy_ns"] for s in steps)
                                           / len(steps) / 1e6)
                out["decode.kernels_per_step"] = (
                    sum(s["kernels"] for s in steps) / len(steps))
            out["detail"]["idle_by_program_span_s"] = \
                self.device["idle_by_program_span_s"]
            out["detail"]["alignment"] = self.device["alignment"]
        return out

    def _checks(self, spans: List[Dict], n_layers: int) -> Dict:
        """The spans against what the harness measures from outside: the
        decode steps' seconds against its ``decode_tick`` spans', the
        parts' cover of the steps, K4 launches inside the steps against
        40 a step, and the idle time the pinned clock puts inside decode
        steps against the idle the harness labels ``decode_tick`` on its
        own clock."""
        kids = _children(spans)
        steps = [i for i, s in enumerate(spans) if s["name"] == "decode.step"]
        step_ns = sum(spans[i]["t1"] - spans[i]["t0"] for i in steps)
        parts_ns = sum(spans[k]["t1"] - spans[k]["t0"] for i in steps
                       for k in kids.get(i, ())
                       if spans[k]["name"] in STEP_PARTS)
        out = {"decode_step_s": step_ns / 1e9,
               "step_parts_cover": parts_ns / step_ns if step_ns else None}
        harness_spans = (self.rec or {}).get("spans")
        if harness_spans:
            out["harness_decode_tick_s"] = sum(
                dt for dt, _ in harness_spans["decodes"])
        pr = self.harness_profile
        if self.device is not None and pr:
            dsteps = self.device["decode_steps"]
            out["k4_in_steps"] = sum(s["k4"] for s in dsteps)
            out["k4_want"] = n_layers * len(dsteps)
            out["idle_in_steps_s"] = self.device["idle_in_steps_s"]
            out["harness_idle_in_decode_tick_s"] = \
                pr["idle_by_span_s"].get("decode_tick", 0.0)
        return out


def _step_parts_ms(spans: List[Dict]) -> Dict[str, float]:
    """Host ms a decode step by its parts (the spans directly under
    ``decode.step``), mean over steps."""
    kids = _children(spans)
    steps = [i for i, s in enumerate(spans) if s["name"] == "decode.step"]
    out: Dict[str, float] = {}
    for i in steps:
        for k in kids.get(i, ()):
            out[spans[k]["name"]] = (out.get(spans[k]["name"], 0)
                                     + spans[k]["t1"] - spans[k]["t0"])
    return {k: v / len(steps) / 1e6 for k, v in out.items()} if steps else {}


def run_cell(harness_mod, cell: str, seed: int, seconds: float,
             trace: bool, *, warmup_ticks: int, patch=setattr, n_layers: int,
             **kw) -> Dict:
    """``harness.run_cell`` with the program's tracer over the window; the
    result line gains ``program``."""
    hooks = Hooks(harness_mod, warmup_ticks).install(patch)
    out = harness_mod.run_cell(cell, seed, seconds, trace, **kw)
    checks = out.pop("checks")
    out["program"] = hooks.readings(n_layers)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import run as bench_run
    bench_run._paths()
    import torch
    import traffic
    bench = harness.load_benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    mix = traffic.load_mix(entry["traffic"])
    conf = harness.load_config(entry["config"])
    out = run_cell(harness, args.workload, args.seed, args.seconds,
                   bool(args.trace), warmup_ticks=mix["warmup_ticks"],
                   n_layers=conf["run"]["n_layers"],
                   device="cuda", t_start=bench_run.T_START, bench=bench)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
