"""The program's tracer read through the harness (``program_trace``), on
the CPU at the tiny size: a traced run reports the program-side readings
(the device's find no card and read None); a program without a tracer
reads every one None; and the benchmark's own metrics are the same with
the tracer on, off or missing (the harness's clock replaced by a counter,
so that two runs serve the same ticks)."""
import copy
import itertools
import sys
import time

import harness
import program_trace
import tiny

PROGRAM_SIDE = ("decode.enqueue_ms", "host.syncs_per_tick",
                "sched.queue_wait_p95_ms", "ttft_p95_ms.token",
                "itl_p95_ms.token")
DEVICE_SIDE = ("decode.device_ms", "decode.kernels_per_step")


def _run(monkeypatch, seed, trace=True):
    monkeypatch.setattr(harness, "port_arch", tiny.tiny_arch)
    return program_trace.run_cell(
        harness, tiny.CELL, seed, 1.5, trace,
        warmup_ticks=tiny.MIX["warmup_ticks"],
        patch=monkeypatch.setattr, n_layers=tiny.RUN["n_layers"],
        device="cpu", bench=tiny.BENCH, conf=copy.deepcopy(tiny.CONF),
        mix=copy.deepcopy(tiny.MIX), check={"logit_gap": {"limit":
                                                          tiny.LIMIT}},
        log=lambda m: None)


def test_bench_traced_run_reads_the_program(monkeypatch):
    out = _run(monkeypatch, seed=2 ** 31 + 5)
    assert out["correct"]
    got = out["program"]
    for k in PROGRAM_SIDE:
        assert got[k] is not None and got[k] >= 0, k
    for k in DEVICE_SIDE:
        assert got[k] is None, k
    detail = got["detail"]
    assert detail["ticks"] > 0 and detail["spans"] > detail["ticks"]
    assert detail["emitted_tokens"] == out["window"]["tokens"]
    sites = detail["host_syncs_per_tick_by_site"]
    assert sites["rebase.max_ts"] == 1
    assert sum(sites.values()) == got["host.syncs_per_tick"]
    checks = detail["checks"]
    # (a collection pause can land between the parts of a step this short)
    assert 0 < checks["step_parts_cover"] <= 1
    assert set(detail["ms_per_step_by_part"]) == set(
        program_trace.STEP_PARTS)
    # the program's decode steps lie inside the harness's outside spans
    assert 0 < checks["decode_step_s"] <= checks["harness_decode_tick_s"]
    assert list(out)[-1] == "checks"


def _counter_clock(monkeypatch):
    """A fresh clock for each run: a millisecond a read."""
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * 1e-3)


def test_bench_metrics_same_with_the_tracer_on_off_or_missing(monkeypatch):
    _counter_clock(monkeypatch)
    plain = tiny.run(monkeypatch, seed=9, trace=True)
    _counter_clock(monkeypatch)
    on = _run(monkeypatch, seed=9)
    _counter_clock(monkeypatch)
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    missing = _run(monkeypatch, seed=9)
    assert plain["correct"] and on["correct"] and missing["correct"]
    assert set(plain["metrics"]) >= {"sched.admit_ms", "lease.hit_share",
                                     "mfu"}
    for out in (on, missing):
        assert out["metrics"] == plain["metrics"]
        assert out["window"] == plain["window"]
        assert out["checks"] == plain["checks"]
    assert all(missing["program"][k] is None
               for k in PROGRAM_SIDE + DEVICE_SIDE)
    assert missing["program"]["detail"] is None
    assert on["program"]["host.syncs_per_tick"] > 0


def _steps_and_trace(n_steps, drift_ns, k4=3):
    """An export of ``n_steps`` decode steps (each: a forward, then its
    token copy) and the device's intervals for it, with the device's clock
    running ``drift_ns`` further behind the realtime clock each step."""
    ms = 1_000_000
    cols = {k: [] for k in ("name", "t0", "t1", "parent", "attrs")}

    def add(name, t0, t1, parent, attrs=()):
        for k, v in zip(cols, (name, t0, t1, parent, list(attrs))):
            cols[k].append(v)
        return len(cols["name"]) - 1

    iv = []
    for i in range(n_steps):
        t = ms + i * 100 * ms                # a step each 100 ms
        step = add("decode.step", t, t + 90 * ms, -1)
        add("decode.forward", t + ms, t + 60 * ms, step)
        add("host.sync", t + 60 * ms, t + 89 * ms, step,
            ("decode.tokens", 1))
        skew = -i * drift_ns
        for j in range(k4):
            a = t + 5 * ms + 15 * ms * j + skew
            iv.append((a, a + 4 * ms, "paged_decode_mma"))
        iv.append((t + 80 * ms + skew, t + 88 * ms + skew,
                   "Memcpy DtoH (Device -> Pageable)"))
    ex = {"anchors": [[0, 0], [10 ** 12, 10 ** 12]], "spans": cols}
    return ex, sorted(iv)


def test_bench_device_clock_is_pinned_to_the_copies():
    """Device times drifting 0.5 ms a step from the realtime clock: pinned
    to the token copies, every step holds its own K4 launches; where the
    copies do not pair up, the anchors' line alone misplaces some."""
    ex, iv = _steps_and_trace(16, 500_000)
    end = 2 * 10 ** 9
    got = program_trace.device_readings(iv, ex, 0, end)
    assert got["alignment"]["anchored"]
    assert [s["k4"] for s in got["decode_steps"]] == [3] * 16
    assert got["alignment"]["k4_outside_steps"] == 0
    assert all(s["busy_ns"] == 20_000_000 for s in got["decode_steps"])
    got = program_trace.device_readings(iv[:-1], ex, 0, end)
    assert not got["alignment"]["anchored"]
    assert got["alignment"]["k4_outside_steps"] > 0


def test_bench_device_clock_order_and_idle_in_steps():
    """The pinned map keeps time's order while the copies end in order; a
    copy that ends after the next one's end breaks the order and says so.
    A gap counts inside a step where its midpoint is: the three between
    a step's four device intervals (11 + 11 + 41 ms), and the window's
    first 6 ms, before the first step's first launch."""
    ex, iv = _steps_and_trace(16, 500_000)
    got = program_trace.device_readings(iv, ex, 0, 2 * 10 ** 9)
    assert got["alignment"]["monotone"]
    assert abs(got["idle_in_steps_s"] - (16 * 0.063 + 0.006)) < 1e-9
    assert set(got["idle_by_program_span_s"]) >= {
        "decode.forward", "host.sync:decode.tokens", "outside_program"}
    copies = [i for i, e in enumerate(iv) if "Memcpy" in e[2]]
    a, _b, name = iv[copies[4]]
    iv[copies[4]] = (a, iv[copies[5]][1] + 1_000_000, name)
    got = program_trace.device_readings(iv, ex, 0, 2 * 10 ** 9)
    assert got["alignment"]["anchored"] and not got["alignment"]["monotone"]


def test_bench_events_read_once_feed_the_harness_alike():
    """``harness.read_profile`` reads the events ``device_events`` took
    from a profile as it reads the profile itself."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    class Ev:
        def __init__(self, a, b, name, dev=DeviceType.CUDA, asy=False):
            self.v = (a, b, name, dev, asy)

        def start_ns(self):
            return self.v[0]

        def end_ns(self):
            return self.v[1]

        def name(self):
            return self.v[2]

        def device_type(self):
            return self.v[3]

        def is_async(self):
            return self.v[4]

    raw = [Ev(50, 70, "paged_decode_mma"), Ev(10, 30, "gemm"),
           Ev(20, 40, "cudaLaunchKernel", dev=DeviceType.CPU),
           Ev(25, 35, "flash_prefill"), Ev(0, 90, "async", asy=True),
           Ev(80, 85, "Memcpy DtoH (Device -> Pageable)")]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: raw)))
    timeline = [("decode_tick", 0, 60), ("admit", 60, 100)]
    events = program_trace.device_events(prof)
    assert [e[:2] for e in events] == [(10, 30), (25, 35), (50, 70),
                                       (80, 85)]
    assert (harness.read_profile(program_trace._read_events(events), 0,
                                 100, timeline)
            == harness.read_profile(prof, 0, 100, timeline))
