"""The harness's whole run on the CPU at a tiny size (its look for a card
skipped), sound and with the timed path broken underneath: each fault
that a served cell can have turns ``correct`` false."""
import numpy as np
import pytest
import torch

import tiny


def test_bench_sound_run_is_correct(monkeypatch):
    out = tiny.run(monkeypatch, seed=2 ** 31 + 3)
    assert out["correct"] and out["failed"] == 0
    assert out["attempted"] > 0 and out["window"]["requests_finished"] > 0
    assert set(out["metrics"]) == {"tokens_per_s", "ttft_p95_ms",
                                   "itl_p95_ms", "setup_s"}
    assert list(out)[-1] == "checks"
    assert out["window"]["coherence"]["prefix_prefill_tokens_skipped"] > 0
    assert out["checks"]["suffix_sampled"]["limit"] == 1
    assert out["checks"]["suffix_sampled"]["value"] >= 1
    occ = out["window"]["content_occupancy"]
    assert len(occ) == 2 and 0 < occ[0] <= occ[1] <= 1


def test_bench_traced_run_reads_its_layers(monkeypatch):
    out = tiny.run(monkeypatch, seed=4, trace=True)
    assert out["correct"]
    m = out["metrics"]
    assert {"sched.admit_ms", "sched.batch_fill", "lease.hit_share",
            "lease.skip_share", "lease.ms_per_tick", "mfu"} <= set(m)
    assert 0 < m["lease.hit_share"]["value"] < 100
    assert 0 < m["lease.skip_share"]["value"] < 100
    # no card: the device's metrics find nothing to read and are left out
    assert "device.idle_share" not in m


def test_bench_unique_mix_hits_nothing(monkeypatch):
    out = tiny.run(monkeypatch, seed=6, trace=True, fresh=True)
    assert out["correct"]
    assert out["metrics"]["lease.hit_share"]["value"] == 0
    assert out["metrics"]["lease.skip_share"]["value"] == 0


def _patch_decode(monkeypatch, fn):
    from repro_torch.runtime import serve_loop
    inner = serve_loop.decode_step_paged
    monkeypatch.setattr(serve_loop, "decode_step_paged",
                        lambda *a, **k: fn(inner, *a, **k))


def test_bench_fault_state_unchanged(monkeypatch):
    """A decode step that returns its state unchanged: no new KV row."""
    from repro_torch.models import decoding
    monkeypatch.setattr(decoding, "scatter_rows", lambda *a, **k: None)
    assert not tiny.run(monkeypatch, seed=8)["correct"]


def test_bench_fault_token_altered(monkeypatch):
    """A token altered where it is produced: the logits shifted by one."""
    def shifted(inner, *a, **k):
        pool, logits = inner(*a, **k)
        return pool, torch.roll(logits, 1, dims=-1)
    _patch_decode(monkeypatch, shifted)
    assert not tiny.run(monkeypatch, seed=9)["correct"]


def test_bench_fault_half_batch(monkeypatch):
    """Half of the batch left out: only the first half decoded, the rest
    given the first rows' logits."""
    def half(inner, cfg, p, pool, page_rows, lengths, tokens, **k):
        b = tokens.shape[0]
        h = max(1, b // 2)
        pool, logits = inner(cfg, p, pool, page_rows[:h], lengths[:h],
                             tokens[:h], **k)
        idx = torch.arange(b) % h
        return pool, logits[idx]
    _patch_decode(monkeypatch, half)
    assert not tiny.run(monkeypatch, seed=10)["correct"]


def test_bench_fault_block_holds_another_prefix(monkeypatch):
    """A content block written with another block's KV: reused prefixes
    read the wrong keys and values."""
    from repro_torch.core.lease_engine import LeaseEngine
    inner = LeaseEngine.write_kv

    def misplaced(self, idx, blocks):
        ids = np.atleast_1d(np.asarray(idx))
        if ids.size > 1:
            blocks = {k: torch.roll(v, 1, dims=0) for k, v in blocks.items()}
        return inner(self, idx, blocks)
    monkeypatch.setattr(LeaseEngine, "write_kv", misplaced)
    assert not tiny.run(monkeypatch, seed=11)["correct"]


def test_bench_fault_stale_block(monkeypatch):
    """A content block's write-back dropped while the block is marked
    valid: a later prompt reuses what the block held before (another
    prefix's KV, or none) under a fresh lease."""
    from repro_torch.core.lease_engine import LeaseEngine
    inner = LeaseEngine.write_kv
    n_prefix = tiny.CONF["serving"]["n_prefix_blocks"]

    def stale(self, idx, blocks):
        ids = np.atleast_1d(np.asarray(idx))
        if ids.size and (ids < n_prefix).all():
            self._kv_valid[ids] = True
            return
        return inner(self, idx, blocks)
    monkeypatch.setattr(LeaseEngine, "write_kv", stale)
    assert not tiny.run(monkeypatch, seed=12)["correct"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bench_control_judged_incorrect(monkeypatch, seed):
    """The control (the reference in float8), judged by the benchmark's
    own comparison at the tiny cell's limit, comes out not correct; the
    program (bf16) on the same served tokens comes out correct and reads
    far below it."""
    import harness
    import judge
    monkeypatch.setattr(harness, "port_arch", tiny.tiny_arch)
    sv = harness.serve(tiny.CELL, seed, 1.5, False, device="cpu",
                       bench=tiny.BENCH, conf=tiny.CONF, mix=tiny.MIX,
                       log=lambda m: None)
    sample = judge.sample(sv.finished, seed)
    due = int(any(tr.skipped for tr in sv.finished))
    check = {"logit_gap": {"limit": tiny.LIMIT}}
    prog = judge.judge(sv.run, sv.weights, sample, check, "cpu", due)
    ctrl = judge.judge(sv.run, sv.weights, sample, check, "cpu", due,
                       gaps=judge.control_gaps)
    assert prog["correct"] and not ctrl["correct"]
    p, c = (v["checks"]["logit_gap"]["value"] for v in (prog, ctrl))
    assert c > 3 * p


def _track(prompt_len, out_len, skipped):
    import harness
    from repro_torch.runtime import Request
    req = Request(0, np.zeros(prompt_len, np.int32), max_new=out_len)
    req.output = list(range(out_len))
    return harness.Track(req, 0, 0.0, [], done_at=1.0, skipped=skipped)


@pytest.mark.parametrize("seed", range(6))
def test_bench_sample_holds_a_suffix_admission(seed):
    """Where the longest finished request was a cold prefill, the sample
    still holds one request whose admission skipped leased tokens; with
    none such finished, it holds none and none is due."""
    import judge
    done = [_track(900, 40, 0)] + [_track(100 + i, 60, 0)
                                   for i in range(20)]
    done.insert(7 + seed, _track(200, 50, 64))
    got = judge.sample(done, seed)
    assert len(got[0][0]) == 900 and sum(1 for *_, k in got if k) == 1
    cold = judge.sample([t for t in done if not t.skipped], seed)
    assert not any(k for *_, k in cold)
