"""``chip_smoke.py``'s phase 4 check on the CPU, at a tiny config: the
teacher-forced three runs of each bf16 lane (card, CPU bf16, fp32 anchor),
the norm check that holds the card's logits to at most twice the plain
bf16 path's distance from the anchor, and the wrapper-level off-by-ones
of ``--phase4-mutants`` that it must fail.  The card's place is taken by a
second CPU run with the kernel route forced, so the wrappers (their plain
versions here) run where the card runs the kernels."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from repro_torch.configs import get_arch, reduced
from repro_torch.models import attention, layers, ssm, transformer
from repro_torch.runtime import Request


@pytest.fixture
def kernel_route(monkeypatch):
    """Every eligibility check that sends a CUDA call to K4-K8 says yes on
    CPU tensors too."""
    monkeypatch.setattr(attention, "_flash_kernel_eligible",
                        lambda q, k, window: window == 0)
    monkeypatch.setattr(attention, "_kernel_eligible",
                        lambda q, kc, cur, min_t: q.shape[1] == 1
                        and torch.as_tensor(cur).dim() == 0)
    monkeypatch.setattr(layers, "_rmsnorm_kernel_eligible", lambda x: True)
    monkeypatch.setattr(transformer, "_paged_kernel_eligible", lambda p: True)
    monkeypatch.setattr(ssm, "_ssd_kernel_eligible", lambda x: True)


TINY = reduced(get_arch("tinyllama-1.1b"))
TINY_ZAMBA2 = reduced(get_arch("zamba2-2.7b"))
TINY_KIMI = reduced(get_arch("kimi-k2-1t-a32b"))      # two cache stacks


def test_norm_check_holds_within_twice_the_cpu_distance():
    rng = np.random.default_rng(0)
    anchor = [rng.standard_normal((4, 50)) * 5 for _ in range(3)]
    noise = [rng.standard_normal((4, 50)) * 0.1 for _ in range(3)]
    cpu = [a + n for a, n in zip(anchor, noise)]
    ok, steps = cs.norm_check([a + 1.5 * n for a, n in zip(anchor, noise)],
                              cpu, anchor)
    assert ok and len(steps) == 3
    for s in steps:
        assert s["e_card"] == pytest.approx(1.5 * s["e_cpu"])
        assert s["limit"] == pytest.approx(
            2 * s["e_cpu"] + 1e-3 * np.linalg.norm(anchor[0]), rel=0.2)
    far = [a + n for a, n in zip(anchor, noise)]
    far[2] = anchor[2] + 3 * noise[2]          # one step off: the check fails
    ok, steps = cs.norm_check(far, cpu, anchor)
    assert not ok and [s["ok"] for s in steps] == [True, True, False]
    # the floor: a CPU run that equals the anchor leaves 1e-3 |anchor|
    ok, _ = cs.norm_check([a + 1e-4 for a in anchor], anchor, anchor)
    assert ok


@pytest.mark.parametrize("lane", ["paged", "wave"])
def test_teacher_forced_runs_feed_the_anchor_tokens(kernel_route, lane):
    """The anchor (fp32 weights) decodes greedily; the other runs are fed
    its tokens, so every run sees the same inputs at every step; two runs
    of the same path agree to the bit."""
    params = cs._phase4_params(TINY, 0)
    if lane == "paged":
        run, reqs = cs._tf_paged, cs._requests(Request, np, TINY.vocab, n=4)
    else:
        run = cs._tf_wave
        reqs = cs._wave_requests(Request, np, TINY.vocab, n=5, lo=10, hi=20)
    anchor, fed = run(TINY, cs._cast(params, torch.float32), "cpu", reqs)
    assert len(anchor) == cs.PHASE4_STEPS + 1
    assert fed.shape == (len(reqs), cs.PHASE4_STEPS)
    for j in range(cs.PHASE4_STEPS):      # greedy: each step's argmax fed
        np.testing.assert_array_equal(fed[:, j], anchor[j].argmax(-1))
    bf16, fed2 = run(TINY, params, "cpu", reqs, fed)
    np.testing.assert_array_equal(fed2, fed)
    again, _ = run(TINY, params, "cpu", reqs, fed)
    for a, b, c in zip(anchor, bf16, again):
        assert a.shape == b.shape == (len(reqs), TINY.vocab)
        np.testing.assert_array_equal(b, c)
        assert 0 < np.linalg.norm(b - a) < 0.1 * np.linalg.norm(a)


def test_phase4_lanes_hold_with_the_cpu_in_the_cards_place(kernel_route):
    paged = cs.phase4_card_vs_cpu("cpu", 0, hold=True, card="cpu", cfg=TINY)
    assert paged["new_ok"] and paged["old_ok"]
    assert paged["new_ratio"] == pytest.approx(1.0)
    wave = cs.phase4_wave_card_vs_cpu(
        "cpu", 0, hold=True, card="cpu", archs=("tinyllama-1.1b",),
        cfgs={"tinyllama-1.1b": TINY})["tinyllama-1.1b"]
    assert wave["new_ok"] and wave["new_ratio"] == pytest.approx(1.0)


def test_kimi_lane_holds_with_the_cpu_in_the_cards_place(kernel_route):
    """The moe paged lane (kimi's dense and moe cache stacks side by side
    in the pool's token rows): counters, the retired ratio and the norm
    check hold with the CPU in the card's place."""
    kimi = cs.phase4_card_vs_cpu("cpu", 0, hold=True, card="cpu",
                                 cfg=TINY_KIMI, lane="kimi")
    assert kimi["new_ok"] and kimi["old_ok"]
    assert kimi["new_ratio"] == pytest.approx(1.0)


def test_zamba2_bf16_lane_holds_with_the_cpu_in_the_cards_place(
        kernel_route):
    """zamba2's lanes: the fp32 one held as before, the bf16 one
    teacher-forced through the K7 route (its plain version here) within
    the norm check."""
    z = cs.phase4_wave_card_vs_cpu(
        "cpu", 0, hold=True, card="cpu", archs=("zamba2-2.7b",),
        cfgs={"zamba2-2.7b": TINY_ZAMBA2})["zamba2-2.7b"]
    assert z["old_ok"] and z["new_ok"]
    assert z["new_ratio"] == pytest.approx(1.0, abs=0.05)


@pytest.mark.parametrize("mutant", list(cs.MUTANTS))
def test_each_injected_off_by_one_fails_the_check(kernel_route, mutant):
    memo = {}
    for lane in cs.MUTANTS[mutant]:
        kw = dict(hold=False, memo=memo, card="cpu")
        if lane in ("paged", "kimi"):
            pkw = dict(kw, cfg=TINY if lane == "paged" else TINY_KIMI,
                       lane=lane)
            clean = cs.phase4_card_vs_cpu("cpu", 1, **pkw)
            with cs.inject(mutant):
                bad = cs.phase4_card_vs_cpu("cpu", 1, **pkw)
        else:
            arch, cfg = (("tinyllama-1.1b", TINY) if lane == "wave"
                         else ("zamba2-2.7b", TINY_ZAMBA2))
            wkw = dict(kw, archs=(arch,), cfgs={arch: cfg})
            clean = cs.phase4_wave_card_vs_cpu("cpu", 1, **wkw)[arch]
            with cs.inject(mutant):
                bad = cs.phase4_wave_card_vs_cpu("cpu", 1, **wkw)[arch]
        assert clean["new_ok"], (lane, clean)
        assert not bad["new_ok"] and bad["new_ratio"] > cs.NORM_FACTOR, \
            (lane, bad)


def test_phase4_mutants_mode_misses_nothing(kernel_route):
    assert cs.phase4_mutants("cpu", [2], card="cpu",
                             cfgs={"paged": TINY, "wave": TINY,
                                   "zamba2": TINY_ZAMBA2,
                                   "kimi": TINY_KIMI}) == []


def test_inject_restores_the_wrapper():
    from repro_torch.kernels.rmsnorm import ops as nops
    orig = nops.rmsnorm_2d
    with pytest.raises(RuntimeError):
        with cs.inject("K8 weight rolled"):
            assert nops.rmsnorm_2d is not orig
            raise RuntimeError
    assert nops.rmsnorm_2d is orig


@pytest.mark.parametrize("fleet", sorted(cs.FLEETS))
def test_fleet_checks_hold_on_the_cpu(fleet):
    """Phase 3's multi-host fleets at a tiny config on the CPU: the fleet
    serves and ``check_fleet``'s contract holds (migrated pages
    bit-identical to their home rows among it)."""
    from repro_torch.models import init_params
    gen = torch.Generator().manual_seed(0)
    params = init_params(TINY, gen, torch.bfloat16)
    mh, done, report, _dt = cs._serve_fleet(TINY, params, "cpu", fleet,
                                            256, 128)
    assert cs.check_fleet(fleet, mh, done, report) > 0
    assert report["n_hosts"] == cs.FLEETS[fleet]["n_hosts"]
    assert report["xhost_shards"] == cs.FLEETS[fleet]["n_shards"]


def test_fleet_lane_holds_with_the_cpu_in_the_cards_place():
    """Phase 4's fleet A lane: every integer counter of the fleet's report
    identical between the two runs, and the tokens too."""
    r = cs.phase4_fleet_card_vs_cpu("cpu", 0, hold=True, card="cpu",
                                    cfg=TINY)
    assert r["counters_ok"] and r["agree"] == r["tokens"] > 0
    assert r["old_ratio"] == pytest.approx(0.0)


@pytest.mark.parametrize("arch,depth", cs.DECODERS)
def test_decoder_configurations_fit_the_card(arch, depth):
    """Phase 3's decoder configurations at full width: bf16 weights and
    the serving pool (4608 blocks of 16 token rows) at the card's depth
    fit one H100's 80 GB with room for the run (under 60 GB), and the
    published depth is cut only where they would not."""
    cfg = cs.decoder_config(arch, depth)
    full = get_arch(arch)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim(),
            cfg.vocab, cfg.n_experts) == (full.d_model, full.n_heads,
                                          full.n_kv_heads, full.head_dim(),
                                          full.vocab, full.n_experts)

    def gb(c):
        pool = 4608 * 16 * 2 * c.n_layers * c.n_kv_heads * c.head_dim()
        return 2 * (c.param_count() + pool) / 1e9
    assert gb(cfg) < 60
    assert depth == full.n_layers or gb(cs.decoder_config(
        arch, full.n_layers)) > 80


@pytest.mark.parametrize("arch,depth", cs.DECODERS)
def test_decoder_lane_cuts_keep_the_attention(arch, depth):
    """Phase 4's lane of each decoder configuration keeps its attention
    geometry, RoPE settings and d_model; depth 2, vocab 32000, every MLP
    width 16 and arctic's experts 16 (top-2 kept)."""
    full = get_arch(arch)
    cfg = cs.decoder_phase4_config(arch)
    keep = ("d_model", "n_heads", "n_kv_heads", "d_head", "rope_theta",
            "mrope", "top_k", "family")
    assert all(getattr(cfg, k) == getattr(full, k) for k in keep)
    assert (cfg.n_layers, cfg.vocab) == (2, 32000)
    assert cfg.d_ff == (16 if full.d_ff else 0)
    if full.n_experts:
        assert (cfg.n_experts, cfg.d_ff_expert, cfg.residual_ff) == \
            (16, 16, 16)
    # the CPU's fp32 anchor: llama3's d_model 16384 makes the largest
    assert 4 * cfg.param_count() / 1e9 < 9
