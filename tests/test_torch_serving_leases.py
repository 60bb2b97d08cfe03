"""The port's ServingCluster against the JAX package's under lease
pressure: a ``ts_bits`` small enough that rebases fire between decode
ticks, and the Tardis 2.0 lease predictor (K1's per-block lease path)
under SC and TSO -- identical greedy tokens and integer counters."""
import pytest

from test_torch_serving import _arch, _assert_same, _clusters, _prompts, \
    _run_both


def test_rebase_mid_decode_matches_jax():
    """ts_bits small enough that rebases fire between ticks; short leases
    renew in flight."""
    cfg, *_ = _arch()
    jc, tc = _clusters(policy=dict(lease=4, ts_bits=5), n_replicas=2)
    out = _run_both(jc, tc, _prompts(5, cfg.vocab, 16, max_new_hi=6))
    _assert_same(jc, tc, *out)
    assert out[1]["prefix_rebases"] >= 1
    assert out[1]["decode_renewals"] > 0


@pytest.mark.parametrize("consistency", ["sc", "tso"])
def test_lease_predictor_matches_jax(consistency):
    """Tardis 2.0 per-block predicted leases take K1's per-block lease
    path; TSO skips expired decode renewals."""
    cfg, *_ = _arch()
    jc, tc = _clusters(policy=dict(lease=2, predictor=True,
                                   consistency=consistency), n_replicas=1)
    out = _run_both(jc, tc, _prompts(7, cfg.vocab, 8, max_new_hi=6))
    _assert_same(jc, tc, *out)
    assert out[1]["pred_shrinks"] > 0
    if consistency == "sc":
        assert out[1]["pred_grows"] > 0
    else:
        assert out[1]["decode_renewals_skipped"] > 0
