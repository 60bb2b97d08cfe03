"""The traffic generator: deterministic per seed, lengths in range, and
the reuse structure of each mix."""
import numpy as np
import pytest

import traffic

MIXES = ("sessions", "unique")


def _drive(mix, seed, clients=6, sends=40, vocab=1000):
    """Sends of a closed loop whose every answer is ``max_new`` tokens of
    a fixed id, clients answered in turn."""
    loop = traffic.ClosedLoop(mix, seed, clients, vocab)
    out = [loop.first(c) for c in range(clients)]
    while len(out) < sends:
        last = out[-clients]
        out.append(loop.next(last.client,
                             np.full(last.max_new, 7, np.int32)))
    return out


@pytest.mark.parametrize("name", MIXES)
def test_bench_mix_deterministic_per_seed(name):
    mix = traffic.load_mix(name)
    a, b = _drive(mix, 2 ** 31 + 5), _drive(mix, 2 ** 31 + 5)
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
               for x, y in zip(a, b))
    c = _drive(mix, 2 ** 31 + 6)
    assert any(not np.array_equal(x.prompt[:64], y.prompt[:64])
               for x, y in zip(a, c))


@pytest.mark.parametrize("name", MIXES)
def test_bench_mix_lengths_in_range(name):
    mix = traffic.load_mix(name)
    sys_len = mix["system_prompts"]["tokens"]
    for sh in traffic.session_shapes(mix):
        assert mix["turns"]["min"] <= len(sh.answers) <= mix["turns"]["max"]
        lo = mix["document"]["min"] + mix["question"]["min"]
        hi = mix["document"]["max"] + mix["question"]["max"]
        assert lo <= sh.first <= hi
        assert all(mix["message"]["min"] <= m <= mix["message"]["max"]
                   for m in sh.messages)
        assert all(mix["answer"]["min"] <= a <= mix["answer"]["max"]
                   for a in sh.answers)
    for s in _drive(mix, 3, sends=200):
        assert len(s.prompt) >= sys_len
        assert len(s.prompt) + s.max_new <= mix["max_context"]
        assert s.prompt.dtype == np.int32
        assert 0 <= s.prompt.min() and s.prompt.max() < 1000


def test_bench_sizes_do_not_follow_the_seed():
    """Every seed serves the same sizes in the same arrivals; the seed
    orders which client starts which session, and draws the tokens."""
    mix = traffic.load_mix("sessions")
    a = traffic.ClosedLoop(mix, 11, 8, 1000)
    b = traffic.ClosedLoop(mix, 12, 8, 1000)
    assert sorted(a.start_order.tolist()) == list(range(8))
    assert a.start_order.tolist() != b.start_order.tolist()
    sa = [a.first(int(c)) for c in a.start_order]
    sb = [b.first(int(c)) for c in b.start_order]
    assert [(len(x.prompt), x.max_new) for x in sa] == \
        [(len(x.prompt), x.max_new) for x in sb]
    assert [x.client for x in sa] != [x.client for x in sb]


def test_bench_sessions_reuse_every_earlier_turn():
    """A later turn's prompt starts with the previous prompt and its
    answer as served; every session opens with a shared system prompt."""
    mix = traffic.load_mix("sessions")
    loop = traffic.ClosedLoop(mix, 5, 1, 1000)
    prev = loop.first(0)
    systems = {tuple(s) for s in loop.systems}
    later = 0
    for _ in range(120):
        answer = np.arange(prev.max_new, dtype=np.int32)
        nxt = loop.next(0, answer)
        sys_len = mix["system_prompts"]["tokens"]
        assert tuple(nxt.prompt[:sys_len]) in systems
        if nxt.turn:
            later += 1
            n = len(prev.prompt)
            assert np.array_equal(nxt.prompt[:n], prev.prompt)
            assert np.array_equal(nxt.prompt[n:n + len(answer)], answer)
        prev = nxt
    assert later > 20


def test_bench_unique_shares_no_block():
    """No 16-token block of any prompt of the unique mix appears twice, and
    its lengths are the sessions mix's, turn by turn."""
    seen = set()
    uniq = _drive(traffic.load_mix("unique"), 9, sends=120, vocab=151552)
    sess = _drive(traffic.load_mix("sessions"), 9, sends=120, vocab=151552)
    for u, s in zip(uniq, sess):
        assert (len(u.prompt), u.max_new, u.turn) == \
            (len(s.prompt), s.max_new, s.turn)
        for c in range(len(u.prompt) // 16):
            key = u.prompt[16 * c:16 * c + 16].tobytes()
            assert key not in seen
            seen.add(key)


@pytest.mark.parametrize("config", ["glm4-9b", "mistral-nemo-12b"])
def test_bench_decode_region_is_clients_times_mean_context(config):
    import harness
    srv = harness.load_config(config)["serving"]
    clients = srv["replicas"] * srv["max_batch"]
    for name in MIXES:
        st = traffic.request_stats(traffic.load_mix(name),
                                   srv["block_tokens"])
        assert srv["n_decode_pages"] == round(clients
                                              * st["mean_context_pages"])


@pytest.mark.parametrize("name", MIXES)
def test_bench_mix_meets_its_scaled_source(name):
    """The requests' mean prompt and answer are the published trace's
    means times the mix's scale, within 1 %; the share an unbounded prefix
    cache would serve is the trace's cache ratio within a point (sessions),
    or nothing (fresh tokens)."""
    mix = traffic.load_mix(name)
    src, k = mix["source"], mix["scale"]
    st = traffic.request_stats(mix, 16)
    assert st["requests"] > 4000
    assert st["mean_input"] == pytest.approx(k * src["mean_input_tokens"],
                                             rel=0.01)
    assert st["mean_output"] == pytest.approx(k * src["mean_output_tokens"],
                                              rel=0.01)
    want = 0.0 if mix["fresh_tokens"] else src["cache_ratio"]
    assert st["reuse_share"] == pytest.approx(want, abs=0.01)


@pytest.mark.parametrize("key", ["loop", "think_time_s", "arrivals"])
def test_bench_mix_refuses_what_it_does_not_implement(tmp_path,
                                                      monkeypatch, key):
    """A mix key the generator does not read (an open loop, think time) is
    refused, not run as a closed loop."""
    import json
    mix = traffic.load_mix("sessions")
    mix[key] = "open"
    (tmp_path / "x.json").write_text(json.dumps(mix))
    monkeypatch.setattr(traffic, "MIX_DIR", tmp_path)
    with pytest.raises(ValueError, match=key):
        traffic.load_mix("x")
