"""The port's ServingCluster (on the CPU) against the JAX package's, with
the config, weights, requests and kwargs of ``tests/test_paged_decode.py``:
identical greedy tokens and identical integer ``coherence_report``
counters -- over shared prefixes with staggered finishes and a collision
eviction relocating a pinned block mid-decode.  Rebases and the lease
predictor are held in ``test_torch_serving_leases.py``."""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core import CoherencePolicy as JPolicy
from repro.models import init_params
from repro.runtime import Request as JRequest
from repro.runtime import ServingCluster as JCluster
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import CoherencePolicy as TPolicy
from repro_torch.models import init_params as init_params_t
from repro_torch.models import pool_layout
from repro_torch.runtime import MultiHostServingCluster
from repro_torch.runtime import Request as TRequest
from repro_torch.runtime import ServingCluster as TCluster


@functools.lru_cache(maxsize=None)
def _arch():
    cfg = reduced(get_arch("tinyllama-1.1b"), n_layers=2, d_model=64,
                  vocab=128)
    tcfg = t_reduced(t_get_arch("tinyllama-1.1b"), n_layers=2, d_model=64,
                     vocab=128)
    params = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    return cfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray,
                                                           params))


def _clusters(policy=None, **kw):
    """The JAX and port clusters with test_paged_decode's _cluster kwargs."""
    cfg, tcfg, params, tparams = _arch()
    kw.setdefault("prefix_block_tokens", 4)
    kw.setdefault("n_prefix_blocks", 64)
    kw.setdefault("n_decode_pages", 64)
    kw.setdefault("max_pages", 16)
    policy = policy or dict(lease=16)
    jc = JCluster(cfg, lambda: params, policy=JPolicy(**policy), **kw)
    tc = TCluster(tcfg, lambda: tparams, policy=TPolicy(**policy),
                  device="cpu", sanitize=True, **kw)
    jc.trace, tc.trace = [], []
    return jc, tc


def _prompts(seed, vocab, n, n_prefixes=2, max_new_hi=4):
    """test_paged_decode's _reqs: shared system prompts, random suffixes,
    staggered decode budgets."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, vocab, 4 * int(rng.integers(1, 4)))
                .astype(np.int32) for _ in range(n_prefixes)]
    out = []
    for _ in range(n):
        p = prefixes[int(rng.integers(0, n_prefixes))]
        suffix = rng.integers(1, vocab, int(rng.integers(1, 9))) \
            .astype(np.int32)
        out.append((np.concatenate([p, suffix]),
                    int(rng.integers(1, max_new_hi + 1))))
    return out


def _run_both(jc, tc, prompts, rid0=0):
    jr = [JRequest(rid0 + i, p, max_new=m) for i, (p, m) in
          enumerate(prompts)]
    tr = [TRequest(rid0 + i, p, max_new=m) for i, (p, m) in
          enumerate(prompts)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jdone, jrep = jc.run(jr)
    tdone, trep = tc.run(tr)
    return jdone, jrep, tdone, trep


def _assert_same(jc, tc, jdone, jrep, tdone, trep):
    for a, b in zip(jdone, tdone):
        assert b.done and len(b.output) == b.max_new
        np.testing.assert_array_equal(a.output, b.output,
                                      err_msg=f"tokens of request {a.rid}")
    ints = [k for k, v in jrep.items()
            if isinstance(v, (int, np.integer)) and not isinstance(v, bool)
            and k != "sanitize_checks"]
    assert {k: jrep[k] for k in ints} == {k: trep[k] for k in ints}
    assert {k for k in jrep} == {k for k in trep}
    assert trep["sanitize_checks"] > 0
    jt = [e for e in jc.trace if e["ev"] == "tick"]
    tt = [e for e in tc.trace if e["ev"] == "tick"]
    assert len(jt) == len(tt) > 0
    for a, b in zip(jt, tt):
        assert a["rids"] == b["rids"]
        np.testing.assert_array_equal(a["lengths"], b["lengths"])
        # the KV behind these logits went through the bf16 pool, where a
        # 1-ulp fp32 difference can round to a different bf16 value: hold
        # them to the bf16 tolerance (one decode step from identical
        # inputs is held to 2e-4 in test_torch_paged_decode)
        np.testing.assert_allclose(b["logits"], np.asarray(a["logits"]),
                                   rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("n_replicas", [1, 2])
def test_shared_prefix_streams_match_jax(n_replicas):
    cfg, *_ = _arch()
    jc, tc = _clusters(n_replicas=n_replicas)
    out = _run_both(jc, tc, _prompts(n_replicas, cfg.vocab, 10))
    _assert_same(jc, tc, *out)
    assert out[1]["prefix_block_hits"] > 0
    assert out[1]["prefix_prefill_tokens_skipped"] > 0


def test_collision_eviction_relocates_like_jax():
    """A colliding admission re-tags a block an active decode still reads:
    the pinned payload relocates (zero messages) identically."""
    cfg, *_ = _arch()
    rng = np.random.default_rng(4)
    jc, tc = _clusters(n_prefix_blocks=1, n_replicas=1, max_batch=2)
    pa = rng.integers(1, cfg.vocab, 6).astype(np.int32)
    pb = rng.integers(1, cfg.vocab, 6).astype(np.int32)
    filler = rng.integers(1, cfg.vocab, 3).astype(np.int32)
    _run_both(jc, tc, [(pa, 1)])                        # warm the pool
    out = _run_both(jc, tc, [(pa, 6), (filler, 2), (pb, 2)], rid0=1)
    _assert_same(jc, tc, *out)
    assert out[1]["pinned_relocations"] >= 1
    assert out[1]["prefix_evictions"] >= 1


def test_entry_points_default_to_the_card_and_refuse_unported_paths():
    _cfg, tcfg, _p, tparams = _arch()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TCluster(tcfg, lambda: tparams)
    tc = TCluster(tcfg, lambda: tparams, device="cpu",
                  prefix_block_tokens=4, n_prefix_blocks=8,
                  n_decode_pages=8, max_pages=8)
    # the dense-cache wave (DecodeReplica.serve) is ported since; an empty
    # wave comes back as it went in
    assert tc.replicas[0].serve([]) == []
    # the encdec family runs its dense-cache paths since its slice; its
    # paged paths stay decoder-only, as in the JAX package
    whisper = t_reduced(t_get_arch("whisper-large-v3"))
    assert "dec_layers" in init_params_t(whisper, torch.Generator())
    with pytest.raises(NotImplementedError):
        pool_layout(whisper)


def test_multi_host_fleet_defaults_to_the_card():
    """``MultiHostServingCluster`` without ``device=`` runs on the card:
    with no card it raises, naming ``device='cpu'``, and never falls back;
    with ``device="cpu"`` it builds its hosts and directory there."""
    _cfg, tcfg, _p, tparams = _arch()
    kw = dict(prefix_block_tokens=4, n_prefix_blocks=8, n_decode_pages=8,
              max_pages=8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MultiHostServingCluster(tcfg, lambda: tparams, n_hosts=2, **kw)
    mh = MultiHostServingCluster(tcfg, lambda: tparams, n_hosts=2,
                                 device="cpu", **kw)
    assert mh.directory.device.type == "cpu"
    assert all(h.device.type == "cpu" and h.directory is mh.directory
               for h in mh.hosts)
