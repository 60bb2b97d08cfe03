"""The port's fixed-wave dense-cache serving path against the JAX
package's, on the CPU: ``ServingCluster.run``'s wave branch ->
``DecodeReplica.serve`` for reduced mamba2-130m and zamba2-2.7b (whose
engines never hold a KV pool) and tinyllama with ``prefix_reuse=False``,
with weights converted from ``repro.models.init_params``.  Greedy tokens
and every integer ``coherence_report`` counter must equal the JAX
cluster's -- the per-wave prefix leases, rebases and weight-lease
renewals included.  Also the converter on ssm and hybrid trees."""
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
from repro_torch.models import param_leaves
from repro_torch.runtime import Request as TRequest
from repro_torch.runtime import ServingCluster as TCluster


@functools.lru_cache(maxsize=None)
def _arch(arch, seed=1):
    cfg = reduced(get_arch(arch))
    tcfg = t_reduced(t_get_arch(arch))
    params = init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    return cfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray,
                                                           params))


def _run_both(arch, prompts, max_new, policy=None, **kw):
    cfg, tcfg, params, tparams = _arch(arch)
    kw.setdefault("prefix_block_tokens", 4)
    policy = policy or {}
    jc = JCluster(cfg, lambda: params, policy=JPolicy(**policy), **kw)
    tc = TCluster(tcfg, lambda: tparams, policy=TPolicy(**policy),
                  device="cpu", **kw)
    assert not jc.paged and not tc.paged
    jr = [JRequest(i, p, max_new=m) for i, (p, m) in
          enumerate(zip(prompts, max_new))]
    tr = [TRequest(i, p, max_new=m) for i, (p, m) in
          enumerate(zip(prompts, max_new))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jdone, jrep = jc.run(jr)
    tdone, trep = tc.run(tr)
    for a, b in zip(jdone, tdone):
        assert b.done and len(b.output) == b.max_new
        np.testing.assert_array_equal(a.output, b.output,
                                      err_msg=f"tokens of request {a.rid}")
    ints = [k for k, v in jrep.items()
            if isinstance(v, (int, np.integer)) and not isinstance(v, bool)]
    assert {k: jrep[k] for k in ints} == {k: trep[k] for k in ints}
    assert set(jrep) == set(trep)
    return trep


def _prompts(vocab, n, seed, lo=6, hi=13, shared=8):
    """Requests sharing a system prompt (lease hits across waves) with
    suffixes of different lengths (the wave pads them with token 0)."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, shared).astype(np.int32)
    return [np.concatenate([system, rng.integers(
        1, vocab, int(rng.integers(lo - shared if lo > shared else 1,
                                   hi - shared + 1))).astype(np.int32)])
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_wave_fallback_families_match_jax(arch):
    """Twin of test_paged_decode.py's wave-fallback test: the same
    cluster kwargs, requests and budgets."""
    cfg, *_ = _arch(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab, 8).astype(np.int32)
               for _ in range(2)]
    rep = _run_both(arch, prompts, [2, 2], n_replicas=1, cache_len=32)
    assert rep["prefix_block_hits"] + rep["prefix_block_misses"] > 0


@pytest.mark.parametrize("arch,n_replicas", [
    ("zamba2-2.7b", 2), ("mamba2-130m", 3)])
def test_waves_share_prefix_leases_like_jax(arch, n_replicas):
    """Several waves over replicas: shared-prefix lease hits, renewals and
    padded prompts of different lengths and budgets."""
    cfg, *_ = _arch(arch)
    prompts = _prompts(cfg.vocab, 7, seed=n_replicas, lo=9, hi=15)
    rep = _run_both(arch, prompts, [3, 1, 4, 2, 3, 2, 1],
                    n_replicas=n_replicas, cache_len=24)
    assert rep["prefix_block_hits"] > 0


def test_dense_family_without_prefix_reuse_matches_jax():
    """tinyllama with prefix_reuse=False: no KV pool, no lease traffic, the
    dense caches decode in lockstep."""
    cfg, *_ = _arch("tinyllama-1.1b")
    prompts = _prompts(cfg.vocab, 5, seed=11, lo=5, hi=12)
    rep = _run_both("tinyllama-1.1b", prompts, [3, 2, 4, 1, 2],
                    n_replicas=2, cache_len=24, prefix_reuse=False)
    assert rep["prefix_block_hits"] == rep["prefix_block_misses"] == 0
    assert rep["reads"] > 0


def test_wave_rebase_matches_jax():
    """ts_bits small enough that the wave path's rebase guard fires between
    waves."""
    cfg, *_ = _arch("mamba2-130m")
    prompts = _prompts(cfg.vocab, 12, seed=3, lo=9, hi=13)
    rep = _run_both("mamba2-130m", prompts, [1] * 12, n_replicas=2,
                    cache_len=16, policy=dict(lease=4, ts_bits=3))
    assert rep["prefix_rebases"] >= 1


def test_wave_at_the_kernel_cache_length_matches_jax():
    """A 2048-slot cache: the shape the attention-decode kernel takes on
    the card (the plain version here, as the reference on the JAX side)."""
    cfg, *_ = _arch("zamba2-2.7b")
    prompts = _prompts(cfg.vocab, 2, seed=5, lo=9, hi=14)
    _run_both("zamba2-2.7b", prompts, [3, 2], n_replicas=2, cache_len=2048)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_converter_unstacks_ssm_and_hybrid_trees(arch):
    cfg, _tcfg, params, tparams = _arch(arch)
    leaves = jax.tree.leaves(params)
    tl = param_leaves(tparams)
    assert sum(x.size for x in leaves) == sum(t.numel() for t in tl)
    assert (sum(x.size * x.dtype.itemsize for x in leaves)
            == sum(t.numel() * t.element_size() for t in tl))
    if arch == "mamba2-130m":
        assert len(tparams["layers"]) == cfg.n_layers
        want = np.asarray(params["layers"]["ssm"]["in_proj"][1])
        got = tparams["layers"][1]["ssm"]["in_proj"]
    else:
        n_app = cfg.n_layers // cfg.attn_every
        assert len(tparams["groups"]) == n_app
        assert all(len(g) == cfg.attn_every for g in tparams["groups"])
        want = np.asarray(params["groups"]["ssm"]["conv_w"][n_app - 1, 0])
        got = tparams["groups"][n_app - 1][0]["ssm"]["conv_w"]
        np.testing.assert_array_equal(
            tparams["shared"]["attn"]["wq"].numpy(),
            np.asarray(params["shared"]["attn"]["wq"]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_of_an_empty_wave_returns_it():
    _cfg, tcfg, _p, tparams = _arch("mamba2-130m")
    tc = TCluster(tcfg, lambda: tparams, device="cpu", n_replicas=1,
                  prefix_block_tokens=4)
    assert tc.replicas[0].serve([]) == []
    assert isinstance(tc.replicas[0].cache_len, int)
    assert torch.is_tensor(tc.replicas[0].params()["embed"])
