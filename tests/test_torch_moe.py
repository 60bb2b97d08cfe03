"""The port's moe family against the JAX package: reduced kimi-k2-1t-a32b
(dual cache stacks: 1 leading dense layer + 1 moe layer, 4 experts top-2
and a shared expert) and arctic-480b (one moe stack, 4 experts top-2 and
a dense residual MLP), reduced as ``tests/test_paged_decode.py`` reduces
them (2 layers, d_model 64, vocab 128), fp32 weights carried across by
``convert.params_from_jax``.

``moe_apply`` is held within rtol = atol = 2e-4 (``tests/test_kernels.py``)
-- with a shared expert and with a dense residual, when capacity overflows
and drops tokens, and on a zero router, where every probability ties and
the experts must be picked lower index first as ``jax.lax.top_k`` picks
them; then ``forward``, ``prefill`` and 3 greedy ``decode_step``s and one
``decode_step_paged``; ``pool_layout`` against the reference's stacks
and the engine's pools; the paged path's every decode tick bit for bit
against a dense-cache shadow replaying the schedule (the port against
itself, as ``tests/test_paged_decode.py`` holds the JAX package); and a
paged ``ServingCluster`` run against the JAX cluster: identical greedy
tokens and identical integer ``coherence_report`` counters."""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core import CoherencePolicy as JPolicy
from repro.models import decode_step as j_decode_step
from repro.models import decode_step_paged as j_decode_step_paged
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import pool_layout as j_pool_layout
from repro.models import prefill as j_prefill
from repro.models.moe import _capacity as j_capacity
from repro.models.moe import aux_load_balance_loss as j_aux_loss
from repro.models.moe import moe_apply as _j_moe_apply
from repro.runtime import Request as JRequest
from repro.runtime import ServingCluster as JCluster
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import CoherencePolicy as TPolicy
from repro_torch.models import (decode_step, decode_step_paged, forward,
                                init_params, param_leaves, pool_layout,
                                prefill)
from repro_torch.models import moe as M
from repro_torch.runtime import Request as TRequest
from repro_torch.runtime import ServingCluster as TCluster

TOL = dict(rtol=2e-4, atol=2e-4)
# one compiled call each (the JAX package's eager dispatch costs seconds)
j_moe_apply = jax.jit(_j_moe_apply, static_argnums=1)
ARCHS = {"kimi": "kimi-k2-1t-a32b", "arctic": "arctic-480b"}
SHRINK = dict(n_layers=2, d_model=64, vocab=128)


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = reduced(get_arch(ARCHS[arch]), **SHRINK)
    tcfg = t_reduced(t_get_arch(ARCHS[arch]), **SHRINK)
    params = j_init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    return cfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray,
                                                           params))


def _moe_params(arch):
    """The moe layer's parameters in both packages (the last layer: kimi's
    first is dense)."""
    cfg, tcfg, params, tparams = _model(arch)
    jp = jax.tree.map(lambda a: a[-1], params["layers"]["moe"])
    return cfg, tcfg, jp, tparams["layers"][-1]["moe"]


def _np32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def test_reduced_configs_keep_their_moe_shape():
    kimi, arctic = (_model(a)[1] for a in ARCHS)
    assert kimi.first_dense_layers == 1 and kimi.n_shared_experts == 1
    assert not kimi.residual_ff
    assert arctic.first_dense_layers == 0 and arctic.residual_ff
    assert [s.pool for s in pool_layout(kimi)] == ["dense", "moe"]
    assert [s.pool for s in pool_layout(arctic)] == ["moe"]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_params_has_the_jax_tree(arch):
    """The port's own init: the JAX tree's keys, shapes and dtypes (after
    unstacking), and the JAX package's scales (the expert stacks' fan-in
    is the expert count)."""
    cfg, tcfg, _params, tparams = _model(arch)
    own = init_params(tcfg, torch.Generator().manual_seed(0), torch.float32)

    def spec(tree):
        if isinstance(tree, torch.Tensor):
            return tuple(tree.shape), tree.dtype
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        return [spec(v) for v in tree]

    assert spec(own) == spec(tparams)
    moe = own["layers"][-1]["moe"]
    assert moe["router"].dtype == torch.float32
    for name, fan_in in (("w_gate", tcfg.n_experts), ("w_down",
                                                      tcfg.n_experts),
                         ("router", None)):
        std = float(moe[name].std())
        want = 0.02 if fan_in is None else fan_in ** -0.5
        assert abs(std / want - 1) < 0.1, (name, std, want)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_converted_params_keep_counts_and_bytes(arch):
    """What the serving cluster charges (param bytes, flops a token) is
    counted over the same leaves as the JAX cluster's."""
    _cfg, _tcfg, params, tparams = _model(arch)
    leaves = jax.tree.leaves(params)
    tl = param_leaves(tparams)
    assert sum(x.size for x in leaves) == sum(t.numel() for t in tl)
    assert (sum(x.size * x.dtype.itemsize for x in leaves)
            == sum(t.numel() * t.element_size() for t in tl))


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("b,s", [(2, 5), (1, 1), (3, 7)])
def test_moe_apply_matches_jax(arch, b, s):
    """kimi's shared expert and arctic's dense residual; token counts
    whose capacity stays at its floor of 8 and one past it."""
    cfg, tcfg, jp, tp = _moe_params(arch)
    x = np.random.default_rng(b * 10 + s).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    want = j_moe_apply(jp, cfg, jnp.asarray(x))
    got = M.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np32(want), **TOL)
    assert M._capacity(tcfg, b * s) == j_capacity(cfg, b * s)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_apply_drops_overflow_like_jax(arch):
    """A router that sends every token to expert 0: 12 tokens against a
    capacity of 8, so 4 of expert 0's assignments land in the overflow
    slot and drop -- the same ones as in the JAX package."""
    cfg, tcfg, jp, tp = _moe_params(arch)
    bias = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    bias[:, 0] = 1.0
    x = np.abs(np.random.default_rng(3).standard_normal(
        (3, 4, cfg.d_model))).astype(np.float32)
    jp = dict(jp, router=jp["router"] + jnp.asarray(bias))
    tp = dict(tp, router=tp["router"] + torch.from_numpy(bias))
    _, ids, _ = M.route(tp, tcfg, torch.from_numpy(x).reshape(12, -1))
    assert int((ids == 0).sum()) == 12 > M._capacity(tcfg, 12) == 8
    want = j_moe_apply(jp, cfg, jnp.asarray(x))
    got = M.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np32(want), **TOL)
    # the drops are real: with room for every token the output differs
    roomy = M.moe_apply(tp, tcfg.__class__(**{
        **tcfg.__dict__, "capacity_factor": 8.0}), torch.from_numpy(x))
    assert not torch.allclose(roomy, got, **TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_apply_zero_router_ties_like_jax(arch):
    """Every probability equal: both packages route each token to experts
    0 .. k-1 (the lower index first on ties)."""
    cfg, tcfg, jp, tp = _moe_params(arch)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(5).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32)
    _, ids, _ = M.route(tp, tcfg, torch.from_numpy(x).reshape(6, -1))
    assert ids.tolist() == [list(range(tcfg.top_k))] * 6
    want = j_moe_apply(jp, cfg, jnp.asarray(x))
    got = M.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np32(want), **TOL)


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25] * 4,
                          [0.4, 0.1, 0.4, 0.1]])
    vals, idx = M.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2], [0, 1],
                                                        [0, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_aux_load_balance_loss_matches_jax(arch):
    cfg, tcfg, jp, tp = _moe_params(arch)
    x = np.random.default_rng(2).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        float(M.aux_load_balance_loss(tp, tcfg, torch.from_numpy(x))),
        float(j_aux_loss(jp, cfg, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_jax(arch):
    cfg, tcfg, params, tparams = _model(arch)
    toks = np.random.default_rng(len(arch)).integers(
        1, cfg.vocab, (2, 11)).astype(np.int32)
    want = j_forward(cfg, params, {"tokens": jnp.asarray(toks)})
    got = forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), _np32(want), **TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_then_decode_steps_match_jax(arch):
    """prefill into fp32 caches (kimi: both stacks, dk/dv and k/v), then 3
    decode steps fed JAX's greedy tokens at per-request positions:
    logits, greedy tokens and every cache entry."""
    cfg, tcfg, params, tparams = _model(arch)
    rng = np.random.default_rng(9)
    toks = rng.integers(1, cfg.vocab, (3, 9)).astype(np.int32)
    jcache, jl = j_prefill(cfg, params, {"tokens": jnp.asarray(toks)}, 16,
                           dtype=jnp.float32)
    tcache, tl = prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                         16, dtype=torch.float32)
    assert sorted(tcache) == sorted(jcache)
    for step in range(4):
        np.testing.assert_allclose(tl.numpy(), _np32(jl), **TOL,
                                   err_msg=f"step {step}")
        for k in jcache:
            np.testing.assert_allclose(tcache[k].numpy(), _np32(jcache[k]),
                                       **TOL, err_msg=f"{k} step {step}")
        nxt = _np32(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        assert np.array_equal(tl.numpy()[:, -1].argmax(-1), nxt[:, 0])
        if step == 3:
            break
        pos = np.asarray([9, 9, 9], np.int32) + step
        jcache, jl = j_decode_step(cfg, params, jcache, jnp.asarray(nxt),
                                   jnp.asarray(pos))
        tcache, tl = decode_step(tcfg, tparams, tcache,
                                 torch.from_numpy(nxt), torch.from_numpy(pos))


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("pool_dtype", ["bfloat16", "float32"])
def test_decode_step_paged_matches_jax(arch, pool_dtype):
    """One paged decode step over a pool whose token row holds every stack
    (kimi: the dense stack's segment, then the moe stack's at offset
    128): logits within 2e-4 and the appended rows as JAX appends them
    (bf16 bit for bit)."""
    cfg, tcfg, params, tparams = _model(arch)
    rng = np.random.default_rng(len(pool_dtype))
    chunk, nb, p, b = 4, 24, 6, 3
    last = pool_layout(tcfg)[-1]
    token_row = last.offset + -(-last.token_elems // 128) * 128
    pool = rng.standard_normal((nb * chunk, token_row)).astype(np.float32)
    pages = np.stack([rng.permutation(nb)[:p] for _ in range(b)]) \
        .astype(np.int32)
    lengths = rng.integers(0, p * chunk - 1, b).astype(np.int32)
    tokens = rng.integers(1, cfg.vocab, (b, 1)).astype(np.int32)
    jdt = jnp.bfloat16 if pool_dtype == "bfloat16" else jnp.float32
    jpool, jlogits = jax.jit(
        lambda pl, pr, ln, tk: j_decode_step_paged(
            cfg, params, pl, pr, ln, tk, chunk=chunk, interpret=True))(
        jnp.asarray(pool, jdt), jnp.asarray(pages), jnp.asarray(lengths),
        jnp.asarray(tokens))
    tpool = torch.from_numpy(pool).to(getattr(torch, pool_dtype))
    out_pool, tlogits = decode_step_paged(
        tcfg, tparams, tpool, torch.from_numpy(pages),
        torch.from_numpy(lengths), torch.from_numpy(tokens), chunk=chunk)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    if pool_dtype == "bfloat16":
        np.testing.assert_array_equal(
            out_pool.view(torch.int16).numpy(),
            np.asarray(jpool).view(np.int16))
    else:
        np.testing.assert_allclose(out_pool.numpy(), np.asarray(jpool),
                                   **TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_pool_layout_matches_jax_and_engine(arch):
    """The stacks' names, parameter and cache keys, depths, kinds and
    offsets equal the reference's, and the port's engine computes the
    same pools (twin of ``test_moe_dual_stack_pool_layout_matches_engine``)
    -- one write publishes every stack, one invalidate frees them all."""
    cfg, tcfg, _p, tparams = _model(arch)
    assert [tuple(s) for s in pool_layout(tcfg)] == \
        [tuple(s) for s in j_pool_layout(cfg)]
    tc = _tcluster(arch, n_replicas=1)
    eng = tc.prefix_engine
    stacks = pool_layout(tcfg)
    assert [s.pool for s in stacks] == eng.pool_names
    for s in stacks:
        assert eng.pool_offset(s.pool) == s.offset
        assert eng.pool_token_elems(s.pool) == s.token_elems
    assert eng.kv_token_row == sum(eng.pool_token_row(s.pool)
                                   for s in stacks)
    hk, dh = tcfg.n_kv_heads, tcfg.head_dim()
    rng = np.random.default_rng(0)
    blocks = {s.pool: torch.from_numpy(rng.standard_normal(
        (1, 4, 2, s.n_layers * hk, dh)).astype(np.float32)) for s in stacks}
    writes0 = eng.stats.kv_blocks_written
    eng.write_kv([3], blocks)
    assert eng.stats.kv_blocks_written == writes0 + 1 and eng.kv_ok(3)
    out = eng.read_kv([3])
    if len(stacks) == 1:          # a one-pool engine returns the array
        out = {stacks[0].pool: out}
    for s in stacks:
        torch.testing.assert_close(out[s.pool].float(), blocks[s.pool],
                                   rtol=0.02, atol=0.02)
        assert torch.equal(eng.read_kv([3], pool=s.pool), out[s.pool])
    eng.invalidate_kv([3])
    assert not eng.kv_ok(3)


_CLUSTER_KW = dict(prefix_block_tokens=4, n_prefix_blocks=64,
                   n_decode_pages=64, max_pages=16)


def _tcluster(arch, sanitize=True, **kw):
    """The port's paged cluster on the CPU (``sanitize``: the lease
    sanitizer checks every transition)."""
    _cfg, tcfg, _p, tparams = _model(arch)
    c = TCluster(tcfg, lambda: tparams, policy=TPolicy(lease=16),
                 device="cpu", sanitize=sanitize, **_CLUSTER_KW, **kw)
    c.trace = []
    return c


def _prompts(seed, vocab, n):
    """Shared system prompts, random suffixes, staggered budgets (the
    requests of ``tests/test_paged_decode.py``'s ``_reqs``)."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, vocab, 4 * int(rng.integers(1, 4)))
                .astype(np.int32) for _ in range(2)]
    return [(np.concatenate([prefixes[int(rng.integers(0, 2))],
                             rng.integers(1, vocab, int(rng.integers(1, 9)))
                             .astype(np.int32)]), int(rng.integers(1, 5)))
            for _ in range(n)]


def _replay_dense_shadow(tcfg, tparams, cluster):
    """Re-run the recorded schedule through the dense-cache
    ``decode_step`` on per-request caches seeded from the same pool bits
    -- each stack sliced out of its own segment at its ``pool_layout``
    offset -- and assert bitwise-equal logits every tick."""
    stacks = pool_layout(tcfg)
    names = [k for s in stacks for k in s.cache_keys]
    bt = cluster.prefix_block_tokens
    hk, dh = tcfg.n_kv_heads, tcfg.head_dim()
    t_cap = cluster.max_pages * bt
    caches, ticks = {}, 0
    for ev in cluster.trace:
        if ev["ev"] == "admit":
            plen = ev["prompt_len"]
            pos = np.arange(plen)
            flat = ev["page_row"][pos // bt].astype(np.int64) * bt + pos % bt
            rows = ev["rows"][torch.from_numpy(flat)]
            c = {}
            for s in stacks:
                kv = rows[:, s.offset:s.offset + s.token_elems].reshape(
                    plen, 2, s.n_layers, hk, dh)
                for j, key in enumerate(s.cache_keys):
                    z = torch.zeros((s.n_layers, t_cap, hk, dh),
                                    dtype=rows.dtype)
                    z[:, :plen] = kv[:, j].permute(1, 0, 2, 3)
                    c[key] = z
            caches[ev["rid"]] = c
        elif ev["ev"] == "tick":
            cache = {n: torch.stack([caches[r][n] for r in ev["rids"]], 1)
                     for n in names}
            cache, logits = decode_step(
                tcfg, tparams, cache, torch.from_numpy(ev["tokens"]),
                torch.from_numpy(ev["lengths"].astype(np.int32)))
            np.testing.assert_array_equal(
                logits.float().numpy(), ev["logits"],
                err_msg=f"paged decode diverged at tick {ev['tick']}")
            for i, r in enumerate(ev["rids"]):
                caches[r] = {n: cache[n][:, i].clone() for n in names}
            ticks += 1
    return ticks


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("n_replicas", [1, 2])
def test_paged_decode_bit_exact_against_dense_shadow(arch, n_replicas):
    """A randomized stream (joins and finishes mid-batch, shared
    prefixes) on the port's paged path, every tick bit for bit against
    the dense-cache shadow; every stack sees the same token traffic."""
    _cfg, tcfg, _p, tparams = _model(arch)
    tc = _tcluster(arch, n_replicas=n_replicas)
    reqs = [TRequest(i, p, max_new=m) for i, (p, m) in
            enumerate(_prompts(n_replicas, tcfg.vocab, 8))]
    done, rep = tc.run(reqs)
    assert all(r.done and len(r.output) == r.max_new for r in done)
    assert _replay_dense_shadow(tcfg, tparams, tc) > 0
    assert rep["prefix_block_hits"] > 0 and rep["kv_tokens_appended"] > 0
    for s in pool_layout(tcfg):
        assert rep[f"pool_tokens_appended_{s.pool}"] \
            == rep["kv_tokens_appended"]
    assert rep["kv_pool_stacks"] == ",".join(
        s.pool for s in pool_layout(tcfg))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_paged_serving_matches_jax(arch):
    """The port's paged cluster on the CPU against the JAX cluster:
    identical greedy tokens and every integer coherence counter (the
    per-stack pool ledgers included), prefix hits skipping prefill."""
    cfg, tcfg, params, _tp = _model(arch)
    jc = JCluster(cfg, lambda: params, policy=JPolicy(lease=16),
                  n_replicas=2, **_CLUSTER_KW)
    tc = _tcluster(arch, sanitize=None, n_replicas=2)  # as the JAX one
    prompts = _prompts(11, cfg.vocab, 6)
    jr = [JRequest(i, p, max_new=m) for i, (p, m) in enumerate(prompts)]
    tr = [TRequest(i, p, max_new=m) for i, (p, m) in enumerate(prompts)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jdone, jrep = jc.run(jr)
    tdone, trep = tc.run(tr)
    assert tc.paged
    for a, b in zip(jdone, tdone):
        assert b.done and len(b.output) == b.max_new
        np.testing.assert_array_equal(a.output, b.output,
                                      err_msg=f"tokens of request {a.rid}")
    ints = [k for k, v in jrep.items()
            if isinstance(v, (int, np.integer)) and not isinstance(v, bool)]
    assert {k: jrep[k] for k in ints} == {k: trep[k] for k in ints}
    assert jrep["kv_pool_stacks"] == trep["kv_pool_stacks"]
    assert trep["prefix_prefill_tokens_skipped"] > 0
