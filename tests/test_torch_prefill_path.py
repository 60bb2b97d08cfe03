"""The port's prefill through its kernel route against the JAX package, on
the CPU.  The three routing checks (``attention._flash_kernel_eligible``,
``ssm._ssd_kernel_eligible``, ``layers._rmsnorm_kernel_eligible``) are
forced true, so every attention of the prefill step, every SSD scan and
every norm goes through the kernels' ops wrappers -- whose CPU branches
are the kernels' plain versions -- as they go to K6-K8 on the card.
Held: ``forward``, ``prefill`` (then a decode step) and ``prefill_suffix``
within fp32 rtol = atol = 2e-4, and a ``ServingCluster`` run's greedy
tokens and every integer ``coherence_report`` counter identical to the JAX
cluster's on reduced tinyllama (paged, and the wave path with
``prefix_reuse=False``), mamba2-130m and zamba2-2.7b, in fp32 weights.  A
CUDA lane runs a reduced prefill on the card through K6-K8 against the
CPU."""
import functools
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import CoherencePolicy as TPolicy
from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                 variant_counts)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import attention, decode_step, forward, layers, \
    prefill, prefill_suffix, ssm
from repro_torch.runtime import Request as TRequest
from repro_torch.runtime import ServingCluster as TCluster

try:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch, reduced
    from repro.core import CoherencePolicy as JPolicy
    from repro.models import decode_step as j_decode_step
    from repro.models import forward as j_forward
    from repro.models import init_params
    from repro.models import prefill as j_prefill
    from repro.models import prefill_suffix as j_prefill_suffix
    from repro.runtime import Request as JRequest
    from repro.runtime import ServingCluster as JCluster
    from repro_torch.convert import params_from_jax
except ImportError:      # the card's machine has no JAX: only the CUDA
    jax = None           # lane (-m cuda) runs there

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_STEP = dict(rtol=2 ** -7, atol=1e-5)


@pytest.fixture
def kernel_route(monkeypatch):
    """Force the kernel route on CPU tensors; count the calls that reach
    each kernel wrapper (its plain version here), and K8's by variant
    ("rmsnorm.plain", "rmsnorm.add": the residual add fused in,
    "rmsnorm.gate": Mamba2's gated norm)."""
    calls = {"flash_prefill": 0, "ssd_chunk": 0, "rmsnorm": 0,
             "rmsnorm.plain": 0, "rmsnorm.add": 0, "rmsnorm.gate": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            if name == "rmsnorm":
                calls["rmsnorm." + ("add" if k.get("residual") is not None
                                    else "gate" if k.get("gate") is not None
                                    else "plain")] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(attention, "_flash_kernel_eligible",
                        lambda q, k, window: window == 0)
    monkeypatch.setattr(ssm, "_ssd_kernel_eligible", lambda x: True)
    monkeypatch.setattr(layers, "_rmsnorm_kernel_eligible", lambda x: True)
    monkeypatch.setattr(flash_ops, "flash_prefill",
                        counting("flash_prefill", flash_ops.flash_prefill))
    monkeypatch.setattr(ssd_ops, "ssd_chunk",
                        counting("ssd_chunk", ssd_ops.ssd_chunk))
    monkeypatch.setattr(norm_ops, "rmsnorm_2d",
                        counting("rmsnorm", norm_ops.rmsnorm_2d))
    return calls


def _np32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@functools.lru_cache(maxsize=None)
def _model(arch, **over):
    cfg = reduced(get_arch(arch), **over)
    tcfg = t_reduced(t_get_arch(arch), **over)
    params = init_params(cfg, jax.random.PRNGKey(2), jnp.float32)
    return cfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray,
                                                           params))


# the kernels (and K8's variants) each family's prefill reaches
WANT = {"tinyllama-1.1b": ("flash_prefill", "rmsnorm", "rmsnorm.plain",
                           "rmsnorm.add"),
        "mamba2-130m": ("ssd_chunk", "rmsnorm", "rmsnorm.gate",
                        "rmsnorm.add"),
        "zamba2-2.7b": ("flash_prefill", "ssd_chunk", "rmsnorm",
                        "rmsnorm.gate", "rmsnorm.add")}


@pytest.mark.parametrize("arch", list(WANT))
def test_forward_through_the_kernel_route_matches_jax(kernel_route, arch):
    cfg, tcfg, params, tparams = _model(arch)
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (2, 37)) \
        .astype(np.int32)
    jh = j_forward(cfg, params, {"tokens": jnp.asarray(toks)})
    th = forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert all(kernel_route[k] > 0 for k in WANT[arch]), kernel_route


@pytest.mark.parametrize("arch,cache_len,s", [
    ("tinyllama-1.1b", 48, 37), ("mamba2-130m", 48, 37),
    ("zamba2-2.7b", 48, 37), ("zamba2-2.7b", 2048, 23)])
def test_prefill_through_the_kernel_route_matches_jax(kernel_route, arch,
                                                      cache_len, s):
    """The wave path's prefill (then one decode step, whose norms also take
    the kernel route): logits within 2e-4, the caches alike (attention
    caches are bf16: within one bf16 step)."""
    cfg, tcfg, params, tparams = _model(arch)
    rng = np.random.default_rng(cache_len + s)
    toks = rng.integers(1, cfg.vocab, (2, s)).astype(np.int32)
    jcache, jl = j_prefill(cfg, params, {"tokens": jnp.asarray(toks)},
                           cache_len)
    tcache, tl = prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                         cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in jcache:       # bf16 caches (attention, conv): one bf16 step
        tol = BF16_STEP if tcache[k].dtype == torch.bfloat16 else TOL
        np.testing.assert_allclose(tcache[k].float().numpy(),
                                   _np32(jcache[k]), **tol, err_msg=k)
    assert all(kernel_route[k] > 0 for k in WANT[arch]), kernel_route
    nxt = rng.integers(1, cfg.vocab, (2, 1)).astype(np.int32)
    _, jl = j_decode_step(cfg, params, jcache, jnp.asarray(nxt),
                          jnp.int32(s))
    _, tl = decode_step(tcfg, tparams, tcache, torch.from_numpy(nxt),
                        torch.tensor(s, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("prefix_len,s", [(12, 9), (16, 16), (4, 1)])
def test_prefill_suffix_through_the_kernel_route_matches_jax(kernel_route,
                                                             prefix_len, s):
    """The paged path's suffix-only prefill: the suffix's queries at
    ``q_offset = prefix_len`` against a cache holding the prefix's KV, up to
    ``kv_len = prefix_len + s``."""
    cfg, tcfg, params, tparams = _model("tinyllama-1.1b")
    rng = np.random.default_rng(prefix_len + s)
    cache_len = 32
    prompt = rng.integers(1, cfg.vocab, (1, prefix_len + s)).astype(np.int32)
    jfull, _ = j_prefill(cfg, params,
                         {"tokens": jnp.asarray(prompt[:, :prefix_len])},
                         cache_len)
    jcache = {k: jfull[k] for k in ("k", "v")}
    tcache = {k: torch.tensor(_np32(jcache[k])).bfloat16()
              for k in ("k", "v")}
    suffix = prompt[:, prefix_len:]
    jout, jl = j_prefill_suffix(cfg, params, {"tokens": jnp.asarray(suffix)},
                                jcache, prefix_len)
    tout, tl = prefill_suffix(tcfg, tparams,
                              {"tokens": torch.from_numpy(suffix)}, tcache,
                              prefix_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tout[k].float().numpy(), _np32(jout[k]),
                                   **BF16_STEP, err_msg=k)
    assert kernel_route["flash_prefill"] == cfg.n_layers
    assert kernel_route["rmsnorm"] == 2 * cfg.n_layers + 1
    # the first norm alone is plain; every residual add runs in a norm
    assert kernel_route["rmsnorm.plain"] == 1
    assert kernel_route["rmsnorm.add"] == 2 * cfg.n_layers


def _norms_per_step(cfg):
    """K8's launches by variant in one decode step: the first attention
    norm of a dense model is plain, every later norm takes the residual
    add of the sublayer before (the final norm too), and each Mamba2 block
    takes the gated norm."""
    if cfg.family == "ssm":
        return {"plain": 0, "add": 1, "gate": cfg.n_layers}
    if cfg.family == "hybrid":
        n_app = cfg.n_layers // cfg.attn_every
        return {"plain": 0, "add": 2 * n_app + 1, "gate": cfg.n_layers}
    return {"plain": 1, "add": 2 * cfg.n_layers, "gate": 0}


@pytest.mark.parametrize("arch,over", [
    ("tinyllama-1.1b", {}), ("mamba2-130m", {}),
    ("zamba2-2.7b", dict(n_layers=4, attn_every=2))])
def test_decode_steps_through_the_fused_norms_match_jax(kernel_route, arch,
                                                        over):
    """The restructured layer loops (each sublayer's output carried into
    the next norm) through 3 greedy decode steps after a prefill: logits
    within 2e-4 of JAX, the same greedy tokens, and K8's launches by
    variant per step as the fused design has them."""
    cfg, tcfg, params, tparams = _model(arch, **over)
    toks = np.random.default_rng(7).integers(1, cfg.vocab, (3, 11)) \
        .astype(np.int32)
    jcache, jl = j_prefill(cfg, params, {"tokens": jnp.asarray(toks)}, 24)
    tcache, tl = prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                         24)
    for step in range(3):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tl.numpy()[:, -1].argmax(-1),
                                      nxt[:, 0])
        jcache, jl = j_decode_step(cfg, params, jcache, jnp.asarray(nxt),
                                   jnp.int32(11 + step))
        for k in kernel_route:
            kernel_route[k] = 0
        tcache, tl = decode_step(tcfg, tparams, tcache,
                                 torch.from_numpy(nxt),
                                 torch.tensor(11 + step, dtype=torch.int32))
        assert {v: kernel_route["rmsnorm." + v] for v in
                ("plain", "add", "gate")} == _norms_per_step(tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def _serve_both(tcfg_cfg, prompts, max_new, **kw):
    cfg, tcfg, params, tparams = tcfg_cfg
    policy = kw.pop("policy", dict(lease=16))
    jc = JCluster(cfg, lambda: params, policy=JPolicy(**policy), **kw)
    tc = TCluster(tcfg, lambda: tparams, policy=TPolicy(**policy),
                  device="cpu", **kw)
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


def _prompts(vocab, n, seed, shared=8):
    """Requests sharing a system prompt, suffixes of 1-8 tokens."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, shared).astype(np.int32)
    return [np.concatenate([system, rng.integers(
        1, vocab, int(rng.integers(1, 9))).astype(np.int32)])
        for _ in range(n)]


@pytest.mark.parametrize("arch,kw", [
    ("tinyllama-1.1b", dict(n_prefix_blocks=64, n_decode_pages=64,
                            max_pages=16)),               # paged
    ("tinyllama-1.1b", dict(prefix_reuse=False, cache_len=24)),  # wave
    ("mamba2-130m", dict(cache_len=24)),
    ("zamba2-2.7b", dict(cache_len=24)),
])
def test_serving_through_the_kernel_route_matches_jax(kernel_route, arch,
                                                      kw):
    model = _model(arch, n_layers=2, d_model=64, vocab=128)
    prompts = _prompts(128, 6, seed=len(arch))
    rep = _serve_both(model, prompts, [3, 2, 4, 1, 2, 3], n_replicas=2,
                      prefix_block_tokens=4, **kw)
    assert all(kernel_route[k] > 0 for k in WANT[arch]), kernel_route
    if "n_prefix_blocks" in kw:
        assert rep["prefix_prefill_tokens_skipped"] > 0    # suffix prefills


# --- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b"])
def test_cuda_prefill_runs_the_kernels_and_matches_cpu(cuda, arch):
    from repro_torch.models import init_params as t_init_params
    tcfg = t_reduced(t_get_arch(arch), n_layers=2, d_model=128)
    params = t_init_params(tcfg, torch.Generator().manual_seed(0),
                           torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, tcfg.vocab, (2, 300)).astype(np.int32))
    cpu_cache, cpu_l = prefill(tcfg, params, {"tokens": toks}, 320)
    reset_launch_counts()
    cache, logits = prefill(tcfg, _to_device(params, cuda),
                            {"tokens": toks.to(cuda)}, 320)
    counts = launch_counts()
    variants = variant_counts()["rmsnorm"]      # K8's launches by variant
    assert all((variants.get(k[len("rmsnorm."):], 0) if "." in k
                else counts[k]) > 0 for k in WANT[arch]), (counts, variants)
    torch.testing.assert_close(logits.cpu(), cpu_l, **TOL)
    for k in cpu_cache:
        tol = BF16_STEP if cache[k].dtype == torch.bfloat16 else TOL
        torch.testing.assert_close(cache[k].cpu().float(),
                                   cpu_cache[k].float(), **tol)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)
