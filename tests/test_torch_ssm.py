"""The port's Mamba2/SSD layer and the dense-cache serving steps against the
JAX package's, on the CPU: ``ssd_chunked`` (with s not a multiple of the
chunk), ``ssd_decode_step`` and ``ssm_block`` in prefill and decode mode,
then ``prefill`` followed by several ``decode_step`` calls for reduced
mamba2-130m, zamba2-2.7b and tinyllama (one case at cache_len=2048), with
seeded numpy inputs and fp32 weights converted from
``repro.models.init_params``.  Tolerance: fp32 rtol = atol = 2e-4."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.models import ssm as J
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import decode_step, forward, init_cache, \
    init_params, param_leaves, prefill
from repro_torch.models import ssm as T

TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 32, 4, 8, 16, 16),       # whole chunks
    (2, 37, 4, 8, 16, 16),       # s not a multiple of the chunk
    (1, 10, 3, 16, 8, 16),       # one partial chunk
    (1, 70, 2, 4, 32, 32),
])
def test_ssd_chunked_matches_jax(b, s, h, p, n, chunk):
    arrs = _ssd_inputs(b, s, h, p, n, s * 10 + h)
    jy, jstate = J.ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk)
    ty, tstate = T.ssd_chunked(*(_t(a) for a in arrs), chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), **TOL)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(1)
    b, h, p, n = 3, 4, 8, 16
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, h))).astype(np.float32)
    A = -np.abs(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, n)).astype(np.float32)
    C = rng.standard_normal((b, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    arrs = (state, x, dt, A, B, C, D)
    jy, js = J.ssd_decode_step(*(jnp.asarray(a) for a in arrs))
    ty, ts = T.ssd_decode_step(*(_t(a) for a in arrs))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@functools.lru_cache(maxsize=None)
def _model(arch, **over):
    cfg = reduced(get_arch(arch), **over)
    tcfg = t_reduced(t_get_arch(arch), **over)
    params = j_init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    return cfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray,
                                                           params))


def test_ssm_block_prefill_then_decode_matches_jax():
    """One Mamba2 block: prefill over 21 tokens (a partial chunk), then
    three decode steps from the prefill's (state, conv tail)."""
    cfg, tcfg, params, tparams = _model("mamba2-130m")
    jp = jax.tree.map(lambda t: t[0], params["layers"]["ssm"])
    tp = tparams["layers"][0]["ssm"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    blk = jax.jit(lambda p, x, st: J.ssm_block(p, cfg, x, decode_state=st))
    jy, (js, jc) = blk(jp, jnp.asarray(x), None)
    ty, (ts, tc) = T.ssm_block(tp, tcfg, _t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, (js, jc) = blk(jp, jnp.asarray(xt), (js, jc))
        ty, (ts, tc) = T.ssm_block(tp, tcfg, _t(xt), decode_state=(ts, tc))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL,
                                   err_msg=f"decode step {step}")
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b",
                                  "tinyllama-1.1b"])
def test_forward_matches_jax(arch):
    cfg, tcfg, params, tparams = _model(arch)
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (2, 19)) \
        .astype(np.int32)
    jh = jax.jit(lambda p, t: j_forward(cfg, p, {"tokens": t}))(
        params, jnp.asarray(toks))
    th = forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("arch,cache_len,s", [
    ("mamba2-130m", 32, 20),
    ("zamba2-2.7b", 32, 20),
    ("tinyllama-1.1b", 32, 20),
    ("zamba2-2.7b", 2048, 23),      # the kernel-eligible cache length
])
def test_prefill_then_decode_steps_match_jax(arch, cache_len, s):
    """The wave path's model calls: prefill at cache_len, then four decode
    steps at one scalar position -- logits within 2e-4 at every step and
    the caches alike (attention caches bf16, so within one bf16 step)."""
    cfg, tcfg, params, tparams = _model(arch)
    rng = np.random.default_rng(cache_len + s)
    toks = rng.integers(1, cfg.vocab, (2, s)).astype(np.int32)
    jcache, jl = jax.jit(lambda p, t: j_prefill(cfg, p, {"tokens": t},
                                                cache_len))(
        params, jnp.asarray(toks))
    tcache, tl = prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                         cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jdec = jax.jit(lambda p, c, t, i: j_decode_step(cfg, p, c, t, i))
    for step in range(4):
        nxt = rng.integers(1, cfg.vocab, (2, 1)).astype(np.int32)
        jcache, jl = jdec(params, jcache, jnp.asarray(nxt),
                          jnp.int32(s + step))
        tcache, tl = decode_step(tcfg, tparams, tcache,
                                 torch.from_numpy(nxt),
                                 torch.tensor(s + step, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"{arch} decode step {step}")
    assert set(tcache) == set(jcache)
    for k in jcache:
        assert tuple(tcache[k].shape) == jcache[k].shape
        assert str(tcache[k].dtype).split(".")[1] == str(jcache[k].dtype)
        # attention caches are bf16: within one bf16 step, plus an atol
        # for elements that cancel to near zero
        tol = TOL if k in ("state", "conv") else dict(rtol=2 ** -7, atol=1e-5)
        np.testing.assert_allclose(tcache[k].float().numpy(),
                                   np.asarray(jcache[k], np.float32), **tol,
                                   err_msg=k)


def test_vector_positions_decode_matches_jax():
    """attn_decode's (B,) vector case (continuous batching positions)."""
    cfg, tcfg, params, tparams = _model("tinyllama-1.1b")
    rng = np.random.default_rng(5)
    toks = rng.integers(1, cfg.vocab, (3, 12)).astype(np.int32)
    jcache, _ = j_prefill(cfg, params, {"tokens": jnp.asarray(toks)}, 24)
    tcache, _ = prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                        24)
    pos = np.asarray([12, 5, 9], np.int32)
    nxt = rng.integers(1, cfg.vocab, (3, 1)).astype(np.int32)
    _, jl = j_decode_step(cfg, params, jcache, jnp.asarray(nxt),
                          jnp.asarray(pos))
    _, tl = decode_step(tcfg, tparams, tcache, torch.from_numpy(nxt),
                        torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def _shapes(tree, path=""):
    if isinstance(tree, torch.Tensor):
        return {path: (tuple(tree.shape), tree.dtype)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{path}/{k}"))
    return out


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_init_params_and_cache_shapes_match_jax(arch):
    """The port's own init (an explicit torch.Generator) gives the JAX
    shapes, dtypes and element counts; init_cache the JAX cache shapes."""
    from repro.models import init_cache as j_init_cache
    cfg, tcfg, params, tparams = _model(arch)
    mine = init_params(tcfg, torch.Generator().manual_seed(0), torch.float32)
    assert _shapes(mine) == _shapes(tparams)
    assert sum(t.numel() for t in param_leaves(mine)) == sum(
        x.size for x in jax.tree.leaves(params))
    jc = j_init_cache(cfg, 2, 40)
    tc = init_cache(tcfg, 2, 40)
    assert {k: v.shape for k, v in jc.items()} == \
        {k: tuple(v.shape) for k, v in tc.items()}
