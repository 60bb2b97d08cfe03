"""The encdec family (whisper-large-v3, reduced: 2 encoder + 2 decoder
layers, d_model 64) on the port against the JAX package, with fp32
weights from ``repro.models.init_params`` carried across by
``params_from_jax``.

  * ``forward`` and ``loss_fn`` with every gradient leaf, at encoder
    lengths that are not a multiple of K6's 64-key tile (37, 100) and at
    1500 (whisper's 30 s window; above 1024 x 1024 the CPU takes the
    blocked flash path on both sides), within rtol = atol = 2e-4
    (``tests/test_kernels.py``) and the training tests' gradient hold;
    also through the card's routing forced on CPU tensors (K6 / K10 and
    K8 / K11 as autograd Functions, their plain versions here);
  * ``prefill`` and 3 greedy ``decode_step``s fed JAX's tokens: the
    public prefill keeps the JAX package's bf16 cache (its encdec prefill
    ignores ``dtype``), ``_encdec_prefill(dtype=float32)`` the fp32 one;
    logits within 2e-4 (the steps that read a bf16 cache, 3e-2), caches
    within one bf16 step, identical greedy tokens;
  * one ``build_step`` with 2 microbatches (``frames`` split with the
    tokens) against JAX's step;
  * the twins of ``tests/test_models.py``'s ``test_arch_smoke`` and
    ``test_arch_decode_smoke`` for whisper (the port has no other twin of
    them), and the paged paths refusing the family, as in the JAX package;
  * ``cuda`` lane: K6 (both variants) and K10 against their plain versions
    at whisper's attention shapes (G = 1, non-causal, Skv in {1500, 100},
    Sq in {1, 4, 448}, and the encoder's Sq = Skv = 1500), and the reduced
    model's loss and gradients on the card against the CPU.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.dist.collectives import microbatch_grads
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_backward_ref, flash_attention_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.models import (attention, decode_step, decode_step_paged,
                                forward, init_params, layers, loss_fn,
                                pool_layout, prefill)
from repro_torch.models.decoding import _encdec_prefill, prefill_suffix
from repro_torch.runtime import TrainConfig, build_step
from repro_torch.tree import leaves, tree_map, value_and_grad

try:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch, reduced
    from repro.dist.collectives import microbatch_grads as j_microbatch
    from repro.models import decode_step as j_decode_step
    from repro.models import forward as j_forward
    from repro.models import init_params as j_init_params
    from repro.models import loss_fn as j_loss_fn
    from repro.models import prefill as j_prefill
    from repro.models.decoding import _encdec_prefill as j_encdec_prefill
    from repro.optim import adamw as j_adamw
    from repro.runtime.train_loop import TrainConfig as JTrainConfig
    from repro.runtime.train_loop import build_step as j_build_step
except ImportError:      # the card's machine has no JAX: only the CUDA
    jax = None           # lane (-m cuda) runs there

ARCH = "whisper-large-v3"
TOL = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
BF16_STEP = dict(rtol=2 ** -7, atol=1e-5)
LOSS = dict(rtol=1e-5, atol=0)
GRAD_REL = 1e-4          # gradient leaf error / the leaf's max |value|


@functools.lru_cache(maxsize=None)
def _model():
    cfg = reduced(get_arch(ARCH))
    tcfg = t_reduced(t_get_arch(ARCH))
    params = j_init_params(cfg, jax.random.PRNGKey(4), jnp.float32)
    return cfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray,
                                                           params))


def _batch(d_model, vocab, b=2, s_enc=37, s_dec=9, seed=0):
    """Frames (the stub frontend's output) and decoder tokens / labels
    (some masked), from the seed with numpy."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (b, s_dec)).astype(np.int32)
    labels[0, :2] = -1
    return {"frames": rng.standard_normal((b, s_enc, d_model)
                                          ).astype(np.float32),
            "tokens": rng.integers(1, vocab, (b, s_dec)).astype(np.int32),
            "labels": labels}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _np32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _hold_grads(got, want_jax):
    want = params_from_jax(jax.tree.map(np.asarray, want_jax))
    g_leaves, w_leaves = leaves(got), leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = max(float(w.abs().max()), 1e-12)
        err = float((g - w).abs().max())
        assert err <= GRAD_REL * scale, (tuple(g.shape), err, scale)


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX package (the reference)")


@pytest.fixture
def kernel_route(monkeypatch):
    """The card's routing on CPU tensors: attention and norms go through
    the kernels' ops wrappers (their plain versions here)."""
    monkeypatch.setattr(attention, "_flash_kernel_eligible",
                        lambda q, k, window: window == 0)
    monkeypatch.setattr(layers, "_rmsnorm_kernel_eligible", lambda x: True)


# ---------------------------------------------------------------------------
# Forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s_enc", [37, 100, 1500])
def test_forward_matches_jax(jax_ref, s_enc):
    cfg, tcfg, params, tparams = _model()
    batch = _batch(cfg.d_model, cfg.vocab, s_enc=s_enc, seed=s_enc)
    want = j_forward(cfg, params, _j(batch))
    got = forward(tcfg, tparams, _t(batch))
    assert got.shape == (2, 9, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), _np32(want), **TOL)


@pytest.mark.parametrize("s_enc", [37, 100])
def test_loss_and_grads_match_jax(jax_ref, s_enc):
    cfg, tcfg, params, tparams = _model()
    batch = _batch(cfg.d_model, cfg.vocab, s_enc=s_enc, seed=s_enc + 1)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(cfg, p, _j(batch))))(params)
    tl, tg = value_and_grad(lambda p, b: loss_fn(tcfg, p, b), tparams,
                            _t(batch))
    np.testing.assert_allclose(float(tl), float(jl), **LOSS)
    _hold_grads(tg, jg)


def test_loss_and_grads_through_the_kernel_route_match_jax(jax_ref,
                                                           kernel_route):
    """Every attention -- the encoder's non-causal self-attention, the
    decoder's causal one and the cross-attention -- through K6's autograd
    Function (backward K10's wrapper), every norm through K8's (K11's)."""
    cfg, tcfg, params, tparams = _model()
    batch = _batch(cfg.d_model, cfg.vocab, s_enc=70, seed=5)
    calls = {"fb": 0, "nb": 0}
    fb, nb = flash_ops.flash_backward, norm_ops.rmsnorm_backward

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    flash_ops.flash_backward = count("fb", fb)
    norm_ops.rmsnorm_backward = count("nb", nb)
    try:
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: j_loss_fn(cfg, p, _j(batch))))(params)
        tl, tg = value_and_grad(lambda p, b: loss_fn(tcfg, p, b), tparams,
                                _t(batch))
    finally:
        flash_ops.flash_backward, norm_ops.rmsnorm_backward = fb, nb
    assert calls == {"fb": cfg.n_enc_layers + 2 * cfg.n_layers,
                     "nb": 2 * cfg.n_enc_layers + 3 * cfg.n_layers + 1}
    np.testing.assert_allclose(float(tl), float(jl), **LOSS)
    _hold_grads(tg, jg)


def test_microbatched_train_step_matches_jax(jax_ref):
    """``build_step`` with 2 microbatches: ``frames`` split along the batch
    with the tokens and labels; the loss, the microbatched gradients and
    the parameters after one AdamW step against JAX's."""
    cfg, tcfg, params, tparams = _model()
    batch = _batch(cfg.d_model, cfg.vocab, b=4, s_enc=40, s_dec=8, seed=9)
    jl, jg = jax.jit(lambda p, b: j_microbatch(
        lambda pp, bb: j_loss_fn(cfg, pp, bb), p, b, 2))(params, _j(batch))
    tl, tg = microbatch_grads(lambda p, b: loss_fn(tcfg, p, b), tparams,
                              _t(batch), 2)
    np.testing.assert_allclose(float(tl), float(jl), **LOSS)
    _hold_grads(tg, jg)
    kw = dict(steps=4, warmup=2, n_micro=2)
    j_state = j_adamw.init(params)
    t_state = opt_state_from_jax(jax.tree.map(np.asarray, j_state))
    jp, _js, _r, jm = j_build_step(cfg, JTrainConfig(**kw))(
        jax.tree.map(jnp.copy, params), j_state, None, _j(batch))
    tp, _ts, _r, tm = build_step(tcfg, TrainConfig(**kw))(
        tree_map(torch.clone, tparams), t_state, None, _t(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS)
    lr = float(jm["lr"])
    want = params_from_jax(jax.tree.map(np.asarray, jp))
    for a, w in zip(leaves(tp), leaves(want)):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=2 * lr)


# ---------------------------------------------------------------------------
# Serving: prefill and greedy decode steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
def test_prefill_then_decode_steps_match_jax(jax_ref, cache_dtype):
    cfg, tcfg, params, tparams = _model()
    batch = _batch(cfg.d_model, cfg.vocab, b=3, s_enc=100, s_dec=5, seed=13)
    del batch["labels"]
    cache_len = 12
    if cache_dtype == "bfloat16":       # the public path: a bf16 cache
        jcache, jl = j_prefill(cfg, params, _j(batch), cache_len,
                               dtype=jnp.float32)
        tcache, tl = prefill(tcfg, tparams, _t(batch), cache_len,
                             dtype=torch.float32)
    else:
        jcache, jl = j_encdec_prefill(cfg, params, _j(batch), cache_len,
                                      dtype=jnp.float32)
        tcache, tl = _encdec_prefill(tcfg, tparams, _t(batch), cache_len,
                                     dtype=torch.float32)
    bf16 = cache_dtype == "bfloat16"
    assert set(tcache) == set(jcache) == {"k", "v", "ck", "cv"}
    for k in jcache:
        assert tcache[k].dtype == getattr(torch, cache_dtype)
        assert tuple(tcache[k].shape) == tuple(jcache[k].shape)
        np.testing.assert_allclose(tcache[k].float().numpy(),
                                   _np32(jcache[k]),
                                   **(BF16_STEP if bf16 else TOL), err_msg=k)
    for step in range(4):
        tol = BF16 if step and bf16 else TOL
        np.testing.assert_allclose(tl.numpy(), _np32(jl), **tol,
                                   err_msg=f"step {step}")
        nxt = _np32(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        assert np.array_equal(tl.numpy()[:, -1].argmax(-1),
                              nxt[:, 0]), f"greedy tokens at step {step}"
        if step == 3:
            break
        jcache, jl = j_decode_step(cfg, params, jcache, jnp.asarray(nxt),
                                   jnp.int32(5 + step))
        tcache, tl = decode_step(tcfg, tparams, tcache,
                                 torch.from_numpy(nxt),
                                 torch.tensor(5 + step, dtype=torch.int32))
    for k in jcache:
        np.testing.assert_allclose(tcache[k].float().numpy(),
                                   _np32(jcache[k]), **(BF16 if bf16 else TOL),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The twins of test_arch_smoke / test_arch_decode_smoke for whisper
# ---------------------------------------------------------------------------

B, S = 2, 32


def _smoke_setup():
    tcfg = t_reduced(t_get_arch(ARCH))
    params = init_params(tcfg, torch.Generator().manual_seed(0),
                         torch.float32)
    batch = _t(_batch(tcfg.d_model, tcfg.vocab, b=B, s_enc=S, s_dec=S))
    return tcfg, params, batch


def test_arch_smoke():
    """Reduced config: loss and gradients finite on the CPU, the forward's
    hidden states (B, S, D)."""
    tcfg, params, batch = _smoke_setup()
    loss, grads = value_and_grad(lambda p, b: loss_fn(tcfg, p, b), params,
                                 batch)
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(g).all()) for g in leaves(grads))
    with torch.no_grad():
        assert forward(tcfg, params, batch).shape == (B, S, tcfg.d_model)


def test_arch_decode_smoke():
    tcfg, params, batch = _smoke_setup()
    with torch.no_grad():
        cache, logits = prefill(tcfg, params, batch, cache_len=S + 4,
                                dtype=torch.float32)
        assert logits.shape == (B, 1, tcfg.vocab)
        cache, logits = decode_step(tcfg, params, cache,
                                    batch["tokens"][:, :1],
                                    torch.tensor(S, dtype=torch.int32))
    assert logits.shape == (B, 1, tcfg.vocab)
    assert bool(torch.isfinite(logits).all())


def test_paged_paths_refuse_the_family():
    """The paged serving paths stay decoder-only, as the JAX package's
    (``decoding.py:29,55,240``), and so does the serve CLI."""
    from repro_torch.launch import serve as serve_cli
    tcfg, params, batch = _smoke_setup()
    with pytest.raises(NotImplementedError):
        pool_layout(tcfg)
    with pytest.raises(NotImplementedError):
        decode_step_paged(tcfg, params, torch.zeros(4, 128), torch.zeros(
            (B, 1), dtype=torch.int32), torch.zeros(B, dtype=torch.int32),
            batch["tokens"][:, :1], chunk=4)
    with pytest.raises(NotImplementedError):
        prefill_suffix(tcfg, params, batch, {}, 0)
    with pytest.raises(SystemExit, match="decoder-only"):
        serve_cli.main(["--arch", ARCH, "--device", "cpu"])


# ---------------------------------------------------------------------------
# CUDA lane
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


# whisper's attention at G = 1 (its 20 / 20 heads cut to 4 / 4), Dh 64,
# non-causal: (Sq, Skv) -- decode (1), the prefill's prompt (4), the
# training decoder (448) over the encoder; and the encoder itself
WHISPER_SHAPES = [(sq, skv) for skv in (1500, 100) for sq in (1, 4, 448)] \
    + [(1500, 1500)]


def _attn_inputs(cuda, sq, skv, dtype, b=2, h=4, dh=64):
    g = torch.Generator(device=cuda).manual_seed(sq * 7 + skv)
    q, k, v, do = (torch.randn(sh, generator=g, device=cuda) for sh in
                   ((b, sq, h, dh), (b, skv, h, dh), (b, skv, h, dh),
                    (b, sq, h, dh)))
    return (t.to(dtype) for t in (q, k, v, do))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", WHISPER_SHAPES)
def test_cuda_flash_prefill_at_whisper_shapes(cuda, sq, skv, dtype):
    dt = getattr(torch, dtype)
    q, k, v, _do = _attn_inputs(cuda, sq, skv, dt)
    before = dict(FK.flash_prefill.variants)
    got = FK.flash_prefill(q, k, v, causal=False)
    (variant,) = [x for x, n in FK.flash_prefill.variants.items()
                  if n != before.get(x, 0)]
    assert variant == ("tf32x3" if dt == torch.float32 else "wgmma")
    want = flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(),
                               **(TOL if dt == torch.float32 else BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", WHISPER_SHAPES)
def test_cuda_flash_backward_at_whisper_shapes(cuda, sq, skv, dtype):
    dt = getattr(torch, dtype)
    q, k, v, do = _attn_inputs(cuda, sq, skv, dt)
    o, lse = FK.flash_prefill(q, k, v, causal=False, return_lse=True)
    got = FK.flash_backward(q, k, v, o, do, lse=lse, causal=False)
    again = FK.flash_backward(q, k, v, o, do, lse=lse, causal=False)
    want = flash_attention_backward_ref(q, k, v, o, do, causal=False)
    for a, a2, w in zip(got, again, want):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a.float(), w.float(),
                                   **(TOL if dt == torch.float32 else BF16))


@pytest.mark.cuda
def test_cuda_reduced_whisper_loss_and_grads_match_the_cpu(cuda):
    """The reduced model's loss and every gradient leaf on the card (K6 /
    K10, K8 / K11) against the plain versions on the CPU, fp32 weights."""
    tcfg = t_reduced(t_get_arch(ARCH), d_head=64, d_model=256, n_heads=4,
                     n_kv_heads=4)
    params = init_params(tcfg, torch.Generator().manual_seed(1),
                         torch.float32)
    batch = _batch(tcfg.d_model, tcfg.vocab, s_enc=150, s_dec=24, seed=2)
    cl, cg = value_and_grad(lambda p, b: loss_fn(tcfg, p, b), params,
                            _t(batch))
    dl, dg = value_and_grad(lambda p, b: loss_fn(tcfg, p, b),
                            tree_map(lambda t: t.to(cuda), params),
                            _t(batch, cuda))
    np.testing.assert_allclose(float(dl), float(cl), **LOSS)
    for a, w in zip(leaves(dg), leaves(cg)):
        scale = max(float(w.abs().max()), 1e-12)
        assert float((a.cpu() - w).abs().max()) <= GRAD_REL * scale
