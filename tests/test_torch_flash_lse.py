"""The LSE that K6 hands K10: the plain ``flash_attention_lse_ref``
against ``jax.nn.logsumexp`` of the JAX package's
masked, scaled scores (its ``reference_attention``'s ``q.k * Dh ** -0.5``
under the causal / ``kv_len`` mask), over GQA, ``kv_len``, ``q_offset``,
non-causal masks and rows with no live key (+inf); K6's wrapper
returning it with ``return_lse``; the differentiable
``ops.flash_attention`` saving it for its backward and still matching
``jax.grad``; and (``cuda`` lane) K6's LSE against the plain one, in
each of K6's variants (tf32x3 for an fp32 q over fp32 or bf16 K/V,
wgmma for the bf16 pair).  Tolerances: fp32 rtol = atol = 2e-4
(``tests/test_kernels.py``), the gradients 5e-4 as in
``tests/test_torch_flash_backward.py``."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as T
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_lse_ref, flash_attention_ref)

try:
    import jax
    import jax.numpy as jnp
    from repro.models.attention import reference_attention as j_reference
except ImportError:      # the card's machine has no JAX: only the CUDA
    jax = None           # lane (-m cuda) runs there

FP32 = dict(rtol=2e-4, atol=2e-4)
GRAD = dict(rtol=5e-4, atol=5e-4)

# (b, sq, skv, h, hkv, dh, causal, q_offset, kv_len)
CASES = {"gqa": (2, 48, 48, 4, 2, 16, True, 0, None),
         "mha": (1, 40, 40, 2, 2, 32, True, 0, None),
         "q_offset": (1, 16, 80, 4, 1, 16, True, 64, None),
         "kv_len": (2, 20, 64, 4, 2, 24, True, 30, 50),
         "non_causal": (1, 24, 40, 4, 2, 16, False, 0, 33),
         # rows with no live key (kv_len 0), causal and not
         "dead_rows": (1, 10, 32, 4, 2, 16, True, 20, 0),
         "dead_rows_non_causal": (1, 12, 40, 2, 1, 16, False, 0, 0)}


def _inputs(case, seed=0):
    b, sq, skv, h, hkv, dh = CASES[case][:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    return q, k, v, do


def _jax_lse(q, k, causal, q_offset, kv_len):
    """logsumexp over the live keys of q.k * Dh ** -0.5, (B, H, Sq); +inf
    where a row has none."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kv_len = skv if kv_len is None else kv_len
    s = jnp.einsum("bqkgd,btkd->bkgqt",
                   jnp.asarray(q).reshape(b, sq, hkv, h // hkv, dh),
                   jnp.asarray(k)) * dh ** -0.5
    qpos = q_offset + jnp.arange(sq)
    kpos = jnp.arange(skv)
    mask = (kpos[None, :] < kv_len) & jnp.ones((sq, 1), bool)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    lse = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)
    lse = jnp.where(mask.any(-1), lse, jnp.inf)
    return np.asarray(lse.reshape(b, h, sq))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_lse_matches_jax_logsumexp(case):
    q, k, _v, _do = _inputs(case)
    causal, q_offset, kv_len = CASES[case][6:]
    lse = flash_attention_lse_ref(
        *(torch.from_numpy(a) for a in (q, k)), causal=causal,
        q_offset=q_offset, kv_len=kv_len)
    want = _jax_lse(q, k, causal, q_offset, kv_len)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    dead = np.isinf(want)
    assert np.array_equal(np.isinf(lse.numpy()), dead)
    assert (lse.numpy()[dead] > 0).all()
    np.testing.assert_allclose(lse.numpy()[~dead], want[~dead], **FP32)
    if case.startswith("dead"):
        assert dead.any()


@functools.lru_cache(maxsize=None)
def _jax_grads(case):
    q, k, v, do = _inputs(case)
    causal, q_offset, kv_len = CASES[case][6:]

    def f(q_, k_, v_):
        return jnp.sum(j_reference(q_, k_, v_, causal=causal,
                                   q_offset=q_offset, kv_len=kv_len) * do)
    return [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("case", ["gqa", "q_offset", "kv_len",
                                  "non_causal"])
def test_autograd_function_saves_the_lse_for_its_backward(case,
                                                          monkeypatch):
    """The Function's forward asks K6's wrapper for the LSE and hands it
    to K10's wrapper; the gradients stay JAX's."""
    q, k, v, do = (torch.from_numpy(a).requires_grad_()
                   for a in _inputs(case))
    causal, q_offset, kv_len = CASES[case][6:]
    seen = {}
    fb = T.flash_backward

    def spy(*a, **kw):
        seen.update(kw)
        return fb(*a, **kw)

    monkeypatch.setattr(T, "flash_backward", spy)
    out = T.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                            kv_len=kv_len)
    assert isinstance(out, torch.Tensor)
    out.backward(do.detach())
    lse = seen["lse"]
    assert lse is not None and lse.dtype == torch.float32
    np.testing.assert_allclose(
        lse.numpy(), _jax_lse(*(a.detach().numpy() for a in (q, k)), causal,
                              q_offset, kv_len), **FP32)
    for g, w in zip((q.grad, k.grad, v.grad), _jax_grads(case)):
        np.testing.assert_allclose(g.numpy(), w, **GRAD)


def test_wrapper_return_lse_on_cpu_is_the_plain_pair():
    q, k, v, _do = (torch.from_numpy(a) for a in _inputs("kv_len"))
    kw = dict(q_offset=30, kv_len=50)
    n0 = FK.flash_prefill.launches
    out, lse = FK.flash_prefill(q, k, v, return_lse=True, **kw)
    assert FK.flash_prefill.launches == n0        # CPU: the plain version
    assert torch.equal(out, flash_attention_ref(q, k, v, **kw))
    assert torch.equal(lse, flash_attention_lse_ref(q, k, **kw))
    assert torch.equal(FK.flash_prefill(q, k, v, **kw), out)


def test_backward_wrapper_checks_the_lse_shape():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs("gqa"))
    o, lse = FK.flash_prefill(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        FK.flash_backward(q, k, v, o, do, lse=lse.transpose(1, 2))
    # on CPU tensors the plain version needs no LSE: with or without it
    # the result is the same
    got = FK.flash_backward(q, k, v, o, do, lse=lse)
    for a, b in zip(got, FK.flash_backward(q, k, v, o, do)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,want", [(torch.float32, "tf32x3"),
                                        (torch.bfloat16, "bf16")])
def test_backward_variant_is_fixed_by_q_dtype(dtype, want):
    assert FK.variant_of(dtype) == want


# --- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES) + ["train", "dh80_g1",
                                                "dh128"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_k6_lse_matches_plain(cuda, case, dtype):
    """Both of K6's variants at these dtypes (fp32: tf32x3; bf16: TMA +
    wgmma where Dh is a multiple of 16 up to 128) write the LSE from
    their running max and sum; rows with no live key get +inf.  The output is the one K6 gives
    with the LSE write off, bit for bit."""
    shape = {"train": (1, 256, 256, 32, 4, 64, True, 0, None),
             "dh80_g1": (2, 100, 100, 4, 4, 80, True, 0, None),
             "dh128": (1, 70, 90, 8, 2, 128, True, 20, 90)}.get(
                 case, CASES.get(case))
    b, sq, skv, h, hkv, dh, causal, q_offset, kv_len = shape
    g = torch.Generator(device=cuda).manual_seed(sq + dh)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(sh, generator=g, device=cuda).to(dt) for sh in
               ((b, sq, h, dh), (b, skv, hkv, dh), (b, skv, hkv, dh)))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    n0 = FK.flash_prefill.launches
    out, lse = FK.flash_prefill(q, k, v, return_lse=True, **kw)
    assert FK.flash_prefill.launches == n0 + 1
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    assert torch.equal(out, FK.flash_prefill(q, k, v, **kw))
    want = flash_attention_lse_ref(q, k, **kw)
    dead = torch.isinf(want)
    assert torch.equal(torch.isinf(lse), dead)
    assert bool((lse[dead] > 0).all())
    torch.testing.assert_close(lse[~dead], want[~dead], **FP32)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["dead_rows", "dead_rows_non_causal",
                                  "kv_len", "train", "dh80_g1", "dh112_g8",
                                  "dh128"])
def test_cuda_k6_tf32x3_lse_matches_plain(cuda, case, kv_dtype):
    """K6's tf32x3 variant (an fp32 q over fp32 or bf16 K/V) writes the LSE
    from its running max and sum within 2e-4 of the plain LSE, +inf on a
    row with no live key; its output is the same bits with the LSE write
    off."""
    shape = {"train": (1, 256, 256, 32, 4, 64, True, 0, None),
             "dh80_g1": (2, 100, 100, 4, 4, 80, True, 0, None),
             "dh112_g8": (1, 40, 96, 16, 2, 112, True, 50, 90),
             "dh128": (1, 70, 90, 8, 2, 128, True, 20, 90)}.get(
                 case, CASES.get(case))
    b, sq, skv, h, hkv, dh, causal, q_offset, kv_len = shape
    g = torch.Generator(device=cuda).manual_seed(sq + dh + 1)
    q, k, v = (torch.randn(sh, generator=g, device=cuda) for sh in
               ((b, sq, h, dh), (b, skv, hkv, dh), (b, skv, hkv, dh)))
    k, v = k.to(getattr(torch, kv_dtype)), v.to(getattr(torch, kv_dtype))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    n0 = FK.flash_prefill.variants.get("tf32x3", 0)
    out, lse = FK.flash_prefill(q, k, v, return_lse=True, **kw)
    assert FK.flash_prefill.variants["tf32x3"] == n0 + 1
    assert torch.equal(out, FK.flash_prefill(q, k, v, **kw))
    want = flash_attention_lse_ref(q, k, **kw)
    dead = torch.isinf(want)
    # a row with no live key: 0 from the kernel (the plain version gives
    # the mean of V there)
    dead_rows = dead.transpose(1, 2)[..., None].expand_as(out)
    assert bool((out[dead_rows] == 0).all())
    torch.testing.assert_close(
        out[~dead_rows], flash_attention_ref(q, k, v, **kw)[~dead_rows],
        **FP32)
    assert torch.equal(torch.isinf(lse), dead)
    assert bool((lse[dead] > 0).all())
    torch.testing.assert_close(lse[~dead], want[~dead], **FP32)
