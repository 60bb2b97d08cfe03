"""K10's plain version and the differentiable flash attention against the
JAX package's gradients, on the CPU, and (``cuda`` lane) K10 against its
plain version on the card.

``flash_attention_backward_ref`` (the closed-form dq, dk, dv over the
naive masked softmax) and ``ops.flash_attention`` under autograd (the
``torch.autograd.Function`` whose forward is K6's wrapper and backward
K10's; their plain versions on CPU tensors) are held to ``jax.grad`` of
the JAX package's ``reference_attention`` and of its blocked
``flash_attention``, over GQA, ``q_offset``, ``kv_len`` and non-causal
masks, within rtol = atol = 5e-4 (``tests/test_models.py``'s flash
gradient tolerance); so is the port's own blocked ``flash_attention``
(the CPU prefill path above S * S = 1024^2), differentiated by autograd.
On the card K10 (reading the LSE that K6 wrote) is held to the plain
version within 2e-4 (fp32) and 3e-2 (bf16) -- among the shapes a long
causal one (S 4096) at G = 1 and G = 8 -- two calls are bit-identical,
and each call counts its variant ("tf32x3" for an fp32 q, "bf16" for the
bf16 pair)."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as T
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_backward_ref, flash_attention_ref)
from repro_torch.models import attention as TA

try:
    import jax
    import jax.numpy as jnp
    from repro.models.attention import flash_attention as j_flash
    from repro.models.attention import reference_attention as j_reference
except ImportError:      # the card's machine has no JAX: only the CUDA
    jax = None           # lane (-m cuda) runs there

TOL = dict(rtol=5e-4, atol=5e-4)
FP32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)

# (b, sq, skv, h, hkv, dh, causal, q_offset, kv_len)
CASES = {"gqa": (2, 48, 48, 4, 2, 16, True, 0, None),
         "mha": (1, 40, 40, 2, 2, 32, True, 0, None),
         "q_offset": (1, 16, 80, 4, 1, 16, True, 64, None),
         "kv_len": (2, 20, 64, 4, 2, 24, True, 30, 50),
         "non_causal": (1, 24, 40, 4, 2, 16, False, 0, 33)}


def _inputs(case, seed=0):
    b, sq, skv, h, hkv, dh = CASES[case][:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    return q, k, v, do


@functools.lru_cache(maxsize=None)
def _jax_grads(jfn, case):
    """jax.grad of sum(fn(q, k, v) * dout) over q, k, v, with fn the JAX
    package's ``reference_attention`` or its blocked ``flash_attention``
    (``jfn``)."""
    fn = j_reference if jfn == "reference" else _jax_blocked
    q, k, v, do = _inputs(case)
    causal, q_offset, kv_len = CASES[case][6:]

    def f(q_, k_, v_):
        return jnp.sum(fn(q_, k_, v_, causal=causal, q_offset=q_offset,
                          kv_len=kv_len) * do)
    return [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _jax_blocked(q, k, v, **kw):
    return j_flash(q, k, v, block_q=16, block_k=16, **kw)


def _hold(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(), w, **TOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("jfn", ["reference", "blocked"])
def test_backward_ref_matches_jax_grad(case, jfn):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    causal, q_offset, kv_len = CASES[case][6:]
    o = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                            kv_len=kv_len)
    got = flash_attention_backward_ref(q, k, v, o, do, causal=causal,
                                       q_offset=q_offset, kv_len=kv_len)
    _hold(got, _jax_grads(jfn, case))


@pytest.mark.parametrize("case", list(CASES))
def test_autograd_function_matches_jax_grad(case):
    """The kernel route's Function on CPU tensors: K6's and K10's wrappers
    run their plain versions, each counted no launch."""
    q, k, v, do = (torch.from_numpy(a).requires_grad_()
                   for a in _inputs(case))
    causal, q_offset, kv_len = CASES[case][6:]
    n0 = (FK.flash_prefill.launches, FK.flash_backward.launches)
    out = T.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                            kv_len=kv_len)
    assert out.grad_fn is not None
    out.backward(do.detach())
    assert (FK.flash_prefill.launches, FK.flash_backward.launches) == n0
    _hold((q.grad, k.grad, v.grad), _jax_grads("reference", case))


def test_autograd_function_through_the_model_route(monkeypatch):
    """``models.attention.attend`` sends eligible calls to the Function
    when the kernel route is taken, and its gradients are the JAX
    package's."""
    monkeypatch.setattr(TA, "_flash_kernel_eligible",
                        lambda q, k, window: window == 0)
    q, k, v, do = (torch.from_numpy(a).requires_grad_()
                   for a in _inputs("gqa"))
    out = TA.attend(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.backward(do.detach())
    _hold((q.grad, k.grad, v.grad), _jax_grads("reference", "gqa"))


@pytest.mark.parametrize("case", ["gqa", "kv_len", "non_causal"])
def test_port_blocked_flash_is_differentiable(case):
    q, k, v, do = (torch.from_numpy(a).requires_grad_()
                   for a in _inputs(case))
    causal, q_offset, kv_len = CASES[case][6:]
    out = TA.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len, block_q=16, block_k=16)
    out.backward(do.detach())
    _hold((q.grad, k.grad, v.grad), _jax_grads("blocked", case))


def test_wrapper_checks_its_operands():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs("gqa"))
    o = flash_attention_ref(q, k, v)
    with pytest.raises(ValueError):
        FK.flash_backward(q, k, v, o[:, :-1], do)
    with pytest.raises(ValueError):
        FK.flash_backward(q, k[:, :, :1].expand(-1, -1, 3, -1), v, o, do)


def test_chip_smoke_counts_k10_cta_work():
    """``chip_smoke.k10_schedule`` (K10's CTAs and their tiles, from the
    loop bounds of ``flash_backward.cu``): at the training shape (B 4, S
    1024, 32 / 4 heads, Dh 64, causal) the heaviest dk/dv CTA carries 16
    tiles against a mean of 8.5; at the paged suffix (16 queries at
    q_offset 64, kv_len 80) every CTA carries the same."""
    import chip_smoke
    s = chip_smoke.k10_schedule(4, 1024, 1024, 32, 4, 64, 0, 1024)
    assert (s["dq_ctas"], s["dq_max"], s["dq_mean"]) == (2048, 16, 8.5)
    assert (s["dkv_ctas"], s["dkv_max"], s["dkv_mean"]) == (2048, 16, 8.5)
    s = chip_smoke.k10_schedule(1, 16, 80, 32, 4, 64, 64, 80)
    assert (s["dq_max"], s["dq_mean"], s["dkv_max"], s["dkv_mean"]) == \
        (2, 2.0, 1, 1.0)


# --- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


CUDA_SHAPES = {"train": (1, 256, 256, 32, 4, 64, True, 0, None),
               "dh128": (1, 70, 90, 8, 2, 128, True, 20, 90),
               "dh256": (1, 40, 40, 4, 4, 256, True, 0, None),
               # long and causal: the first KV block sees 64 query tiles,
               # the last one 1
               "long_g1": (1, 4096, 4096, 4, 4, 64, True, 0, None),
               "long_g8": (1, 4096, 4096, 16, 2, 64, True, 0, None)}


def _cuda_inputs(cuda, case, q_dtype, kv_dtype):
    shape = CUDA_SHAPES.get(case, CASES.get(case))
    b, sq, skv, h, hkv, dh, causal, q_offset, kv_len = shape
    g = torch.Generator(device=cuda).manual_seed(sq)
    q, k, v = (torch.randn(sh, generator=g, device=cuda) for sh in
               ((b, sq, h, dh), (b, skv, hkv, dh), (b, skv, hkv, dh)))
    do = torch.randn((b, sq, h, dh), generator=g, device=cuda)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    return (q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype),
            do.to(q_dtype), kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES) + list(CUDA_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_backward_matches_plain(cuda, case, dtype):
    dt = getattr(torch, dtype)
    q, k, v, do, kw = _cuda_inputs(cuda, case, dt, dt)
    o, lse = FK.flash_prefill(q, k, v, return_lse=True, **kw)
    n0 = FK.flash_backward.launches
    got = FK.flash_backward(q, k, v, o, do, lse=lse, **kw)
    again = FK.flash_backward(q, k, v, o, do, lse=lse, **kw)
    assert FK.flash_backward.launches == n0 + 2
    want = flash_attention_backward_ref(q, k, v, o, do, **kw)
    for a, a2, w, t in zip(got, again, want, (q, k, v)):
        assert a.dtype == t.dtype and a.shape == t.shape
        assert torch.equal(a, a2)
        torch.testing.assert_close(a.float(), w.float(),
                                   **(FP32 if dtype == "float32" else BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gqa", "kv_len", "train", "dh128"])
def test_cuda_flash_backward_fp32_q_over_bf16_kv(cuda, case):
    """The mixed pair takes the TF32 split (K/V widened to fp32 tiles):
    dq in fp32 within 2e-4, dk and dv rounded once to bf16 (3e-2)."""
    q, k, v, do, kw = _cuda_inputs(cuda, case, torch.float32,
                                   torch.bfloat16)
    o, lse = FK.flash_prefill(q, k, v, return_lse=True, **kw)
    got = FK.flash_backward(q, k, v, o, do, lse=lse, **kw)
    want = flash_attention_backward_ref(q, k, v, o, do, **kw)
    assert [t.dtype for t in got] == [torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    torch.testing.assert_close(got[0], want[0], **FP32)
    for a, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(a.float(), w.float(), **BF16)


@pytest.mark.cuda
def test_cuda_flash_backward_counts_its_variants(cuda):
    """One launch a call whatever the number of kernels, and the variant
    fixed by q's dtype; without the forward's LSE it raises."""
    FK.flash_backward.variants.clear()
    n0 = FK.flash_backward.launches
    for q_dt, kv_dt in ((torch.float32, torch.float32),
                        (torch.bfloat16, torch.bfloat16),
                        (torch.float32, torch.bfloat16)):
        q, k, v, do, kw = _cuda_inputs(cuda, "gqa", q_dt, kv_dt)
        o, lse = FK.flash_prefill(q, k, v, return_lse=True, **kw)
        FK.flash_backward(q, k, v, o, do, lse=lse, **kw)
    assert FK.flash_backward.launches == n0 + 3
    assert FK.flash_backward.variants == {"tf32x3": 2, "bf16": 1}
    with pytest.raises(ValueError, match="LSE"):
        FK.flash_backward(q, k, v, o, do, **kw)
