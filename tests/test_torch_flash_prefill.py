"""The port's causal GQA flash prefill against the JAX package's: the plain
version (what the port's ``ops.flash_attention`` runs on CPU tensors)
against the Pallas kernel in interpret mode at the shapes it accepts
(lengths dividing by 128, or below 128), against the JAX reference at
ragged lengths with ``q_offset`` / ``kv_len`` (G in {1, 4}, Dh 64 and 80),
the routing of ``models.attention.attend``, K6's variant choice by dtype
pair, Dh and view, a numpy model of the tf32x3 variant's arithmetic (three
TF32 products of a hi / lo split) held to the JAX reference, and a CUDA
lane holding K6 against its plain version (skipped where there is no
card).  Tolerances:
fp32 rtol = atol = 2e-4, bf16 3e-2 (``tests/test_kernels.py``).  Every
case keeps ``kv_len`` above the first query's position: a row with no
live key is 0 in the kernel and the mean of V in the plain version (the
CUDA lane asserts the kernel's 0 there)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as T
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_lse_ref, flash_attention_ref)
from repro_torch.models import attention as TA

try:
    import jax.numpy as jnp
    from repro.kernels.flash_attention.kernel import flash_attention_bhsd
    from repro.kernels.flash_attention.ref import flash_attention_ref as J_ref
    from repro.models import attention as JA
except ImportError:      # the card's machine has no JAX: only the CUDA
    jnp = J_ref = JA = None  # lane (-m cuda) runs there

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def J(q, k, v, *, causal, q_offset, kv_len):
    """The JAX ``ops.flash_attention`` steps (transpose to (B, H, S, Dh),
    pad Dh to 128) around the Pallas kernel in interpret mode, with
    ``kv_len`` kept static as the kernel takes it (the jitted ops wrapper
    would trace it)."""
    dh = q.shape[-1]
    pad = [(0, 0)] * 3 + [(0, (-dh) % 128)]
    qt, kt, vt = (jnp.pad(a, pad).transpose(0, 2, 1, 3) for a in (q, k, v))
    out = flash_attention_bhsd(qt, kt, vt, causal=causal, q_offset=q_offset,
                               kv_len=kv_len, scale=dh ** -0.5,
                               interpret=True)
    return out.transpose(0, 2, 1, 3)[..., :dh]


def _inputs(b, sq, skv, h, hk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,sq,skv,h,hk,d,q_offset,kv_len", [
    (1, 128, 128, 4, 1, 64, 0, None),       # G = 4, whole blocks
    (2, 256, 256, 2, 2, 80, 0, None),       # G = 1, Dh 80, 2 x 2 blocks
    (1, 16, 80, 8, 2, 64, 64, 80),          # the paged suffix prefill
    (1, 64, 96, 4, 4, 80, 32, 90),          # suffix, kv_len < Skv
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(b, sq, skv, h, hk, d, q_offset, kv_len,
                                    dtype):
    arrs = _inputs(b, sq, skv, h, hk, d, sq + skv + d)
    jd = getattr(jnp, dtype)
    want = J(*(jnp.asarray(a, jd) for a in arrs), causal=True,
             q_offset=q_offset, kv_len=kv_len)
    td = getattr(torch, dtype)
    n0 = FK.flash_prefill.launches
    got = T.flash_attention(*(torch.from_numpy(a).to(td) for a in arrs),
                            causal=True, q_offset=q_offset, kv_len=kv_len)
    assert FK.flash_prefill.launches == n0      # CPU: the plain version
    assert got.dtype == td and got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("b,sq,skv,h,hk,d,q_offset,kv_len,causal", [
    (2, 50, 50, 8, 2, 64, 0, None, True),   # ragged prompt, G = 4
    (1, 37, 37, 4, 4, 80, 0, None, True),   # G = 1, Dh 80
    (2, 16, 96, 8, 2, 64, 70, 86, True),    # suffix in a longer cache
    (1, 9, 130, 4, 1, 80, 121, 130, True),
    (2, 20, 45, 4, 1, 64, 0, 33, False),    # non-causal, kv_len < Skv
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_ref_at_ragged_shapes(
        b, sq, skv, h, hk, d, q_offset, kv_len, causal, dtype):
    arrs = _inputs(b, sq, skv, h, hk, d, 7 * sq + skv)
    jd = getattr(jnp, dtype)
    want = J_ref(*(jnp.asarray(a, jd) for a in arrs), causal=causal,
                 q_offset=q_offset, kv_len=kv_len)
    td = getattr(torch, dtype)
    got = flash_attention_ref(*(torch.from_numpy(a).to(td) for a in arrs),
                              causal=causal, q_offset=q_offset,
                              kv_len=kv_len)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])
    # the wrapper on CPU tensors is that plain version
    wrapped = FK.flash_prefill(*(torch.from_numpy(a).to(td) for a in arrs),
                               causal=causal, q_offset=q_offset,
                               kv_len=kv_len)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("sq,skv,window", [(16, 16, 0), (40, 40, 8),
                                           (1100, 1100, 0)])
def test_attend_routing_keeps_the_jax_rule_on_cpu(monkeypatch, sq, skv,
                                                  window):
    """On CPU tensors ``attend`` follows the JAX package's dispatch bit for
    bit in value (reference below 1024^2 scores, blocked flash above);
    with the device check forced it takes the ops wrapper (the kernel's
    plain version here); a window never goes to the kernel."""
    arrs = _inputs(1, sq, skv, 4, 2, 16, sq + window)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    assert not TA._flash_kernel_eligible(q, k, window)
    n0 = FK.flash_prefill.launches
    got = TA.attend(q, k, v, causal=True, window=window)
    want = JA.attend(*(jnp.asarray(a) for a in arrs), causal=True,
                     window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    if sq * skv <= 1024 ** 2:
        ref = TA.reference_attention(q, k, v, causal=True, window=window)
    else:
        ref = TA.flash_attention(q, k, v, causal=True, window=window)
    assert torch.equal(got, ref)
    monkeypatch.setattr(TA, "_flash_kernel_eligible",
                        lambda q, k, window: window == 0)
    routed = TA.attend(q, k, v, causal=True, window=window)
    if window:
        assert torch.equal(routed, got)
    else:
        assert torch.equal(routed, flash_attention_ref(q, k, v, causal=True))
    assert FK.flash_prefill.launches == n0


def test_flash_wrapper_checks_shapes():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 6, 4, 16, 0))
    with pytest.raises(ValueError):             # 6 heads over 4 KV heads
        FK.flash_prefill(q, k, v)
    with pytest.raises(ValueError):
        FK.flash_prefill(q[..., :4, :], k, v[:, :4])
    assert FK.takes(torch.float32, torch.bfloat16, 80)
    assert not FK.takes(torch.bfloat16, torch.float32, 64)
    assert not FK.takes(torch.float32, torch.float32, 260)
    assert not FK.takes(torch.float32, torch.float32, 36)


# --- K6's variants -----------------------------------------------------------

def _kv_view(dtype, d, *, misalign=False, stride_pad=0):
    """A (1, 8, 2, d) K (or V) view on the CPU: a layer of a stacked cache
    whose head stride is d + ``stride_pad`` elements, its base one element
    past a 16-byte boundary where ``misalign``."""
    base = torch.zeros((3, 1, 8, 2, d + stride_pad), dtype=dtype)
    view = base[1, ..., int(misalign):int(misalign) + d]
    assert view.stride(3) == 1
    return view


@pytest.mark.parametrize("q_dtype,kv_dtype,d,view,want", [
    (torch.float32, torch.float32, 64, {}, "tf32x3"),     # training's pair
    (torch.float32, torch.float32, 8, {}, "tf32x3"),
    (torch.float32, torch.float32, 80, {"misalign": True, "stride_pad": 8},
     "tf32x3"),
    (torch.float32, torch.bfloat16, 112, {}, "tf32x3"),
    (torch.float32, torch.bfloat16, 128, {"stride_pad": 3}, "tf32x3"),
    (torch.float32, torch.float32, 136, {}, "simt"),      # past Dh 128
    (torch.float32, torch.float32, 256, {}, "simt"),
    (torch.bfloat16, torch.bfloat16, 64, {}, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 80, {"stride_pad": 8}, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 72, {}, "simt"),     # not a k16 step
    (torch.bfloat16, torch.bfloat16, 128, {"stride_pad": 3}, "simt"),
    (torch.bfloat16, torch.bfloat16, 64, {"misalign": True, "stride_pad": 8},
     "simt"),
    (torch.bfloat16, torch.bfloat16, 256, {}, "simt"),
])
def test_variant_choice_by_dtype_pair_dh_and_view(q_dtype, kv_dtype, d, view,
                                                 want):
    """tf32x3 takes every fp32 q up to Dh 128 over any view; wgmma the bf16
    pair where Dh is a multiple of 16 up to 128 and TMA maps the view
    (strides in whole 16-byte units, 16-byte aligned bases); simt the
    rest.  The choice is made on the host, so it holds on CPU tensors."""
    q = torch.zeros((1, 4, 4, d), dtype=q_dtype)
    k = _kv_view(kv_dtype, d, **view)
    v = _kv_view(kv_dtype, d, **view)
    assert FK.pick_variant(q, k, v) == want


def _split_tf32(x):
    """split_tf32 (tardis_hopper.cuh) in numpy: hi = x rounded to TF32 by
    the kernel's integer rounding, lo = x - hi exactly, both fp32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)
    return hi, (np.asarray(x, np.float32) - hi).astype(np.float32)


def _tf32(x):
    """What the mma reads of an fp32 register: its top 19 bits."""
    return (np.asarray(x, np.float32).view(np.uint32)
            & np.uint32(0xffffe000)).view(np.float32)


def _tf32x3(a, b, products=3):
    """a @ b as the tf32x3 variant forms it: a_lo b_hi + a_hi b_lo + a_hi
    b_hi of the split (the mma reading lo's top 19 bits, a_lo b_lo
    dropped), products=2 for a b exact in TF32 (bf16 K/V), 1 for plain
    TF32; each product exact in float64, the sum rounded to fp32."""
    ah, al = _split_tf32(a)
    bh, bl = _split_tf32(b)
    f = np.float64
    out = ah.astype(f) @ bh.astype(f)
    if products >= 2:
        out += _tf32(al).astype(f) @ bh.astype(f)
    if products >= 3:
        out += ah.astype(f) @ _tf32(bl).astype(f)
    return out.astype(np.float32)


def _attention_model(q, k, v, *, causal, q_offset, kv_len, products):
    """Masked softmax attention with both products through _tf32x3 (a row
    with no live key gives 0, as K6 does)."""
    b, sq, h, d = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    out = np.zeros_like(q)
    qpos = q_offset + np.arange(sq)
    live = np.arange(skv)[None, :] < kv_len
    if causal:
        live = live & (np.arange(skv)[None, :] <= qpos[:, None])
    for bi in range(b):
        for hi in range(h):
            s = _tf32x3(q[bi, :, hi], k[bi, :, hi // g].T, products)
            s = np.where(live, s * np.float32(d ** -0.5), -np.inf)
            m = s.max(axis=1, keepdims=True)
            p = np.where(live, np.exp(s - np.where(np.isfinite(m), m, 0)), 0.)
            p = p.astype(np.float32)
            acc = _tf32x3(p, v[bi, :, hi // g], products)
            out[bi, :, hi] = acc / np.maximum(p.sum(axis=1, keepdims=True),
                                              1e-30)
    return out


@pytest.mark.parametrize("kv_bf16", [False, True])
@pytest.mark.parametrize("b,sq,skv,h,hk,d,q_offset,kv_len,causal", [
    (1, 40, 70, 8, 2, 64, 30, 65, True),     # suffix, kv_len < Skv, G 4
    (2, 33, 33, 4, 4, 80, 0, 33, True),      # G 1, Dh 80
    (1, 24, 50, 4, 1, 112, 0, 41, False),    # non-causal, Dh 112
])
def test_tf32x3_arithmetic_holds_the_fp32_tolerance(
        kv_bf16, b, sq, skv, h, hk, d, q_offset, kv_len, causal):
    """The tf32x3 variant's arithmetic, modelled in numpy, within fp32's
    2e-4 of the JAX reference before any card runs it; with bf16 K/V
    (exact in TF32) two products per step suffice.  Plain TF32 (one
    product) is far from it: the split is what holds the tolerance."""
    q, k, v = _inputs(b, sq, skv, h, hk, d, sq + d)
    if kv_bf16:      # K/V values a bf16 pool holds, widened to fp32
        k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (k, v))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    want = np.asarray(J_ref(*(jnp.asarray(a) for a in (q, k, v)), **kw),
                      np.float32)
    got = _attention_model(q, k, v, products=2 if kv_bf16 else 3, **kw)
    np.testing.assert_allclose(got, want, **TOL["float32"])
    err = np.abs(got - want).max()
    err_one = np.abs(_attention_model(q, k, v, products=1, **kw)
                     - want).max()
    assert err < err_one / 20, (err, err_one)


# --- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


PAIRS = {"fp32": (torch.float32, torch.float32, TOL["float32"]),
         "bf16": (torch.bfloat16, torch.bfloat16, TOL["bfloat16"]),
         "fp32/bf16": (torch.float32, torch.bfloat16, TOL["float32"])}


@pytest.mark.cuda
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("b,sq,skv,h,hk,d,q_offset,kv_len,causal", [
    (2, 300, 300, 32, 4, 64, 0, None, True),   # tinyllama's heads, ragged
    (1, 200, 200, 8, 8, 80, 0, None, True),    # zamba2's heads
    (1, 16, 96, 32, 4, 64, 64, 80, True),      # paged suffix in a cache
    (2, 7, 7, 3, 1, 256, 0, None, True),       # G = 3, Dh 256
    (1, 70, 130, 6, 2, 8, 60, 130, True),      # Dh 8
    (2, 65, 129, 4, 2, 128, 0, 100, False),    # non-causal, kv_len < Skv
])
def test_cuda_flash_prefill_matches_plain(cuda, pair, b, sq, skv, h, hk, d,
                                          q_offset, kv_len, causal):
    qd, kd, tol = PAIRS[pair]
    arrs = _inputs(b, sq, skv, h, hk, d, sq * 3 + d)
    q = torch.from_numpy(arrs[0]).to(cuda, qd)
    k, v = (torch.from_numpy(a).to(cuda, kd) for a in arrs[1:])
    n0 = FK.flash_prefill.launches
    got = T.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                            kv_len=kv_len)
    assert FK.flash_prefill.launches == n0 + 1
    want = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len)
    assert got.dtype == qd
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hk,d", [(2, 64), (8, 80), (1, 128)])
def test_cuda_flash_prefill_bf16_within_its_p_rounding(cuda, hk, d):
    """The bf16 pair's tensor-core variant rounds P to bf16 for P.V (l sums
    the fp32 P): each weight within 2^-9 of itself moves the output by at
    most 2^-9 max|v| from the plain version's, then both round once to
    bf16 (one rounding step apart at most)."""
    arrs = _inputs(1, 1024, 1024, 8, hk, d, d)
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in arrs)
    got = FK.flash_prefill(q, k, v)
    want = flash_attention_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -9 * float(v.abs().max()) + 1e-5)


@pytest.mark.cuda
def test_cuda_flash_prefill_reads_cache_views_and_masks_dead_rows(cuda):
    """A layer view of a stacked (L, B, T, Hkv, Dh) cache is read in place;
    a row with no live key gives 0 (the TPU kernel's guard)."""
    arrs = _inputs(2, 16, 96, 8, 2, 64, 5)
    q = torch.from_numpy(arrs[0]).to(cuda)
    k, v = (torch.from_numpy(a).to(cuda) for a in arrs[1:])
    stacked = torch.stack([k, k, v])
    got = FK.flash_prefill(q, stacked[1], stacked[2], q_offset=64, kv_len=80)
    want = flash_attention_ref(q, k, v, q_offset=64, kv_len=80)
    torch.testing.assert_close(got, want, **TOL["float32"])
    dead = FK.flash_prefill(q, k, v, causal=False, kv_len=0)
    assert torch.equal(dead, torch.zeros_like(dead))
    n0 = FK.flash_prefill.launches
    TA.attend(q, k, v, causal=True, q_offset=64, kv_len=80)   # routes to K6
    TA.attend(q, k, v, causal=True, q_offset=64, kv_len=80, window=16)
    assert FK.flash_prefill.launches == n0 + 1
    with pytest.raises(TypeError):               # bf16 q over fp32 K/V
        FK.flash_prefill(q.bfloat16(), k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 112, 128])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("sq,skv,q_offset,kv_len", [
    (200, 200, 0, None),         # Sq * G not a multiple of 128 at G = 1
    (16, 80, 64, 80),            # the paged suffix (16 queries at 64)
    (77, 160, 60, 100),          # kv_len below q_offset + Sq
])
def test_cuda_flash_prefill_wgmma_shapes(cuda, d, g, sq, skv, q_offset,
                                         kv_len):
    """The bf16 pair's TMA + wgmma variant at each Dh it tiles differently
    (one 64-column atom, one and a fifth, two), G 1 and 8, ragged row
    counts, the suffix shape and kv_len cutting the causal window, over a
    layer view of a stacked cache (strided, read in place by the tensor
    map): within the P rounding bound of the plain version."""
    hk = 2
    arrs = _inputs(2, sq, skv, hk * g, hk, d, sq + d + g)
    q = torch.from_numpy(arrs[0]).to(cuda, torch.bfloat16)
    k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in arrs[1:])
    stacked = torch.stack([v, k, v])
    n0 = FK.flash_prefill.launches
    got = FK.flash_prefill(q, stacked[1], stacked[2], q_offset=q_offset,
                           kv_len=kv_len)
    assert FK.flash_prefill.launches == n0 + 1
    want = flash_attention_ref(q, k, v, q_offset=q_offset, kv_len=kv_len)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -9 * float(v.abs().max()) + 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hk,d", [(32, 4, 64), (32, 32, 80)])
def test_cuda_flash_prefill_bf16_bound_at_the_wave_shapes(cuda, h, hk, d):
    """The 2^-9 max|v| bound (plus one bf16 rounding step) at both wave
    paths' prefill shapes (tinyllama, zamba2), 3072 positions, one
    request."""
    arrs = _inputs(1, 3072, 3072, h, hk, d, h + d)
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in arrs)
    got = FK.flash_prefill(q, k, v)
    want = flash_attention_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -9 * float(v.abs().max()) + 1e-5)


@pytest.mark.cuda
def test_cuda_flash_prefill_bf16_dead_rows_are_zero(cuda):
    """A bf16 row with no live key gives 0 on the wgmma variant, as on the
    SIMT one."""
    arrs = _inputs(1, 40, 64, 8, 2, 64, 9)
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in arrs)
    dead = FK.flash_prefill(q, k, v, causal=False, kv_len=0)
    assert torch.equal(dead, torch.zeros_like(dead))
    got = FK.flash_prefill(q, k, v, q_offset=0, kv_len=20)   # rows >= 20 live
    want = flash_attention_ref(q, k, v, q_offset=0, kv_len=20)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -9 * float(v.abs().max()) + 1e-5)


F32_PAIRS = {"fp32": torch.float32, "fp32/bf16": torch.bfloat16}


@pytest.mark.cuda
@pytest.mark.parametrize("pair", list(F32_PAIRS))
@pytest.mark.parametrize("d", [64, 80, 112, 128])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("sq,skv,q_offset,kv_len,causal", [
    (200, 200, 0, None, True),       # ragged Sq * G, whole prompt
    (16, 80, 64, 80, True),          # the paged suffix (16 queries at 64)
    (77, 160, 60, 100, True),        # kv_len below q_offset + Sq
    (50, 130, 0, 97, False),         # non-causal, kv_len < Skv
])
def test_cuda_flash_prefill_tf32x3_shapes(cuda, pair, d, g, sq, skv,
                                          q_offset, kv_len, causal):
    """K6's tf32x3 variant (an fp32 q over fp32 or bf16 K/V) at each Dh the
    fp32 paths use, G 1 and 8, ragged lengths, the causal window cut by
    kv_len, non-causal, over a layer view of a stacked cache: within
    fp32's 2e-4 of the plain version, the variant counted."""
    hk = 2
    arrs = _inputs(2, sq, skv, hk * g, hk, d, sq + d + g)
    q = torch.from_numpy(arrs[0]).to(cuda)
    k, v = (torch.from_numpy(a).to(cuda, F32_PAIRS[pair]) for a in arrs[1:])
    stacked = torch.stack([v, k, v])
    before = dict(FK.flash_prefill.variants)
    got = FK.flash_prefill(q, stacked[1], stacked[2], causal=causal,
                           q_offset=q_offset, kv_len=kv_len)
    assert FK.flash_prefill.variants.get("tf32x3", 0) == \
        before.get("tf32x3", 0) + 1
    want = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, **TOL["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("pair", list(F32_PAIRS))
def test_cuda_flash_prefill_tf32x3_dead_rows_and_lse(cuda, pair):
    """Rows with no live key give 0 and an LSE of +inf on the tf32x3
    variant; the output is the same bits with and without the LSE write,
    and a second call replays the first bit for bit."""
    arrs = _inputs(2, 40, 64, 16, 2, 64, 11)
    q = torch.from_numpy(arrs[0]).to(cuda)
    k, v = (torch.from_numpy(a).to(cuda, F32_PAIRS[pair]) for a in arrs[1:])
    dead, lse = FK.flash_prefill(q, k, v, causal=False, kv_len=0,
                                 return_lse=True)
    assert torch.equal(dead, torch.zeros_like(dead))
    assert bool(torch.isinf(lse).all()) and bool((lse > 0).all())
    # kv_len 20: rows 0-19 live under the causal mask, 20-39 see 0-19
    kw = dict(q_offset=0, kv_len=20)
    out, lse = FK.flash_prefill(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, FK.flash_prefill(q, k, v, **kw))
    assert torch.equal(out, FK.flash_prefill(q, k, v, **kw))
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, **kw),
                               **TOL["float32"])
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, **kw),
                               **TOL["float32"])


@pytest.mark.cuda
def test_cuda_flash_prefill_counts_variants(cuda):
    """One call of each pair lands in ``flash_prefill.variants`` under its
    variant; Dh 256 still takes the SIMT kernel."""
    FK.flash_prefill.variants.clear()
    for qd, kd, d in ((torch.float32, torch.float32, 64),
                      (torch.float32, torch.bfloat16, 64),
                      (torch.bfloat16, torch.bfloat16, 64),
                      (torch.float32, torch.float32, 256),
                      (torch.bfloat16, torch.bfloat16, 256)):
        arrs = _inputs(1, 16, 16, 4, 2, d, d)
        q = torch.from_numpy(arrs[0]).to(cuda, qd)
        k, v = (torch.from_numpy(a).to(cuda, kd) for a in arrs[1:])
        got = FK.flash_prefill(q, k, v)
        torch.testing.assert_close(
            got.float(), flash_attention_ref(q, k, v).float(),
            **TOL["float32" if qd == torch.float32 else "bfloat16"])
    assert FK.flash_prefill.variants == {"tf32x3": 2, "wgmma": 1,
                                         "simt": 2}
