"""The port's SSD chunk scan against the JAX package's: the plain version of
the intra-chunk kernel against the Pallas kernel in interpret mode (the
folded (G, Q, N) contract, an overflowing decay included), the port's
``ops.ssd_scan`` on CPU tensors against the JAX ``ops.ssd_scan`` (interpret
mode) and ``models.ssm.ssd_chunked`` at ragged lengths, the kernel
wrapper's shared and per-head B/C, the routing of
``models.ssm.ssd_chunked``, and a CUDA lane holding K7 against its plain
version (skipped where there is no card).  Tolerance: fp32 rtol = atol =
2e-4 (``tests/test_kernels.py``).  The tensor-core variant's arithmetic
(``ssd_chunk_split_ref``: dt folded into M' and w * B, each split into
three bf16 parts times bf16 x) is held to the Pallas kernel on the CPU at
the same tolerance, and the card lane checks that bf16 conv views take
that variant."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import kernel as SK
from repro_torch.kernels.ssd_scan import ops as T
from repro_torch.kernels.ssd_scan.ref import (bf16_parts, ssd_chunk_ref,
                                              ssd_chunk_split_ref,
                                              ssd_intra_chunk_ref,
                                              ssd_intra_chunk_split_ref)
from repro_torch.models import ssm as TS

try:
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.kernel import ssd_intra_chunk as J_intra
    from repro.kernels.ssd_scan.ops import ssd_scan as J_scan
    from repro.models import ssm as JS
except ImportError:      # the card's machine has no JAX: only the CUDA
    jnp = J_intra = J_scan = JS = None  # lane (-m cuda) runs there

TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _scan_inputs(b, s, h, p, n, seed, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * dt_scale) \
        .astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    return x, dt, A, B, C, D


def _folded(g, q, n, p, seed, steep=False):
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((g, q, n)).astype(np.float32)
    B = rng.standard_normal((g, q, n)).astype(np.float32)
    xdt = rng.standard_normal((g, q, p)).astype(np.float32)
    step = 4.0 if steep else 0.05       # steep: exp(cum_i - cum_j) = inf
    cum = -np.cumsum(np.abs(rng.standard_normal((g, q, 1))) * step,
                     axis=1).astype(np.float32)
    return C, B, xdt, cum


@pytest.mark.parametrize("g,q,n,p,steep", [
    (3, 64, 16, 16, False), (2, 128, 32, 8, False), (2, 32, 8, 16, True)])
def test_intra_chunk_plain_matches_pallas(g, q, n, p, steep):
    arrs = _folded(g, q, n, p, q + n, steep)
    jy, jS = J_intra(*(jnp.asarray(a) for a in arrs), interpret=True)
    ty, tS = ssd_intra_chunk_ref(*(_t(a) for a in arrs))
    assert bool(torch.isfinite(ty).all() and torch.isfinite(tS).all())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), **TOL)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float()


@pytest.mark.parametrize("g,q,n,p,steep", [
    (3, 64, 16, 16, False), (2, 128, 32, 8, False), (2, 32, 8, 16, True)])
def test_intra_chunk_split_model_matches_pallas(g, q, n, p, steep):
    """K7's tensor-core arithmetic on bf16 x, B, C: dt folded into M' and
    into w * B, three bf16 parts each, against the Pallas kernel fed
    x * dt -- within the fp32 tolerance, the overflowing decay included."""
    C, B, x, cum = _folded(g, q, n, p, q + n, steep)
    C, B, x = _bf16(C), _bf16(B), _bf16(x)
    rng = np.random.default_rng(q)
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal(
        (g, q, 1)))).astype(np.float32))
    jy, jS = J_intra(*(jnp.asarray(a.numpy()) for a in (C, B, x * dt)),
                     jnp.asarray(cum), interpret=True)
    ty, tS = ssd_intra_chunk_split_ref(C, B, x, dt, _t(cum))
    assert bool(torch.isfinite(ty).all() and torch.isfinite(tS).all())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), **TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk,dt_scale", [
    (1, 100, 5, 24, 40, 64, 1.0), (2, 70, 3, 16, 16, 32, 30.0)])
def test_ssd_chunk_split_model_matches_plain(b, s, h, p, n, chunk,
                                             dt_scale):
    """On the model's layout (conv views, ragged s, one shared group):
    three parts hold the fp32 tolerance against the plain version; one
    part (P rounded once to bf16) would not."""
    x, dt, A, B, C, _D = (_t(a) for a in _scan_inputs(b, s, h, p, n, s,
                                                       dt_scale))
    x, B, C = (t.bfloat16().float() for t in (x, B, C))
    cum = _cum(dt, A, chunk)
    want = ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk)
    got = ssd_chunk_split_ref(x, dt, cum, B, C, chunk=chunk)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **TOL)
    assert len(bf16_parts(torch.ones(3), 2)) == 2
    one = ssd_intra_chunk_split_ref(
        *(torch.ones((1, 4, 1)),) * 2, torch.ones((1, 4, 1)),
        torch.full((1, 4, 1), 1 / 3), torch.zeros((1, 4, 1)))
    # 1/3 needs all three parts: y_3 = 4/3 exactly to fp32 rounding
    assert abs(float(one[0][0, 3, 0]) - 4 / 3) < 1e-6
    assert abs(float(bf16_parts(torch.tensor([1 / 3]), 1)[0][0]) * 4
               - 4 / 3) > 1e-3


def test_ssd_variant_and_heads_per_cta():
    """The wrapper's choice of K7's variant and of the tensor-core
    variant's heads per CTA (pure functions: no card needed)."""
    bf, f32 = torch.bfloat16, torch.float32
    row = 80 * 64 + 2 * 64                # zamba2's conv row (elements)
    ok = ((row * 3072, row, 64, row * 3072, row, 0), (0, 10240, 10496))
    assert SK.ssd_variant(bf, bf, 256, 64, 64, *ok) == "mma"
    assert SK.ssd_variant(bf, bf, 256, 64, 128, *ok) == "mma"
    # an fp32 x over fp32 or bf16 B/C: the tf32x3 tensor-core variant
    assert SK.ssd_variant(f32, f32, 256, 64, 64, *ok) == "tf32x3"
    assert SK.ssd_variant(f32, f32, 256, 64, 128, *ok) == "tf32x3"
    assert SK.ssd_variant(f32, bf, 256, 64, 64, *ok) == "tf32x3"
    assert SK.ssd_variant(f32, f32, 256, 64, 64, (row, row, 64, row, 2, 0),
                          ok[1]) == "tf32x3"     # B/C by plain loads
    # ... and what still takes the SIMT kernel
    assert SK.ssd_variant(f32, f32, 8, 64, 64, *ok) == "simt"     # chunk
    assert SK.ssd_variant(f32, f32, 256, 128, 64, *ok) == "simt"  # p > 64
    assert SK.ssd_variant(f32, f32, 256, 20, 64, *ok) == "simt"   # p % 8
    assert SK.ssd_variant(f32, f32, 256, 64, 256, *ok) == "simt"  # n > 128
    assert SK.ssd_variant(f32, f32, 256, 64, 64, (row, 2, 64, row, row, 0),
                          ok[1]) == "simt"       # x's stride
    assert SK.ssd_variant(f32, f32, 256, 64, 64, ok[0],
                          (8, 10240, 10496)) == "simt"     # x's pointer
    assert SK.ssd_variant(bf, f32, 256, 64, 64, *ok) == "simt"
    assert SK.ssd_variant(bf, bf, 8, 64, 64, *ok) == "simt"       # chunk
    assert SK.ssd_variant(bf, bf, 256, 128, 64, *ok) == "simt"    # p > 64
    assert SK.ssd_variant(bf, bf, 256, 20, 64, *ok) == "simt"     # p % 8
    assert SK.ssd_variant(bf, bf, 256, 64, 256, *ok) == "simt"    # n > 128
    assert SK.ssd_variant(bf, bf, 256, 64, 64, (row, row, 64, row, 4, 0),
                          ok[1]) == "simt"                         # stride
    assert SK.ssd_variant(bf, bf, 256, 64, 64, ok[0],
                          (0, 10242, 10496)) == "simt"             # pointer
    # zamba2's prefill: 48 (batch, chunk) pairs of 80 heads, 2 CTAs an SM
    assert SK.ssd_heads_per_cta(48, 80, 132, 2) == 5
    for chunks, h, per_sm in ((1, 3, 1), (48, 80, 1), (2, 16, 2),
                              (300, 7, 2)):
        k = SK.ssd_heads_per_cta(chunks, h, 132, per_sm)
        assert 1 <= k <= min(h, SK.MMA_MAX_HEADS)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 4, 8, 16, 32),       # whole chunks
    (2, 37, 4, 8, 16, 16),       # s not a multiple of the chunk
    (1, 10, 3, 16, 8, 16),       # one partial chunk
    (1, 70, 2, 4, 32, 32),
])
def test_ssd_scan_plain_matches_jax(b, s, h, p, n, chunk):
    arrs = _scan_inputs(b, s, h, p, n, s * 10 + h)
    n0 = SK.ssd_chunk.launches
    ty, tstate = T.ssd_scan(*(_t(a) for a in arrs), chunk=chunk)
    assert SK.ssd_chunk.launches == n0          # CPU: the plain version
    jy, jstate = J_scan(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                        interpret=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), **TOL)
    ry, rstate = JS.ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(rstate), **TOL)


def test_ssd_chunk_wrapper_shared_and_per_head_groups():
    """One (b, s, n) group read by every head equals its copy per head;
    positions past s act as the chunk's zero padding."""
    x, dt, A, B, C, _D = (_t(a) for a in _scan_inputs(2, 21, 3, 8, 16, 4))
    chunk = 8
    dtc = torch.nn.functional.pad(dt, (0, 0, 0, 3)).reshape(2, 3, chunk, 3)
    cum = torch.cumsum(dtc * A, dim=2)
    y1, S1 = SK.ssd_chunk(x, dt, cum, B, C, chunk=chunk)
    per_head = (B[:, :, None].expand(2, 21, 3, 16),
                C[:, :, None].expand(2, 21, 3, 16))
    y2, S2 = SK.ssd_chunk(x, dt, cum, *per_head, chunk=chunk)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(S1, S2, rtol=0, atol=0)
    assert y1.shape == (2, 3, chunk, 3, 8) and S1.shape == (2, 3, 3, 8, 16)
    with pytest.raises(ValueError):
        SK.ssd_chunk(x, dt, cum[:, :2], B, C, chunk=chunk)


def test_ssd_chunked_routing(monkeypatch):
    """On the CPU ``ssd_chunked`` keeps the plain code; routed to the
    kernel it takes ``ops.ssd_scan`` (the kernel's plain version here)."""
    arrs = tuple(_t(a) for a in _scan_inputs(1, 40, 2, 8, 16, 9))
    assert not TS._ssd_kernel_eligible(arrs[0])
    n0 = SK.ssd_chunk.launches
    plain = TS.ssd_chunked(*arrs, 16)
    monkeypatch.setattr(TS, "_ssd_kernel_eligible", lambda x: True)
    routed = TS.ssd_chunked(*arrs, 16)
    assert SK.ssd_chunk.launches == n0
    for a, b in zip(plain, routed):
        torch.testing.assert_close(a, b, **TOL)


# --- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


def _cum(dt, A, chunk):
    b, s, h = dt.shape
    pad = (-s) % chunk
    dtc = torch.nn.functional.pad(dt, (0, 0, 0, pad)).reshape(
        b, -1, chunk, h)
    return torch.cumsum(dtc * A, dim=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk,dt_scale", [
    (1, 600, 16, 64, 64, 256, 1.0),     # zamba2's chunk and widths, ragged
    (2, 256, 3, 64, 128, 256, 1.0),     # mamba2's state 128
    (1, 100, 5, 24, 40, 64, 1.0),       # widths off the tile
    (1, 64, 9, 16, 16, 32, 30.0),       # steep decay: exp overflows j > i
])
def test_cuda_ssd_chunk_matches_plain(cuda, dtype, b, s, h, p, n, chunk,
                                      dt_scale):
    x, dt, A, B, C, _D = _scan_inputs(b, s, h, p, n, s + n, dt_scale)
    td = getattr(torch, dtype)
    conv = torch.from_numpy(np.concatenate(
        [x.reshape(b, s, h * p), B, C], -1)).to(cuda, td)
    xs = conv[..., :h * p].reshape(b, s, h, p)     # the model's views
    Bs, Cs = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    dtt = torch.from_numpy(dt).to(cuda)
    cum = _cum(dtt, torch.from_numpy(A).to(cuda), chunk)
    n0 = SK.ssd_chunk.launches
    y, S = SK.ssd_chunk(xs, dtt, cum, Bs, Cs, chunk=chunk)
    assert SK.ssd_chunk.launches == n0 + 1
    wy, wS = ssd_chunk_ref(xs, dtt, cum, Bs, Cs, chunk=chunk)
    assert bool(torch.isfinite(y).all() and torch.isfinite(S).all())
    torch.testing.assert_close(y, wy, **TOL)
    torch.testing.assert_close(S, wS, **TOL)


def _taken(wrapper, before):
    """The variant of the wrapper's one launch since ``before`` (a copy of
    its ``variants`` counts)."""
    (v,) = [k for k, n in wrapper.variants.items() if n != before.get(k, 0)]
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n", [
    (2, 1000, 80, 64, 64),       # zamba2's widths, ragged
    (1, 512, 24, 64, 128),       # mamba2's state 128
])
def test_cuda_ssd_chunk_tensor_cores(cuda, b, s, h, p, n):
    """bf16 conv views take the tensor-core variant; it holds the fp32
    tolerance against the plain version and against its own arithmetic's
    model, per-head B/C included."""
    chunk = 256
    x, dt, A, B, C, _D = _scan_inputs(b, s, h, p, n, s + h)
    conv = torch.from_numpy(np.concatenate(
        [x.reshape(b, s, h * p), B, C], -1)).to(cuda, torch.bfloat16)
    xs = conv[..., :h * p].reshape(b, s, h, p)
    Bs, Cs = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    dtt = torch.from_numpy(dt).to(cuda)
    cum = _cum(dtt, torch.from_numpy(A).to(cuda), chunk)
    before = dict(SK.ssd_chunk.variants)
    y, S = SK.ssd_chunk(xs, dtt, cum, Bs, Cs, chunk=chunk)
    assert _taken(SK.ssd_chunk, before) == "mma"
    for ref in (ssd_chunk_ref, ssd_chunk_split_ref):
        wy, wS = ref(xs, dtt, cum, Bs, Cs, chunk=chunk)
        torch.testing.assert_close(y, wy, **TOL)
        torch.testing.assert_close(S, wS, **TOL)
    per_head = (Bs[:, :, None].expand(b, s, h, n).contiguous(),
                Cs[:, :, None].expand(b, s, h, n).contiguous())
    before = dict(SK.ssd_chunk.variants)
    y2, S2 = SK.ssd_chunk(xs, dtt, cum, *per_head, chunk=chunk)
    assert _taken(SK.ssd_chunk, before) == "mma"
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    torch.testing.assert_close(S2, S, rtol=0, atol=0)
    before = dict(SK.ssd_chunk.variants)
    y3, S3 = SK.ssd_chunk(xs, dtt, cum, Bs.float(), Cs.float(), chunk=chunk)
    assert _taken(SK.ssd_chunk, before) == "simt"
    torch.testing.assert_close(y3, y, **TOL)
    torch.testing.assert_close(S3, S, **TOL)


@pytest.mark.cuda
def test_cuda_ssd_per_head_groups_and_routing(cuda, monkeypatch):
    x, dt, A, B, C, D = (_t(a).to(cuda) for a in
                         _scan_inputs(2, 300, 4, 32, 16, 1))
    cum = _cum(dt, A, 128)
    Bh = torch.randn((2, 300, 4, 16), device=cuda)
    Ch = torch.randn((2, 300, 4, 16), device=cuda)
    y, S = SK.ssd_chunk(x, dt, cum, Bh, Ch, chunk=128)
    wy, wS = ssd_chunk_ref(x, dt, cum, Bh, Ch, chunk=128)
    torch.testing.assert_close(y, wy, **TOL)
    torch.testing.assert_close(S, wS, **TOL)
    n0 = SK.ssd_chunk.launches
    got = TS.ssd_chunked(x, dt, A, B, C, D, 128)       # routes to K7
    assert SK.ssd_chunk.launches == n0 + 1
    monkeypatch.setattr(TS, "_ssd_kernel_eligible", lambda x: False)
    want = TS.ssd_chunked(x, dt, A, B, C, D, 128)      # the plain code
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)
    with pytest.raises(ValueError):                    # chunk > 256
        SK.ssd_chunk(x, dt, _cum(dt, A, 512), B, C, chunk=512)
