"""K7's and K12's tf32x3 variants: fp32 products on the tensor cores as
three TF32 products of a hi / lo split, C.B^T formed once for a CTA's
heads, and (K12) the heads' dcb summed before the n-wide products dC and
dB where one group of B / C serves every head.

On the CPU, their plain PyTorch models (``ref.ssd_chunk_tf32_ref``,
``ref.ssd_chunk_backward_tf32_ref``) are held to the JAX package: K7's to
the Pallas kernel ``repro.kernels.ssd_scan.kernel.ssd_intra_chunk`` in
interpret mode, K12's to ``jax.vjp`` of the JAX kernel's per-grid-point
function on the model's layout (``tests/test_torch_ssd_backward.py``'s
``_j_intra``), with B / C shared and per head, a ragged last chunk and a
steep decay; the variant rules are pure functions.  The ``cuda`` lane
holds each kernel to its plain version (and its model) at a small shape
and at zamba2's and mamba2's training shapes, two calls bit-identical.
Tolerance: fp32 rtol = atol = 2e-4 (``tests/test_kernels.py``); K12's
outputs within 2e-4 of each one's largest magnitude (at least 1), as
``tests/test_torch_ssd_backward.py`` scales them."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import kernel as SK
from repro_torch.kernels.ssd_scan.ref import (
    ssd_chunk_backward_ref, ssd_chunk_backward_tf32_ref, ssd_chunk_ref,
    ssd_chunk_tf32_ref, ssd_intra_chunk_ref, ssd_intra_chunk_tf32_ref,
    tf32_parts, tf32x3_matmul)

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.kernel import ssd_intra_chunk as J_intra
    from test_torch_ssd_backward import _j_intra
except ImportError:      # the card's machine has no JAX: only the CUDA
    jax = None           # lane (-m cuda) runs there

TOL = dict(rtol=2e-4, atol=2e-4)
SCALED = 2e-4


def _close_scaled(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= SCALED * scale, (what, err, scale)


def test_tf32_parts_and_three_products():
    """hi is TF32 (13 low bits clear), lo the rest within 2^-11 |a|; the
    three products give the fp32 product where one TF32 product would
    not."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((96, 48)).astype(np.float32))
    hi, lo = tf32_parts(a)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((a - hi).abs() <= a.abs() * 2.0 ** -11).all())
    exact = a.double() @ b.double()
    err3 = float((tf32x3_matmul(a, b).double() - exact).abs().max())
    err1 = float((tf32_parts(a)[0] @ tf32_parts(b)[0]).double()
                 .sub(exact).abs().max())
    assert err3 < 1e-4 < err1, (err3, err1)


def _folded(g, q, n, p, seed, steep=False):
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((g, q, n)).astype(np.float32)
    B = rng.standard_normal((g, q, n)).astype(np.float32)
    x = rng.standard_normal((g, q, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((g, q, 1)))).astype(np.float32)
    step = 4.0 if steep else 0.05       # steep: exp(cum_i - cum_j) = inf
    cum = -np.cumsum(np.abs(rng.standard_normal((g, q, 1))) * step,
                     axis=1).astype(np.float32)
    return C, B, x, dt, cum


@pytest.mark.skipif(jax is None, reason="needs JAX")
@pytest.mark.parametrize("g,q,n,p,steep", [
    (3, 64, 16, 16, False), (2, 128, 32, 8, False), (2, 32, 8, 16, True),
    (1, 256, 64, 64, False)])
def test_intra_chunk_tf32_model_matches_pallas(g, q, n, p, steep):
    """K7's tf32x3 arithmetic against the Pallas kernel fed x * dt,
    within the fp32 tolerance, the overflowing decay included."""
    C, B, x, dt, cum = _folded(g, q, n, p, q + n, steep)
    jy, jS = J_intra(*(jnp.asarray(a) for a in (C, B, x * dt, cum)),
                     interpret=True)
    ty, tS = ssd_intra_chunk_tf32_ref(*(torch.from_numpy(a) for a in
                                        (C, B, x, dt, cum)))
    assert bool(torch.isfinite(ty).all() and torch.isfinite(tS).all())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), **TOL)


def _scan_case(b, s, h, p, n, chunk, shared, bc_dtype=torch.float32,
               dt_scale=1.0, seed=0):
    """K7's operands on the model's layout from numpy: x, B and C column
    views of one projection (B / C shared) or B / C per head, dt, cum."""
    rng = np.random.default_rng(seed)
    f = np.float32
    nc = -(-s // chunk)
    proj = torch.from_numpy(rng.standard_normal(
        (b, s, h * p + 2 * n)).astype(f))
    x = proj[..., :h * p].reshape(b, s, h, p)
    if shared:
        B, C = proj[..., h * p:h * p + n], proj[..., h * p + n:]
    else:
        B, C = (torch.from_numpy(rng.standard_normal((b, s, h, n)).astype(f))
                for _ in range(2))
    B, C = B.to(bc_dtype), C.to(bc_dtype)
    dt = torch.from_numpy((np.log1p(np.exp(rng.standard_normal((b, s, h))))
                           * dt_scale).astype(f))
    A = torch.from_numpy(-np.exp(0.5 * rng.standard_normal(h)).astype(f))
    cum = torch.cumsum((torch.nn.functional.pad(dt, (0, 0, 0, nc * chunk - s))
                        * A).reshape(b, nc, chunk, h), dim=2)
    return x, dt, cum, B, C


SCAN_CASES = [(1, 100, 5, 24, 40, 64, True, torch.float32, 1.0),
              (2, 70, 3, 16, 16, 32, False, torch.float32, 30.0),
              (1, 300, 2, 64, 128, 256, True, torch.bfloat16, 1.0)]


@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_ssd_chunk_tf32_model_matches_plain(case):
    """On the model's layout (conv views, ragged s, B / C shared or per
    head, bf16 B / C widened): the tf32x3 model holds the plain version."""
    *shape, chunk, shared, bc_dtype, dt_scale = case
    ops = _scan_case(*shape, chunk, shared, bc_dtype, dt_scale)
    for a, w in zip(ssd_chunk_tf32_ref(*ops, chunk=chunk),
                    ssd_chunk_ref(*ops, chunk=chunk)):
        torch.testing.assert_close(a, w, **TOL)


# b, s, h, p, n, chunk, shared, steep: shared and per-head groups, ragged
# last chunks, a steep decay (exp(cum_i - cum_j) overflows past i)
BWD_CASES = [(2, 40, 3, 8, 6, 16, True, False),
             (1, 37, 2, 5, 4, 8, False, False),
             (2, 100, 3, 16, 16, 64, True, False),
             (1, 70, 2, 16, 32, 64, False, False),
             (1, 50, 3, 8, 8, 32, True, True)]


def _bwd_inputs(b, s, h, p, n, chunk, shared, steep, seed=0):
    rng = np.random.default_rng(seed)
    nc = -(-s // chunk)
    bshape = (b, s, n) if shared else (b, s, h, n)
    f = np.float32
    step = 3.0 if steep else 0.2
    return dict(
        x=rng.standard_normal((b, s, h, p)).astype(f),
        dt=(0.05 + 0.5 * rng.random((b, s, h))).astype(f),
        cum=np.cumsum(-step * rng.random((b, nc, chunk, h)),
                      axis=2).astype(f),
        B=rng.standard_normal(bshape).astype(f),
        C=rng.standard_normal(bshape).astype(f),
        dy=rng.standard_normal((b, nc, chunk, h, p)).astype(f),
        dS=rng.standard_normal((b, nc, h, p, n)).astype(f))


@pytest.mark.skipif(jax is None, reason="needs JAX")
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_backward_tf32_model_matches_jax_vjp(case):
    """K12's tf32x3 arithmetic (the heads' dcb summed first where B / C
    are shared) against ``jax.vjp`` of the JAX kernel's function."""
    *shape, chunk, shared, steep = case
    a = _bwd_inputs(*shape, chunk, shared, steep)
    _fwd, vjp = jax.vjp(lambda *t: _j_intra(*t, chunk), a["x"], a["dt"],
                        a["cum"], a["B"], a["C"])
    want = vjp((a["dy"], a["dS"]))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = ssd_chunk_backward_tf32_ref(t["x"], t["dt"], t["cum"], t["B"],
                                      t["C"], t["dy"], t["dS"], chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dcum", "dB", "dC"), got, want):
        assert bool(torch.isfinite(g).all()), name
        _close_scaled(g.numpy(), w, name)


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_backward_tf32_model_matches_plain(case):
    """The same model against the closed-form plain version on the CPU."""
    *shape, chunk, shared, steep = case
    t = {k: torch.from_numpy(v) for k, v in
         _bwd_inputs(*shape, chunk, shared, steep, seed=1).items()}
    args = (t["x"], t["dt"], t["cum"], t["B"], t["C"], t["dy"], t["dS"])
    for name, g, w in zip(("dx", "ddt", "dcum", "dB", "dC"),
                          ssd_chunk_backward_tf32_ref(*args, chunk=chunk),
                          ssd_chunk_backward_ref(*args, chunk=chunk)):
        _close_scaled(g.numpy(), w.numpy(), name)


def test_intra_chunk_models_agree():
    """The folded plain version and the tf32x3 model on one input (x and
    dt apart in the model, x * dt in the plain version)."""
    C, B, x, dt, cum = (torch.from_numpy(a) for a in
                        _folded(2, 48, 24, 16, 7))
    for a, w in zip(ssd_intra_chunk_tf32_ref(C, B, x, dt, cum),
                    ssd_intra_chunk_ref(C, B, x * dt, cum)):
        torch.testing.assert_close(a, w, **TOL)


def test_ssd_backward_variant_and_heads_per_cta():
    """K12's variant rule and the tf32x3 variant's heads per CTA (pure
    functions: no card needed)."""
    assert SK.ssd_backward_variant(256, 64, 64) == "tf32x3"     # zamba2
    assert SK.ssd_backward_variant(256, 64, 128) == "tf32x3"    # mamba2
    assert SK.ssd_backward_variant(128, 16, 16) == "tf32x3"
    assert SK.ssd_backward_variant(32, 64, 64) == "simt"        # chunk
    assert SK.ssd_backward_variant(96, 64, 64) == "simt"        # chunk % 64
    assert SK.ssd_backward_variant(256, 128, 64) == "simt"      # p > 64
    assert SK.ssd_backward_variant(256, 24, 64) == "simt"       # p % 16
    assert SK.ssd_backward_variant(256, 64, 12) == "simt"       # n % 16
    assert SK.ssd_backward_variant(256, 64, 256) == "simt"      # n > 128
    # zamba2 (2 x 4 chunks, 80 heads) and mamba2 (8 x 4, 24 heads) on 132
    # SMs: every CTA takes several heads, so C.B^T and the n-wide products
    # run for several heads at once
    k_z = SK.ssd_bwd_heads_per_cta(8, 4, 80, 64, 64, 132)
    k_m = SK.ssd_bwd_heads_per_cta(32, 4, 24, 64, 128, 132)
    assert 4 <= k_z <= 80 and 4 <= k_m <= 24, (k_z, k_m)
    for chunks, nblk, h in ((1, 1, 1), (1, 2, 3), (300, 4, 7)):
        assert 1 <= SK.ssd_bwd_heads_per_cta(chunks, nblk, h, 64, 64,
                                             132) <= h


def test_wrappers_keep_the_plain_versions_on_the_cpu():
    """On CPU tensors the entry points run the plain versions, not the
    models, and launch nothing."""
    x, dt, cum, B, C = _scan_case(1, 100, 3, 16, 16, 64, True)
    n0, b0 = SK.ssd_chunk.launches, SK.ssd_chunk_backward.launches
    for a, w in zip(SK.ssd_chunk(x, dt, cum, B, C, chunk=64),
                    ssd_chunk_ref(x, dt, cum, B, C, chunk=64)):
        assert torch.equal(a, w)
    g = torch.Generator().manual_seed(0)
    dy = torch.randn((1, 2, 64, 3, 16), generator=g)
    dS = torch.randn((1, 2, 3, 16, 16), generator=g)
    for a, w in zip(SK.ssd_chunk_backward(x, dt, cum, B, C, dy, dS,
                                          chunk=64),
                    ssd_chunk_backward_ref(x, dt, cum, B, C, dy, dS,
                                           chunk=64)):
        assert torch.equal(a, w)
    assert (SK.ssd_chunk.launches, SK.ssd_chunk_backward.launches) == \
        (n0, b0)


# --- cuda lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


def _taken(wrapper, before):
    (v,) = [k for k, n in wrapper.variants.items() if n != before.get(k, 0)]
    return v


# b, s, h, p, n, chunk, shared, B / C dtype
K7_CARD = [(1, 100, 5, 24, 40, 64, True, torch.float32),
           (2, 300, 3, 64, 64, 256, False, torch.float32),
           (1, 300, 3, 64, 128, 128, True, torch.float32),
           (1, 500, 4, 64, 128, 256, True, torch.bfloat16),
           (2, 1024, 80, 64, 64, 256, True, torch.float32),    # zamba2
           (8, 1024, 24, 64, 128, 256, True, torch.float32)]   # mamba2


@pytest.mark.cuda
@pytest.mark.parametrize("case", K7_CARD, ids=str)
def test_cuda_ssd_chunk_tf32x3(cuda, case):
    """fp32 x (a view of the conv output) takes the tf32x3 variant; y and
    S within 2e-4 of the plain version and of the model, two calls
    bit-identical."""
    *shape, chunk, shared, bc_dtype = case
    ops = [t.to(cuda) for t in _scan_case(*shape, chunk, shared, bc_dtype)]
    before = dict(SK.ssd_chunk.variants)
    y, S = SK.ssd_chunk(*ops, chunk=chunk)
    assert _taken(SK.ssd_chunk, before) == "tf32x3"
    y2, S2 = SK.ssd_chunk(*ops, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(S, S2)
    for ref in (ssd_chunk_ref, ssd_chunk_tf32_ref):
        wy, wS = ref(*ops, chunk=chunk)
        torch.testing.assert_close(y, wy, **TOL)
        torch.testing.assert_close(S, wS, **TOL)


# b, s, h, p, n, chunk, shared, x dtype, B / C dtype
K12_CARD = [(1, 100, 3, 16, 16, 64, True, torch.float32, torch.float32),
            (2, 300, 3, 64, 48, 128, False, torch.float32, torch.float32),
            (1, 400, 4, 64, 128, 256, True, torch.bfloat16, torch.bfloat16),
            (2, 1024, 80, 64, 64, 256, True, torch.float32,
             torch.float32),                                       # zamba2
            (8, 1024, 24, 64, 128, 256, True, torch.float32,
             torch.float32)]                                       # mamba2


@pytest.mark.cuda
@pytest.mark.parametrize("case", K12_CARD, ids=str)
def test_cuda_ssd_chunk_backward_tf32x3(cuda, case):
    """K12 takes the tf32x3 variant; every output within 2e-4 of its
    largest magnitude against the plain version (bf16 outputs 3e-2), two
    calls bit-identical."""
    *shape, chunk, shared, x_dtype, bc_dtype = case
    b, s, h, p, n = shape
    x, dt, cum, B, C = (t.to(cuda) for t in _scan_case(
        b, s, h, p, n, chunk, shared, bc_dtype))
    x = x.to(x_dtype)
    g = torch.Generator(device=cuda).manual_seed(1)
    nc = cum.shape[1]
    dy = torch.randn((b, nc, chunk, h, p), generator=g, device=cuda)
    dS = torch.randn((b, nc, h, p, n), generator=g, device=cuda)
    args = (x, dt, cum, B, C, dy, dS)
    before = dict(SK.ssd_chunk_backward.variants)
    got = SK.ssd_chunk_backward(*args, chunk=chunk)
    assert _taken(SK.ssd_chunk_backward, before) == "tf32x3"
    again = SK.ssd_chunk_backward(*args, chunk=chunk)
    want = ssd_chunk_backward_ref(*args, chunk=chunk)
    for name, a, a2, w in zip(("dx", "ddt", "dcum", "dB", "dC"), got, again,
                              want):
        assert torch.equal(a, a2), name
        tol = SCALED if a.dtype == torch.float32 else 3e-2
        scale = max(float(w.float().abs().max()), 1.0)
        err = float((a.float() - w.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)
