"""The port's paged decode against the JAX package's: the paged-attention
plain version against the Pallas kernel (interpret mode), and a whole
``decode_step_paged`` on the reduced tinyllama config with fp32 weights
converted through ``convert.py`` -- logits within 2e-4 and identical
appended pool rows.  K4's split plan (positions per warp, CTAs per
request) covers every live position once and reads no page-table entry
past a request's pages.  A CUDA lane holds K4 against its plain version:
both variants, long lengths over many pages, unaligned columns."""
import functools

import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.decode_attention.ref import \
    paged_decode_attention_ref
from repro_torch.models import decode_step_paged, param_leaves

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ops import paged_decode_attention
    from repro.models import decode_step_paged as j_decode_step_paged
    from repro.models import init_params as j_init_params
except ImportError:      # the card's machine has no JAX: only the CUDA
    jax = None           # lane (-m cuda) runs there

TOL = dict(rtol=2e-4, atol=2e-4)


def _paged_inputs(b, h, hk, d, chunk, nb, p, layers, layer, seed):
    rng = np.random.default_rng(seed)
    te = 2 * layers * hk * d
    token_row = -(-te // 128) * 128
    pool = rng.standard_normal((nb * chunk, token_row)).astype(np.float32)
    page_rows = rng.integers(0, nb, (b, p)).astype(np.int32)
    lengths = rng.integers(0, p * chunk, b).astype(np.int32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    ck = rng.standard_normal((b, 1, hk, d)).astype(np.float32)
    cv = rng.standard_normal((b, 1, hk, d)).astype(np.float32)
    k_off, v_off = layer * hk * d, (layers + layer) * hk * d
    return (q, ck, cv, pool, page_rows, lengths), k_off, v_off


@pytest.mark.parametrize("b,h,hk,d,chunk,nb,p", [
    (3, 6, 2, 16, 4, 8, 3),
    (2, 4, 4, 32, 8, 16, 4),
    (1, 8, 1, 16, 16, 4, 2),
    (2, 32, 4, 64, 16, 8, 3),     # tinyllama's heads: G = 8, dh = 64
])
@pytest.mark.parametrize("layers,layer", [(2, 0), (2, 1)])
def test_paged_attention_plain_matches_pallas(b, h, hk, d, chunk, nb, p,
                                              layers, layer):
    arrs, k_off, v_off = _paged_inputs(b, h, hk, d, chunk, nb, p, layers,
                                       layer, b * 100 + h)
    want = paged_decode_attention(*(jnp.asarray(a) for a in arrs),
                                  chunk=chunk, k_off=k_off, v_off=v_off,
                                  hkv=hk, interpret=True)
    t = [torch.from_numpy(a) for a in arrs]
    got = paged_decode_attention_ref(*t, chunk=chunk, k_off=k_off,
                                     v_off=v_off, hkv=hk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the K4 wrapper on CPU tensors is that plain version, in the kernel's
    # grouped layout
    g = h // hk
    grouped = DK.paged_decode(t[0].reshape(b, hk, g, d),
                              t[1].reshape(b, hk, d), t[2].reshape(b, hk, d),
                              *t[3:], chunk=chunk, k_off=k_off, v_off=v_off)
    np.testing.assert_allclose(grouped.reshape(b, 1, h, d).numpy(),
                               np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _model():
    cfg = reduced(get_arch("tinyllama-1.1b"), n_layers=2, d_model=64,
                  vocab=128)
    tcfg = t_reduced(t_get_arch("tinyllama-1.1b"), n_layers=2, d_model=64,
                     vocab=128)
    params = j_init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    return cfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray,
                                                           params))


def test_converted_params_keep_counts_and_bytes():
    _cfg, _tcfg, params, tparams = _model()
    leaves = jax.tree.leaves(params)
    tl = param_leaves(tparams)
    assert sum(x.size for x in leaves) == sum(t.numel() for t in tl)
    assert (sum(x.size * x.dtype.itemsize for x in leaves)
            == sum(t.numel() * t.element_size() for t in tl))


@pytest.mark.parametrize("pool_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_step_paged_matches_jax(pool_dtype, seed):
    """One paged decode step: same pool, page tables, lengths and tokens
    through both packages -- logits within 2e-4, every appended pool row
    identical, every other row untouched."""
    cfg, tcfg, params, tparams = _model()
    rng = np.random.default_rng(seed)
    chunk, nb, p, b = 4, 24, 6, 3
    token_row = -(-2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim()
                  // 128) * 128
    pool = rng.standard_normal((nb * chunk, token_row)).astype(np.float32)
    pages = np.stack([rng.permutation(nb)[:p] for _ in range(b)]) \
        .astype(np.int32)
    lengths = rng.integers(0, p * chunk - 1, b).astype(np.int32)
    tokens = rng.integers(1, cfg.vocab, (b, 1)).astype(np.int32)
    jdt = jnp.bfloat16 if pool_dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, pool_dtype)
    jpool, jlogits = jax.jit(
        lambda pl, pr, ln, tk: j_decode_step_paged(
            cfg, params, pl, pr, ln, tk, chunk=chunk, interpret=True))(
        jnp.asarray(pool, jdt), jnp.asarray(pages), jnp.asarray(lengths),
        jnp.asarray(tokens))
    tpool = torch.from_numpy(pool).to(tdt)
    out_pool, tlogits = decode_step_paged(
        tcfg, tparams, tpool, torch.from_numpy(pages),
        torch.from_numpy(lengths), torch.from_numpy(tokens), chunk=chunk)
    assert out_pool.data_ptr() == tpool.data_ptr()      # appended in place
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    if pool_dtype == "bfloat16":
        want = np.asarray(jpool).view(np.uint16)
        got = out_pool.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got, want)
    else:
        # fp32 rows carry the raw fp32 K/V: same values within tolerance,
        # every untouched row bit-identical
        np.testing.assert_allclose(out_pool.numpy(), np.asarray(jpool),
                                   **TOL)
        touched = pages[np.arange(b), lengths // chunk] * chunk \
            + lengths % chunk
        keep = np.setdiff1d(np.arange(nb * chunk), touched)
        np.testing.assert_array_equal(out_pool.numpy()[keep], pool[keep])


# --- CUDA lane ----------------------------------------------------------------

@pytest.mark.parametrize("n_split", [1, 3, 4, 8])
@pytest.mark.parametrize("length", [0, 1, 15, 16, 17, 100, 511, 512, 513,
                                    2000])
def test_paged_plan_covers_each_live_position_once(length, n_split):
    """At chunk 16 and P = 32 (the bound 512): every position below
    min(length, P * chunk) read exactly once, nothing past it, and so no
    page-table entry past the request's live pages."""
    chunk, p_max = 16, 32
    bound = p_max * chunk
    plan = DK.paged_plan(length, bound, n_split)
    assert len(plan) == n_split
    assert all(len(w) == DK.PAGED_WARPS for w in plan)
    seen = [pos for cta in plan for warp in cta for pos in warp]
    live = min(length, bound)
    assert sorted(seen) == list(range(live))
    pages = {pos // chunk for pos in seen}
    assert pages <= set(range(-(-live // chunk)))
    for cta in plan:                       # each warp reads runs of 16
        for warp in cta:
            for a, b in zip(warp, warp[1:]):
                assert b == a + 1 or (b - warp[0]) % DK.PAGED_STAGE == 0


def test_paged_split_and_variant():
    """The wrapper's choice of K4's split (from P * chunk, no host sync)
    and variant (pure functions: no card needed)."""
    bf, f32 = torch.bfloat16, torch.float32
    # the paged path: B 8 x 4 kv heads, P 32 pages of 16 on 132 SMs
    assert DK.paged_split(32, 512, 132) == 4
    assert DK.paged_split(32, 2048 * 16, 132) == DK.MAX_SPLIT
    assert DK.paged_split(32, 16, 132) == 1
    assert DK.paged_split(4096, 512, 132) == 1      # the card is full
    for pairs, bound in ((1, 1), (8, 4096), (200, 64)):
        assert 1 <= DK.paged_split(pairs, bound, 132) <= DK.MAX_SPLIT
    assert DK.paged_variant(bf, 64, 0, 11264, 5376, 16640) == "mma"
    assert DK.paged_variant(bf, 16, 0, 1408, 672, 1376) == "mma"
    assert DK.paged_variant(bf, 64, 0, 11264, 5377, 16640) == "mma_plain"
    assert DK.paged_variant(bf, 64, 0, 11260, 5376, 16640) == "mma_plain"
    assert DK.paged_variant(bf, 64, 8, 11264, 5376, 16640) == "mma_plain"
    assert DK.paged_variant(f32, 64, 0, 11264, 5376, 16640) == "simt"
    assert DK.paged_variant(bf, 24, 0, 11264, 5376, 16640) == "simt"
    assert DK.paged_variant(bf, 256, 0, 11264, 0, 4096) == "simt"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(rtol=2e-4, atol=2e-4)),
    (torch.bfloat16, dict(rtol=3e-2, atol=3e-2))])
@pytest.mark.parametrize("b,h,hk,d,chunk,nb,p", [
    (3, 6, 2, 16, 4, 8, 3), (2, 4, 4, 128, 8, 16, 4),
    (8, 32, 4, 64, 16, 64, 32),
    # kimi-k2's attention (G 8, Dh 112) and arctic's (G 7, Dh 128)
    (8, 64, 8, 112, 16, 64, 8), (4, 56, 8, 128, 16, 64, 8),
    # glm4's (G 16 over 2 kv heads) and llama3's (G 16 over 8), Dh 128:
    # two 8-head chunks a (request, kv head)
    (8, 32, 2, 128, 16, 64, 8), (4, 128, 8, 128, 16, 64, 8)])
def test_cuda_paged_decode_matches_plain(cuda, dtype, tol, b, h, hk, d,
                                         chunk, nb, p):
    arrs, k_off, v_off = _paged_inputs(b, h, hk, d, chunk, nb, p, 22, 21,
                                       b + d)
    q, ck, cv, pool, pr, ln = (torch.from_numpy(a).to(cuda) for a in arrs)
    q, ck, cv, pool = (x.to(dtype) for x in (q, ck, cv, pool))
    g = h // hk
    n0 = DK.paged_decode.launches
    got = DK.paged_decode(q.reshape(b, hk, g, d), ck.reshape(b, hk, d),
                          cv.reshape(b, hk, d), pool, pr, ln, chunk=chunk,
                          k_off=k_off, v_off=v_off)
    assert DK.paged_decode.launches == n0 + 1
    want = paged_decode_attention_ref(q, ck, cv, pool, pr, ln, chunk=chunk,
                                      k_off=k_off, v_off=v_off, hkv=hk)
    torch.testing.assert_close(got.reshape(b, 1, h, d).float(),
                               want.float(), **tol)


@pytest.mark.cuda
def test_cuda_paged_decode_rejects_mixed_dtypes(cuda):
    """A bf16 q over an fp32 pool is refused (no launch); an fp32 q over a
    bf16 pool -- what fp32 weights make on the paged path -- is taken by
    ``test_cuda_paged_decode_fp32_q_over_bf16_pool``."""
    b, h, hk, d, chunk = 2, 4, 2, 16, 4
    arrs, k_off, v_off = _paged_inputs(b, h, hk, d, chunk, 8, 3, 22, 21, 0)
    q, ck, cv, pool, pr, ln = (torch.from_numpy(a).to(cuda) for a in arrs)
    q = q.to(torch.bfloat16)
    n0 = DK.paged_decode.launches
    with pytest.raises(TypeError):
        DK.paged_decode(q.reshape(b, hk, h // hk, d), ck.reshape(b, hk, d),
                        cv.reshape(b, hk, d), pool, pr, ln, chunk=chunk,
                        k_off=k_off, v_off=v_off)
    assert DK.paged_decode.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hk,d,chunk,nb,p", [
    (2, 4, 2, 16, 4, 8, 3), (8, 32, 4, 64, 16, 64, 32),
    (4, 32, 2, 128, 16, 64, 8)])
def test_cuda_paged_decode_fp32_q_over_bf16_pool(cuda, b, h, hk, d, chunk,
                                                 nb, p):
    """The serving path with fp32 weights: an fp32 q over the engine's bf16
    pool (the current token's K / V in the pool's dtype) runs the SIMT
    variant, within 2e-4 of the plain version, its output fp32."""
    arrs, k_off, v_off = _paged_inputs(b, h, hk, d, chunk, nb, p, 22, 21,
                                       b + d)
    q, ck, cv, pool, pr, ln = (torch.from_numpy(a).to(cuda) for a in arrs)
    ck, cv, pool = (x.to(torch.bfloat16) for x in (ck, cv, pool))
    g = h // hk
    before = dict(DK.paged_decode.variants)
    got = DK.paged_decode(q.reshape(b, hk, g, d), ck.reshape(b, hk, d),
                          cv.reshape(b, hk, d), pool, pr, ln, chunk=chunk,
                          k_off=k_off, v_off=v_off)
    assert DK.paged_decode.variants.get("simt", 0) == \
        before.get("simt", 0) + 1
    assert got.dtype == torch.float32
    want = paged_decode_attention_ref(q, ck, cv, pool, pr, ln, chunk=chunk,
                                      k_off=k_off, v_off=v_off, hkv=hk)
    torch.testing.assert_close(got.reshape(b, 1, h, d), want.float(),
                               rtol=2e-4, atol=2e-4)


BF16_ULP = dict(rtol=2 ** -7, atol=1e-5)   # one bf16 rounding step apart


def _cuda_paged(cuda, dtype, b, h, hk, d, chunk, nb, p, seed, lengths=None,
                k_off=None, v_off=None, row_pad=0):
    arrs, ko, vo = _paged_inputs(b, h, hk, d, chunk, nb, p, 22, 21, seed)
    q, ck, cv, pool, pr, ln = (torch.from_numpy(a).to(cuda) for a in arrs)
    if lengths is not None:
        ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    if row_pad:
        pool = torch.nn.functional.pad(pool, (0, row_pad))
    q, ck, cv, pool = (x.to(dtype) for x in (q, ck, cv, pool))
    ko = ko if k_off is None else k_off
    vo = vo if v_off is None else v_off
    g = h // hk
    before = dict(DK.paged_decode.variants)
    got = DK.paged_decode(q.reshape(b, hk, g, d), ck.reshape(b, hk, d),
                          cv.reshape(b, hk, d), pool, pr, ln, chunk=chunk,
                          k_off=ko, v_off=vo)
    (taken,) = [k for k, n in DK.paged_decode.variants.items()
                if n != before.get(k, 0)]
    want = paged_decode_attention_ref(q, ck, cv, pool, pr, ln, chunk=chunk,
                                      k_off=ko, v_off=vo, hkv=hk)
    return got.reshape(b, 1, h, d).float(), want.float(), taken


@pytest.mark.cuda
def test_cuda_paged_decode_long_lengths(cuda):
    """Lengths up to 2,559 over P = 160 pages, bf16 at tinyllama's heads:
    the tensor-core variant within one bf16 rounding step of the plain
    version.  (Lengths stay below P * chunk: the plain version places the
    current token at slot lengths[b], which must exist.)"""
    lengths = [0, 1, 16, 17, 700, 1999, 2048, 2559]
    got, want, taken = _cuda_paged(cuda, torch.bfloat16, len(lengths), 32, 4,
                                   64, 16, 256, 160, 5, lengths=lengths)
    assert taken == "mma"
    torch.testing.assert_close(got, want, **BF16_ULP)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hk,d,chunk,nb,p,k_off,v_off,row_pad", [
    (3, 6, 2, 16, 4, 8, 3, 3, 1001, 0),      # odd columns
    (2, 32, 4, 64, 16, 16, 4, None, None, 4),  # token row of 11268
])
def test_cuda_paged_decode_unaligned_rows(cuda, b, h, hk, d, chunk, nb, p,
                                          k_off, v_off, row_pad):
    """K/V columns or token rows off 16 bytes take the tensor-core variant
    with plain loads, within one bf16 rounding step."""
    got, want, taken = _cuda_paged(cuda, torch.bfloat16, b, h, hk, d, chunk,
                                   nb, p, b + d, k_off=k_off, v_off=v_off,
                                   row_pad=row_pad)
    assert taken == "mma_plain"
    torch.testing.assert_close(got, want, **BF16_ULP)


@pytest.mark.cuda
def test_cuda_paged_decode_variants_and_graph_replay(cuda):
    """The serving shape in bf16 (tensor cores) and fp32 (SIMT), and the
    bf16 call replayed in a CUDA graph after its lengths change on the
    device (the split is fixed by P * chunk; the positions follow)."""
    b, h, hk, d, chunk, nb, p = 8, 32, 4, 64, 16, 64, 32
    got, want, taken = _cuda_paged(cuda, torch.bfloat16, b, h, hk, d, chunk,
                                   nb, p, 7)
    assert taken == "mma"
    torch.testing.assert_close(got, want, **BF16_ULP)
    got, want, taken = _cuda_paged(cuda, torch.float32, b, h, hk, d, chunk,
                                   nb, p, 7)
    assert taken == "simt"
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    arrs, ko, vo = _paged_inputs(b, h, hk, d, chunk, nb, p, 22, 21, 8)
    q, ck, cv, pool, pr, ln = (torch.from_numpy(a).to(cuda) for a in arrs)
    q, ck, cv, pool = (x.to(torch.bfloat16) for x in (q, ck, cv, pool))
    args = (q.reshape(b, hk, h // hk, d), ck.reshape(b, hk, d),
            cv.reshape(b, hk, d), pool, pr, ln)
    kw = dict(chunk=chunk, k_off=ko, v_off=vo)
    DK.paged_decode(*args, **kw)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = DK.paged_decode(*args, **kw)
    for lens in ([0] * b, [p * chunk - 1] * b, list(range(1, 8 * b, 8))):
        ln.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        want = paged_decode_attention_ref(q, ck, cv, pool, pr, ln, **kw,
                                          hkv=hk)
        torch.testing.assert_close(out.reshape(b, 1, h, d).float(),
                                   want.float(), **BF16_ULP)
