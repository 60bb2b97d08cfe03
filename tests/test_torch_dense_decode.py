"""The port's dense-cache decode attention against the JAX package's: the
port's ``ops.decode_attention`` (K5's plain version on CPU tensors) against
the Pallas split-KV kernel in interpret mode, the routing rule of
``models.attention.decode_attention``, and a CUDA lane holding K5 against
its plain version (skipped where there is no card)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.decode_attention import ops as T
from repro_torch.kernels.decode_attention.ref import \
    dense_decode_attention_ref
from repro_torch.models import attention as TA

try:
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ops import decode_attention as J
    from repro.models import attention as JA
except ImportError:      # the card's machine has no JAX: only the CUDA
    jnp = J = JA = None  # lane (-m cuda) runs there

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _inputs(b, h, hk, d, t, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, t, hk, d)).astype(np.float32)
    vc = rng.standard_normal((b, t, hk, d)).astype(np.float32)
    return q, kc, vc


@pytest.mark.parametrize("kv_len", [1, 100, 512, -1])       # -1: T
@pytest.mark.parametrize("b,h,hk,d,t", [
    (2, 8, 2, 64, 1024),       # test_kernels.py's GQA case
    (1, 4, 4, 128, 512),       # test_kernels.py's MHA case
    (2, 4, 4, 80, 512),        # zamba2's G = 1, head_dim 80
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_pallas(b, h, hk, d, t, kv_len,
                                               dtype):
    kv_len = t if kv_len < 0 else kv_len
    arrs = _inputs(b, h, hk, d, t, b * 1000 + d + kv_len)
    jd = getattr(jnp, dtype)
    want = J(*(jnp.asarray(a, jd) for a in arrs), jnp.int32(kv_len),
             interpret=True)
    td = getattr(torch, dtype)
    n0 = DK.dense_decode.launches
    got = T.decode_attention(*(torch.from_numpy(a).to(td) for a in arrs),
                             torch.tensor(kv_len, dtype=torch.int32))
    assert DK.dense_decode.launches == n0      # CPU: the plain version
    assert got.dtype == td and got.shape == (b, 1, h, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_decode_attention_routing_matches_jax():
    """Twin of test_kernels.py's routing test: long caches with a scalar
    length route to the kernel only where it runs (CUDA tensors here, a
    TPU there); small caches, ragged T and per-request lengths stay on the
    reference; forcing the route on CPU tensors takes K5's plain version,
    which equals the reference."""
    rng = np.random.default_rng(0)
    b, h, hk, d, t = 1, 4, 2, 64, 2048
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, 1, h, d), (b, t, hk, d), (b, t, hk, d))]
    q, kc, vc = (torch.from_numpy(a) for a in arrs)
    jq, jk, _jv = (jnp.asarray(a) for a in arrs)
    min_t = TA.DECODE_KERNEL_MIN_T
    assert min_t == JA.DECODE_KERNEL_MIN_T
    # the same shape rules: the JAX side off-TPU and the port on CPU
    # tensors both decline on the device condition alone
    assert not TA._kernel_eligible(q, kc, 100, min_t)
    assert not JA._kernel_eligible(jq, jk, jnp.int32(100), min_t)
    for port, ref in (
            ((q, kc[:, :512], 9, 2048), (jq, jk[:, :512], jnp.int32(9), 2048)),
            ((q, kc, torch.tensor([100]), 2048),
             (jq, jk, jnp.asarray([100]), 2048)),
            ((q, kc[:, :2047], 9, 2048), (jq, jk[:, :2047], jnp.int32(9),
                                          2048))):
        assert not TA._kernel_eligible(*port)
        assert not JA._kernel_eligible(*ref)
    routed = TA.decode_attention(q, kc, vc, torch.tensor(100), use_kernel=True)
    ref = TA.decode_attention(q, kc, vc, torch.tensor(100), use_kernel=False)
    np.testing.assert_allclose(routed.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_dense_decode_reads_a_layer_view_of_the_stacked_cache():
    """The wrapper takes one layer of an (L, B, T, Hkv, Dh) cache as it lies
    and agrees with the plain version on that layer; it refuses a vector
    kv_len and mismatched caches."""
    rng = np.random.default_rng(3)
    L, b, t, hk, g, d = 3, 2, 64, 2, 4, 16
    kc = torch.from_numpy(rng.standard_normal((L, b, t, hk, d))
                          .astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((L, b, t, hk, d))
                          .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, hk, g, d))
                         .astype(np.float32))
    got = DK.dense_decode(q, kc[1], vc[1], 37)
    want = dense_decode_attention_ref(q.reshape(b, 1, hk * g, d), kc[1],
                                      vc[1], 37).reshape(b, hk, g, d)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError):
        DK.dense_decode(q, kc[1], vc[1], torch.tensor([3, 4]))
    with pytest.raises(ValueError):
        DK.dense_decode(q, kc[1], vc[1, :, :32], 5)


# --- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hk,d,t,kv_len", [
    (4, 32, 4, 64, 4096, 3000),     # tinyllama's wave shape
    (4, 32, 32, 80, 4096, 2500),    # zamba2's wave shape
    (2, 8, 2, 128, 1024, 1024), (2, 8, 2, 256, 512, 1),
    (3, 6, 2, 16, 300, 257), (1, 4, 4, 64, 2048, 5000)])
def test_cuda_dense_decode_matches_plain(cuda, dtype, b, h, hk, d, t,
                                         kv_len):
    arrs = _inputs(b, h, hk, d, t, d + kv_len)
    td = getattr(torch, dtype)
    q, kc, vc = (torch.from_numpy(a).to(cuda, td) for a in arrs)
    stacked = torch.stack([kc, kc, vc])          # a layer view, strided
    n0 = DK.dense_decode.launches
    got = T.decode_attention(q, stacked[1], stacked[2],
                             torch.tensor(kv_len, dtype=torch.int32,
                                          device=cuda))
    assert DK.dense_decode.launches == n0 + 1
    want = dense_decode_attention_ref(q, kc, vc, kv_len)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
def test_cuda_decode_attention_routes_to_k5(cuda):
    arrs = _inputs(2, 8, 2, 64, 2048, 1)
    q, kc, vc = (torch.from_numpy(a).to(cuda) for a in arrs)
    n0 = DK.dense_decode.launches
    cur = torch.tensor(700, dtype=torch.int32, device=cuda)
    TA.decode_attention(q, kc, vc, cur)
    assert DK.dense_decode.launches == n0 + 1
    TA.decode_attention(q, kc[:, :1024], vc[:, :1024], cur)   # T < 2048
    assert DK.dense_decode.launches == n0 + 1
    # a float32 q over bfloat16 caches (fp32 weights on the wave path)
    got = DK.dense_decode(q.reshape(2, 2, 4, 64), kc.bfloat16(),
                          vc.bfloat16(), cur)
    want = dense_decode_attention_ref(q, kc.bfloat16(), vc.bfloat16(), cur)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.reshape(2, 1, 8, 64), want, **TOL["float32"])
    n0 += 1
    with pytest.raises(TypeError):                # bf16 q, fp32 caches
        DK.dense_decode(q.reshape(2, 2, 4, 64).bfloat16(), kc, vc, cur)
    with pytest.raises(ValueError):               # no whole 16-byte rows
        DK.dense_decode(q[..., :62].reshape(2, 2, 4, 62).contiguous(),
                        kc[..., :62], vc[..., :62], cur)
    assert DK.dense_decode.launches == n0 + 1


def _split_edges(n_split, t):
    """kv_len at 1, around the split count (where the per-CTA share and
    the number of live splits change) and at T."""
    return sorted({1, n_split - 1, n_split, n_split + 1, 2 * n_split + 1,
                   t - 1, t} - {0})


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_cuda_dense_decode_split_edges(cuda, g, d):
    """K5 at every kv_len edge of its device-side split, G 1 / 4 / 8 and
    Dh 64 / 80 / 128, bf16, over a strided layer view."""
    b, hk, t = 2, 2, 1024
    arrs = _inputs(b, hk * g, hk, d, t, g + d)
    q, kc, vc = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in arrs)
    stacked = torch.stack([vc, kc, vc])
    n_split = DK.dense_split(b * hk, "mma", t, DK.sm_count(q.device))
    for kv_len in _split_edges(n_split, t):
        kvl = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
        got = DK.dense_decode(q.reshape(b, hk, g, d), stacked[1], stacked[2],
                              kvl)
        want = dense_decode_attention_ref(q, kc, vc, kvl)
        torch.testing.assert_close(got.reshape(b, 1, hk * g, d).float(),
                                   want.float(), rtol=2 ** -7, atol=1e-5,
                                   msg=lambda m: f"kv_len {kv_len}: {m}")


@pytest.mark.cuda
def test_cuda_dense_decode_repeats_and_replays_in_a_graph(cuda):
    """The cluster's CTAs fold the splits in the same launch and leave
    nothing behind: two calls in a row agree to the bit, and a captured
    graph replayed with kv_len changed on the device agrees with the
    plain version each time (0 at kv_len = 0)."""
    b, hk, g, d, t = 4, 4, 8, 64, 4096
    arrs = _inputs(b, hk * g, hk, d, t, 11)
    q, kc, vc = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in arrs)
    qg = q.reshape(b, hk, g, d)
    kvl = torch.tensor(3000, dtype=torch.int32, device=cuda)
    first = DK.dense_decode(qg, kc, vc, kvl)
    assert torch.equal(first, DK.dense_decode(qg, kc, vc, kvl))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = DK.dense_decode(qg, kc, vc, kvl)
    for kv_len in (3000, 1, 257, 4096, 0, 2048):
        kvl.fill_(kv_len)
        graph.replay()
        want = dense_decode_attention_ref(q, kc, vc, kv_len)
        if kv_len == 0:
            assert torch.equal(out, torch.zeros_like(out))
            continue
        torch.testing.assert_close(out.reshape(b, 1, hk * g, d).float(),
                                   want.float(), rtol=2 ** -7, atol=1e-5,
                                   msg=lambda m: f"kv_len {kv_len}: {m}")


def test_dense_split_fills_the_card():
    """K5's split: one wave of CTAs over the SMs, at most one cluster of
    MAX_SPLIT CTAs a pair, never more splits than rounds of positions in
    the cache, at least one; the tensor-core variant takes the bf16 pair
    at its Dh, the SIMT variant the rest."""
    n_sm, bf16, f32 = 132, torch.bfloat16, torch.float32
    mma = DK._variant(bf16, bf16, 8, 64)
    assert mma == DK._variant(bf16, bf16, 1, 80) == "mma"
    assert DK._variant(f32, bf16, 8, 64) == 8
    assert DK._variant(bf16, bf16, 1, 8) == DK._variant(f32, f32, 1, 80) == 1
    assert DK._variant(bf16, bf16, 4, 144) == 4
    assert DK.dense_split(16, mma, 4096, n_sm) == 6        # tinyllama
    assert DK.dense_split(128, mma, 4096, n_sm) == 1       # zamba2
    assert DK.dense_split(4, mma, 4096, n_sm) == DK.MAX_SPLIT == 8
    assert DK.dense_split(128, 1, 4096, n_sm) == 4     # zamba2, fp32 q
    assert DK.dense_split(16, 8, 4096, n_sm) == 8
    assert DK.dense_split(1, mma, 64, n_sm) == 64 // DK.MIN_SPLIT_POSITIONS
    assert DK.dense_split(10 ** 6, 8, 4096, n_sm) == 1
    assert DK.dense_split(3, 1, 1, n_sm) == 1
