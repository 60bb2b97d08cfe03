"""The port's lease ops (K1-K3's contracts) against the JAX package's
Pallas ops in interpret mode, bit for bit; plus a CUDA lane holding each
kernel against its plain version (skipped where there is no card)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.tardis_lease import kernel as K
from repro_torch.kernels.tardis_lease import ops as T
from repro_torch.kernels.tardis_lease import ref as R

try:
    import jax.numpy as jnp
    from repro.kernels.tardis_lease import ops as J
except ImportError:      # the card's machine has no JAX: only the CUDA
    jnp = J = None       # lane (-m cuda) runs there


def _tables(n, seed):
    rng = np.random.default_rng(seed)
    wts = rng.integers(0, 100, n).astype(np.int32)
    rts = np.maximum(wts, rng.integers(0, 120, n)).astype(np.int32)
    req = np.where(rng.random(n) < 0.5, wts, wts - 1).astype(np.int32)
    lvec = rng.integers(1, 40, n).astype(np.int32)
    return rng, wts, rts, req, lvec


def _cmp(jout, tout, keys):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(jout[k]),
                                      tout[k].numpy(), err_msg=k)


KEYS = ("new_rts", "renew_ok", "expired", "write_ts", "new_pts")


@pytest.mark.parametrize("n", [7, 128, 1000])
@pytest.mark.parametrize("pts", [0, 55])
@pytest.mark.parametrize("per_block", [False, True])
def test_masked_lease_check(n, pts, per_block):
    rng, wts, rts, req, lvec = _tables(n, n + pts)
    mask = rng.integers(0, 2, n).astype(np.int32)
    lease = lvec if per_block else 10
    want = J.masked_lease_check(
        jnp.asarray(wts), jnp.asarray(rts), jnp.asarray(req),
        jnp.asarray(mask), pts,
        jnp.asarray(lvec) if per_block else lease, interpret=True)
    t = [torch.from_numpy(x) for x in (wts, rts, req, mask)]
    got = T.masked_lease_check(*t, pts, lease)
    _cmp(want, got, KEYS)
    # and the port's ops equal its protocol-composed oracle
    lt = torch.from_numpy(lvec) if per_block else torch.tensor(10)
    _cmp({k: v.numpy() for k, v in
          R.masked_lease_check_ref(*t, torch.tensor(pts), lt).items()},
         got, KEYS)


@pytest.mark.parametrize("n", [7, 300])
@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("per_block", [False, True])
def test_masked_lease_check_many(n, groups, per_block):
    rng, wts, rts, req, lvec = _tables(n, 10 * n + groups)
    masks = rng.integers(0, 2, (groups, n)).astype(np.int32)
    pts = rng.integers(0, 120, groups).astype(np.int32)
    lease = lvec if per_block else 10
    want = J.masked_lease_check_many(
        jnp.asarray(wts), jnp.asarray(rts), jnp.asarray(req),
        jnp.asarray(masks), jnp.asarray(pts),
        jnp.asarray(lvec) if per_block else lease, interpret=True)
    t = [torch.from_numpy(x) for x in (wts, rts, req, masks, pts)]
    got = T.masked_lease_check_many(*t, lease)
    _cmp(want, got, KEYS)
    lt = torch.from_numpy(lvec) if per_block else torch.tensor(10)
    _cmp({k: v.numpy() for k, v in
          R.masked_lease_check_many_ref(*t, lt).items()}, got, KEYS)


@pytest.mark.parametrize("n", [7, 128, 1000])
@pytest.mark.parametrize("pts", [0, 55, 500])
def test_write_advance(n, pts):
    rng, wts, rts, _req, _l = _tables(n, n * 3 + pts)
    mask = rng.integers(0, 2, n).astype(np.int32)
    want = J.write_advance(jnp.asarray(wts), jnp.asarray(rts),
                           jnp.asarray(mask), pts, interpret=True)
    t = [torch.from_numpy(x) for x in (wts, rts, mask)]
    got = T.write_advance(*t, pts)
    oracle = R.write_advance_oracle(*t, torch.tensor(pts))
    for w, g, o in zip(want, got, oracle):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        np.testing.assert_array_equal(o.numpy(), g.numpy())


@pytest.mark.parametrize("pts", [-3, 0, 55])
def test_write_advance_takes_an_empty_table(pts):
    """K2's plain version at N = 0, as K1's: ts = max(pts, 0) (the max
    over no entry is its identity, -1), and empty tables back."""
    e = torch.zeros(0, dtype=torch.int32)
    new_wts, new_rts, ts = K.write_advance(e, e, e, pts)
    assert new_wts.shape == new_rts.shape == (0,)
    assert ts.dtype == torch.int32 and int(ts) == max(pts, 0)


@pytest.mark.parametrize("n", [7, 1000])
@pytest.mark.parametrize("pts,lease", [(0, 10), (1000, 64)])
def test_lease_check(n, pts, lease):
    _rng, wts, rts, req, _l = _tables(n, n)
    want = J.lease_check(jnp.asarray(wts), jnp.asarray(rts),
                         jnp.asarray(req), pts, lease, interpret=True)
    got = T.lease_check(*(torch.from_numpy(x) for x in (wts, rts, req)),
                        pts, lease)
    _cmp(want, got, KEYS)


def _pool(rng, n, w):
    return rng.standard_normal((n, w)).astype(np.float32)


@pytest.mark.parametrize("col_lo,width", [(0, None), (128, 256), (256, 128)])
def test_gather_blocks_windows(col_lo, width):
    rng = np.random.default_rng(col_lo)
    pool = _pool(rng, 16, 512)
    idx = np.asarray([3, 0, 15, 3, 7], np.int32)
    want = J.gather_blocks(jnp.asarray(pool), jnp.asarray(idx), col_lo=col_lo,
                           width=width, interpret=True)
    got = T.gather_blocks(torch.from_numpy(pool), idx, col_lo=col_lo,
                          width=width)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("n,w,rows_w,col_lo,width", [
    (8, 256, 256, 0, None), (16, 512, 300, 0, None),
    (16, 512, 100, 128, 256), (16, 512, 128, 384, 128)])
def test_append_rows_windows_and_duplicates(n, w, rows_w, col_lo, width):
    """Rows land at their ids inside the window, every other bit stays,
    and a duplicate id keeps the LAST listed row."""
    rng = np.random.default_rng(n + rows_w)
    pool = _pool(rng, n, w)
    idx = np.asarray([2, 0, n - 1, 2], np.int32)          # duplicate id
    rows = rng.standard_normal((4, rows_w)).astype(np.float32)
    want = J.append_rows(jnp.asarray(pool), jnp.asarray(idx),
                         jnp.asarray(rows), col_lo=col_lo, width=width,
                         interpret=True)
    tp = torch.from_numpy(pool.copy())
    got = T.append_rows(tp, idx, torch.from_numpy(rows), col_lo=col_lo,
                        width=width)
    assert got.data_ptr() == tp.data_ptr()                # in place
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_append_rows_bf16_pool_bits():
    """bf16 pools compare bit for bit through their int16/uint16 views."""
    rng = np.random.default_rng(5)
    pool = _pool(rng, 12, 256)
    idx = np.asarray([4, 1, 4, 11, 1], np.int32)
    rows = rng.standard_normal((5, 200)).astype(np.float32)
    want = J.append_rows(jnp.asarray(pool, jnp.bfloat16), jnp.asarray(idx),
                         jnp.asarray(rows), interpret=True)
    tp = torch.from_numpy(pool).to(torch.bfloat16)
    got = T.append_rows(tp, idx, torch.from_numpy(rows))
    np.testing.assert_array_equal(np.asarray(want).view(np.uint16),
                                  got.view(torch.int16).numpy()
                                  .view(np.uint16))


def test_wrappers_count_no_launch_on_cpu():
    """On CPU tensors the wrappers run the plain versions: no launch."""
    before = {f: f.launches for f in (K.lease_pass, K.write_advance,
                                      K.gather_rows, K.scatter_rows)}
    test_masked_lease_check(7, 0, False)
    test_gather_blocks_windows(0, None)
    test_append_rows_windows_and_duplicates(8, 256, 256, 0, None)
    for f, n in before.items():
        assert f.launches == n


# --- CUDA lane: each kernel against its plain version on the card ---------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,groups,per_block", [(7, 1, False),
                                                (4608, 4, False),
                                                (1000, 3, True)])
def test_cuda_lease_pass_matches_plain(cuda, n, groups, per_block):
    rng, wts, rts, req, lvec = _tables(n, n)
    masks = rng.integers(0, 2, (groups, n)).astype(np.int32)
    pts = rng.integers(0, 120, groups).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (wts, rts, req, masks, pts)]
    lease = torch.from_numpy(lvec).to(cuda) if per_block else 10
    n0 = K.lease_pass.launches
    got = K.lease_pass(*args, lease)
    want = R.lease_pass_ref(*args, lease)
    assert K.lease_pass.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 5, 1025, 4608, 9000])
@pytest.mark.parametrize("groups", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("per_block", [False, True])
def test_cuda_lease_pass_one_cluster_matches_plain(cuda, n, groups,
                                                  per_block):
    """K1 as one cluster launch, no output pre-filled: bit for bit at N
    empty, short of one CTA, past a multiple of the 1024-entry CTA, at the
    serving table and past the 8 CTAs' one round; G = 1-8; the static
    lease and the predictor's lease vector.  The outputs start as garbage
    (a poisoned cache allocation) so a value the kernel never writes
    shows."""
    rng, wts, rts, req, lvec = _tables(n, 31 * n + groups)
    masks = rng.integers(0, 2, (groups, n)).astype(np.int32)
    pts = rng.integers(0, 120, groups).astype(np.int32)
    pts[0] = -3                           # new_pts clamps at 0
    args = [torch.from_numpy(x).to(cuda) for x in (wts, rts, req, masks, pts)]
    lease = torch.from_numpy(lvec).to(cuda) if per_block else 10
    torch.full((1 << 16,), -7, dtype=torch.int32, device=cuda)  # poison
    n0 = K.lease_pass.launches
    got = K.lease_pass(*args, lease)
    assert K.lease_pass.launches == n0 + 1
    for g, w in zip(got, R.lease_pass_ref(*args, lease)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_lease_pass_holds_at_most_64_groups(cuda):
    rng, wts, rts, req, _l = _tables(300, 3)
    args = [torch.from_numpy(x).to(cuda) for x in (wts, rts, req)]
    for groups in (64, 65):
        masks = torch.from_numpy(rng.integers(0, 2, (groups, 300)).astype(
            np.int32)).to(cuda)
        pts = torch.from_numpy(rng.integers(0, 120, groups).astype(
            np.int32)).to(cuda)
        if groups > K.MAX_GROUPS:
            with pytest.raises(ValueError):
                K.lease_pass(*args, masks, pts, 10)
            continue
        for g, w in zip(K.lease_pass(*args, masks, pts, 10),
                        R.lease_pass_ref(*args, masks, pts, 10)):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 7, 4608, 9000, 30000, 70000])
@pytest.mark.parametrize("masked", ["random", "none", "all"])
def test_cuda_write_advance_matches_plain(cuda, n, masked):
    """K2 in one launch, no output pre-filled: bit for bit at N empty, on
    one CTA, at the serving table (a cluster of 5 CTAs), on a cluster of
    8 whose threads hold 2 and 4 entries in registers, and past the
    cluster's registers (the entries read twice); random masks, no block
    masked and every block masked.  The outputs start as garbage (a
    poisoned cache allocation) so a value the kernel never writes
    shows."""
    rng, wts, rts, _r, _l = _tables(n, n + len(masked))
    mask = {"random": rng.integers(0, 2, n), "none": np.zeros(n),
            "all": np.ones(n)}[masked].astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (wts, rts, mask)]
    for pts in (-3, 77, 500):
        torch.full((1 << 18,), -7, dtype=torch.int32, device=cuda)
        n0 = K.write_advance.launches
        got = K.write_advance(*args, pts)
        assert K.write_advance.launches == n0 + 1
        for g, w in zip(got, R.write_advance_ref(*args, pts)):
            assert torch.equal(g, w), pts


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4608, 70000])
def test_cuda_write_advance_is_one_device_kernel(cuda, n):
    """One device kernel a call (the parent ran two), counted from the
    nodes of a CUDA graph captured of the call (chip_smoke's
    ``graph_nodes``, which sees the kernel library's launches whatever
    ``torch.profiler`` records): exactly one node, a kernel whose name
    contains ``write_advance`` -- no other kernel, fill or copy."""
    import chip_smoke as cs
    rng, wts, rts, _r, _l = _tables(n, 5)
    mask = rng.integers(0, 2, n).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (wts, rts, mask)]
    per_call = cs.graph_nodes(lambda: K.write_advance(*args, 9))
    assert list(per_call.values()) == [1], per_call
    assert "write_advance" in next(iter(per_call)), per_call


def test_write_advance_ctas():
    """One entry a thread: one CTA up to 1024 entries, the serving table
    a cluster of 5 CTAs, at most 8."""
    assert K.write_advance_ctas(0) == K.write_advance_ctas(1024) == 1
    assert K.write_advance_ctas(1025) == 2
    assert K.write_advance_ctas(4608) == 5
    assert K.write_advance_ctas(9000) == K.write_advance_ctas(70000) \
        == K.MAX_CLUSTER


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row,col_lo,width", [(512, 0, 512),
                                               (512, 128, 256),
                                               (9600, 1152, 8320)])
def test_cuda_row_copy_matches_plain(cuda, dtype, row, col_lo, width):
    # the 9600-wide case spans several of the kernel's column slices
    g = torch.Generator(device=cuda).manual_seed(0)
    pool = torch.randn((64, row), generator=g, device=cuda).to(dtype)
    idx = torch.tensor([5, 9, 5, 63, 0, 9], dtype=torch.int32, device=cuda)
    assert torch.equal(K.gather_rows(pool, idx, col_lo=col_lo, width=width),
                       R.gather_rows_ref(pool, idx, col_lo, width))
    rows = torch.randn((6, width), generator=g, device=cuda).to(dtype)
    a, b = pool.clone(), pool.clone()
    K.scatter_rows(a, idx, rows, col_lo=col_lo)
    R.scatter_rows_ref(b, idx, rows, col_lo)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("col_lo,width", [(0, 11264), (2560, 8704)])
def test_cuda_row_copy_many_entries_and_duplicates(cuda, dtype, col_lo,
                                                   width):
    """300 entries (the scatter's duplicate scan spans several strides of
    a CTA's threads), one id listed at the first, a middle and the last
    position and another twice mid-list: bit for bit the plain versions,
    the last listed row winning."""
    g = torch.Generator(device=cuda).manual_seed(1)
    n_rows, row = 4096, 11264
    pool = torch.randn((n_rows, row), generator=g, device=cuda).to(dtype)
    idx = torch.randperm(n_rows, generator=g, device=cuda)[:300]
    idx = idx.to(torch.int32)
    idx[0] = idx[150] = idx[299] = 7
    idx[40] = idx[41] = 9
    assert torch.equal(K.gather_rows(pool, idx, col_lo=col_lo, width=width),
                       R.gather_rows_ref(pool, idx, col_lo, width))
    rows = torch.randn((300, width), generator=g, device=cuda).to(dtype)
    a, b = pool.clone(), pool.clone()
    n0 = K.scatter_rows.launches
    K.scatter_rows(a, idx, rows, col_lo=col_lo)
    assert K.scatter_rows.launches == n0 + 1
    R.scatter_rows_ref(b, idx, rows, col_lo)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int8), b.view(torch.int8))
    assert torch.equal(a[7, col_lo:col_lo + width], rows[299])


@pytest.mark.cuda
def test_cuda_empty_probe_counts_nothing(cuda):
    """The library's empty kernel (the one-launch floor timed beside K3)
    launches and counts no kernel of any path."""
    before = {f: f.launches for f in (K.lease_pass, K.write_advance,
                                      K.gather_rows, K.scatter_rows)}
    K.empty_probe()
    torch.cuda.synchronize()
    assert {f: f.launches for f in before} == before
