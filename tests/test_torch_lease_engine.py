"""The port's LeaseEngine against the JAX package's numpy-backed engine on
random op streams: identical tables, read results, LeaseStats, free list,
validity bits and pool bits after every op (the port runs on the CPU with
its sanitizer on, so every transition is also shadow-checked)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CoherencePolicy as JPolicy
from repro.core.lease_engine import LeaseEngine as JEngine
from repro_torch.core import CoherencePolicy as TPolicy
from repro_torch.core.lease_engine import LeaseEngine as TEngine
from repro_torch.core.store import BlockTable

N_BLOCKS, RESERVE, CHUNK = 24, 12, 2
LAYOUTS = {
    "single": {"kv": (CHUNK, 2, 2, 16)},
    "two_pools": {"a": (CHUNK, 2, 2, 16), "b": (CHUNK, 2, 1, 16)},
}
POLICIES = {
    "static": dict(lease=5, ts_bits=7),
    "predictor": dict(lease=4, ts_bits=7, predictor=True, lease_min=1,
                      lease_max=32),
}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _engines(layout, policy):
    pools = LAYOUTS[layout]
    je = JEngine(N_BLOCKS, policy=JPolicy(**POLICIES[policy]),
                 backend="numpy", kv_pools=pools, kv_dtype=jnp.bfloat16,
                 alloc_reserve=RESERVE, block_bytes=256)
    te = TEngine(N_BLOCKS, policy=TPolicy(**POLICIES[policy]),
                 device="cpu", kv_pools=pools, kv_dtype=torch.bfloat16,
                 alloc_reserve=RESERVE, block_bytes=256, sanitize=True)
    return je, te


def _check_state(je, te):
    np.testing.assert_array_equal(je.wts, te.wts)
    np.testing.assert_array_equal(je.rts, te.rts)
    np.testing.assert_array_equal(je._kv_valid, te._kv_valid)
    assert je._free_pages == te._free_pages
    np.testing.assert_array_equal(je.pred_lease, te.pred_lease)
    np.testing.assert_array_equal(_bits(je._kv_pool), _bits(te._kv_pool))
    assert dataclasses.asdict(je.stats) == dataclasses.asdict(te.stats)


def _same_read(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f.name)


def _run_stream(layout, policy, seed, n_ops=60):
    rng = np.random.default_rng(seed)
    je, te = _engines(layout, policy)
    pools = LAYOUTS[layout]
    pts = 0
    owned = []                       # allocated decode pages
    for step in range(n_ops):
        op = rng.choice(["read", "read_many", "write", "write_many",
                         "write_kv", "read_kv", "append_kv", "alloc",
                         "free", "invalidate", "rebase"],
                        p=[.16, .14, .1, .08, .1, .1, .12, .06, .05, .04,
                           .05])
        ids = sorted({int(b) for b in rng.integers(0, N_BLOCKS,
                                                   rng.integers(1, 6))})
        if op == "read":
            mode = int(rng.integers(0, 3))
            req = [-1 if mode == 0 else int(je.wts[b]) - (mode == 2)
                   for b in ids]
            a, b = je.read(ids, pts, req_wts=req), te.read(ids, pts,
                                                           req_wts=req)
            _same_read(a, b)
            pts = a.new_pts
        elif op == "read_many":
            groups = [ids, ids[:1], ids] if rng.random() < .5 else [ids]
            req = {b: (int(je.wts[b]) if rng.random() < .6 else -1)
                   for b in ids}
            a = je.read_many(groups, pts, req_wts=req)
            b = te.read_many(groups, pts, req_wts=req)
            _same_read(a, b)
            pts = int(a.new_pts.max())
        elif op == "write":
            a = je.write(ids, pts)
            assert te.write(ids, pts) == a
            pts = a
        elif op == "write_many":
            groups = [ids, ids[::-1][:2]]
            a = je.write_many(groups, pts)
            assert te.write_many(groups, pts) == a
            pts = a
        elif op == "write_kv":
            content = [b for b in ids if b < RESERVE] or [0]
            blocks = {name: rng.standard_normal((len(content),) + shp)
                      .astype(np.float32) for name, shp in pools.items()}
            je.write_kv(content, blocks)
            te.write_kv(content, {k: torch.from_numpy(v)
                                  for k, v in blocks.items()})
        elif op == "read_kv":
            a, b = je.read_kv(ids), te.read_kv(ids)
            if isinstance(a, dict):
                for k in a:
                    np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]))
            else:
                np.testing.assert_array_equal(_bits(a), _bits(b))
            name = sorted(pools)[int(rng.integers(0, len(pools)))]
            np.testing.assert_array_equal(
                _bits(je.read_kv(ids, pool=name)),
                _bits(te.read_kv(ids, pool=name)))
        elif op == "append_kv":
            if rng.random() < .5 and owned:
                pages = [owned[int(rng.integers(0, len(owned)))]]
                slots = np.asarray([p * CHUNK + int(rng.integers(0, CHUNK))
                                    for p in pages * 2], np.int64)
                # full interleaved rows, or (single pool) unpadded rows
                width = je.kv_token_row
                if len(pools) == 1 and rng.random() < .5:
                    width = je.pool_token_elems("kv")
                rows = rng.standard_normal((slots.size, width)) \
                    .astype(np.float32)
                je.append_kv(slots, rows)
                te.append_kv(slots, torch.from_numpy(rows))
            else:
                name = sorted(pools)[int(rng.integers(0, len(pools)))]
                slots = rng.integers(0, N_BLOCKS * CHUNK, 3)
                rows = rng.standard_normal(
                    (3, je.pool_token_elems(name))).astype(np.float32)
                je.append_kv(slots, rows, pool=name)
                te.append_kv(slots, torch.from_numpy(rows), pool=name)
        elif op == "alloc":
            k = min(int(rng.integers(1, 3)), je.free_page_count())
            a, b = je.alloc_pages(k), te.alloc_pages(k)
            np.testing.assert_array_equal(a, b)
            owned += [int(x) for x in a]
        elif op == "free" and owned:
            k = int(rng.integers(1, len(owned) + 1))
            free = owned[:k]
            owned = owned[k:]
            je.free_pages(free)
            te.free_pages(free)
        elif op == "invalidate":
            je.invalidate_kv(ids)
            te.invalidate_kv(ids)
        elif op == "rebase":
            if rng.random() < .5:
                s = int(rng.integers(1, 40))
                assert je.force_rebase(s) == te.force_rebase(s)
            else:
                s = je.maybe_rebase()
                assert te.maybe_rebase() == s
            pts = JEngine.rebase_pts(pts, s)
        _check_state(je, te)
        s = je.maybe_rebase()                 # the ts_bits guard per op
        assert te.maybe_rebase() == s
        pts = JEngine.rebase_pts(pts, s)
    jr, tr = je.report(), te.report()
    assert tr.pop("sanitize_checks") > 0 and jr.pop("sanitize_checks") == 0
    assert jr == tr
    return je, te


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_stream_matches_jax(layout, policy, seed):
    je, _te = _run_stream(layout, policy, seed)
    assert je.stats.reads + je.stats.writes > 0


def test_device_defaults_to_the_card():
    """Without an explicit device the engine runs on the card and raises
    when there is none; the numpy mirror needs no card."""
    if torch.cuda.is_available():
        assert TEngine(8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TEngine(8)
    assert TEngine(8, backend="numpy").backend == "numpy"


def test_numpy_mirror_equals_device_backend_on_cpu():
    """The host mirror and the CPU device backend stay bit-identical."""
    a = TEngine(16, lease=4, backend="numpy", ts_bits=6,
                kv_block_shape=(2, 2, 1, 8))
    b = TEngine(16, lease=4, device="cpu", ts_bits=6,
                kv_block_shape=(2, 2, 1, 8))
    pts = 0
    rng = np.random.default_rng(3)
    for _ in range(40):
        ids = sorted({int(x) for x in rng.integers(0, 16, 3)})
        ts = a.write(ids, pts)
        assert b.write(ids, pts) == ts
        ra = a.read_many([ids, ids[:1]], ts)
        _same_read(ra, b.read_many([ids, ids[:1]], ts))
        shift = a.maybe_rebase()
        assert b.maybe_rebase() == shift
        pts = TEngine.rebase_pts(int(ra.new_pts.max()), shift)
        np.testing.assert_array_equal(a.wts, b.wts)
        np.testing.assert_array_equal(a.rts, b.rts)
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)


def test_block_table_adapter_on_cpu():
    bt = BlockTable(8, lease=3, device="cpu")
    expired, pts = bt.read_blocks(np.asarray([1, 2]), 5)
    assert expired.tolist() == [True, True] and pts == 5
    ts = bt.write_blocks(np.asarray([2]), pts)
    assert ts == 9 and int(bt.wts[2]) == 9 == int(bt.rts[2])
    exp_many, pts2 = bt.read_blocks_many([[1], [1, 2]], ts)
    assert exp_many.shape == (2, 2) and pts2 == 9
