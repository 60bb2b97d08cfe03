"""The port's protocol rules (Tables I-III) and rebase guard against the
JAX package's, bit for bit on random int32 arrays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocol as JP
from repro.core import timestamps as JT
from repro_torch.core import protocol as TP
from repro_torch.core import timestamps as TT

N = 257


def _arrays(seed):
    rng = np.random.default_rng(seed)
    wts = rng.integers(0, 1 << 20, N).astype(np.int32)
    rts = (wts + rng.integers(0, 1 << 10, N)).astype(np.int32)
    pts = rng.integers(0, 1 << 20, N).astype(np.int32)
    lease = rng.integers(1, 512, N).astype(np.int32)
    return wts, rts, pts, lease


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    np.testing.assert_array_equal(np.asarray(a), torch.as_tensor(b).numpy())


RULES = {
    "load_no_cache": lambda m, w, r, p, L: m.load_no_cache(p, w, r),
    "store_no_cache": lambda m, w, r, p, L: m.store_no_cache(p, w, r),
    "load_hit_shared": lambda m, w, r, p, L: m.load_hit_shared(p, w),
    "load_hit_exclusive": lambda m, w, r, p, L: m.load_hit_exclusive(p, w, r),
    "store_hit_exclusive": lambda m, w, r, p, L: m.store_hit_exclusive(p, r),
    "store_hit_private": lambda m, w, r, p, L: m.store_hit_private(p, r),
    "shared_expired": lambda m, w, r, p, L: m.shared_expired(p, r),
    "writeback_rts": lambda m, w, r, p, L: m.writeback_rts(w, r, p, L),
    "lease_extend": lambda m, w, r, p, L: m.lease_extend(w, r, p, L),
    "renewable": lambda m, w, r, p, L: m.renewable(p, w),
    "evict_mts": lambda m, w, r, p, L: m.evict_mts(p, r),
}


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("seed", [0, 1])
def test_table_rules_bit_identical(rule, seed):
    w, r, p, L = _arrays(seed)
    got = RULES[rule](TP, *(torch.from_numpy(x) for x in (w, r, p, L)))
    want = RULES[rule](JP, *(jnp.asarray(x) for x in (w, r, p, L)))
    _same(want, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pts", [0, 1 << 19, 1 << 21])
def test_batched_helpers_bit_identical(seed, pts):
    w, r, _p, _L = _arrays(seed)
    mask = np.random.default_rng(seed + 7).random(N) < 0.3
    _same(JP.batched_read_check(np.int32(pts), jnp.asarray(w),
                                jnp.asarray(r)),
          TP.batched_read_check(pts, torch.from_numpy(w),
                                torch.from_numpy(r)))
    _same(JP.batched_write_advance(np.int32(pts), jnp.asarray(r),
                                   jnp.asarray(mask)),
          TP.batched_write_advance(pts, torch.from_numpy(r),
                                   torch.from_numpy(mask)))


def test_flit_accounting_is_the_same():
    assert TP.MESSAGE_FLITS == JP.MESSAGE_FLITS
    assert TP.FLIT_BYTES == JP.FLIT_BYTES
    for nbytes in (0, 1, 15, 16, 17, 64, 4096, 123457, 1 << 30):
        assert TP.data_flits(nbytes) == JP.data_flits(nbytes)


@pytest.mark.parametrize("bits", [4, 8, 30])
@pytest.mark.parametrize("is_private", [True, False])
def test_rebase_guard_bit_identical(bits, is_private):
    rng = np.random.default_rng(bits)
    bts = int(rng.integers(0, 1 << (bits - 1)))
    wts = (bts + rng.integers(0, 1 << bits, N)).astype(np.int32)
    rts = (wts + rng.integers(0, 4, N)).astype(np.int32)
    state = rng.integers(0, 3, N).astype(np.int32)
    for max_ts in (bts, bts + (1 << bits) - 1, bts + (1 << bits)):
        assert TT.rebase_needed(max_ts, bts, bits) == bool(
            JT.rebase_needed(max_ts, bts, bits))
    assert TT.rebase_amount(bits) == JT.rebase_amount(bits)
    want = JT.apply_rebase(bts, jnp.asarray(wts), jnp.asarray(rts),
                           jnp.asarray(state), is_private, bits)
    got = TT.apply_rebase(bts, torch.from_numpy(wts), torch.from_numpy(rts),
                          torch.from_numpy(state), is_private, bits)
    assert int(want[0]) == int(got[0])
    for x, y in zip(want[1:4], got[1:4]):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert int(want[4]) == int(got[4])
