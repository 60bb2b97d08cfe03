"""Sharded checkpoints, device collectives and ``shard_batch`` of the port
against the JAX package: the twins of ``tests/test_substrates.py``'s
sharded-checkpoint tests (the round trip on one device, the refusal of a
dense checkpoint, the save and restore across mesh shapes) and of the
collectives' numpy mirrors.

Multi-rank cases run on 2 or 4 gloo ranks on the CPU (``_torch_ranks``:
spawned processes, a ``file://`` rendezvous, every join under a timeout).
A checkpoint the port wrote on 2 ranks is read back by the JAX package's
``restore_sharded`` and one the JAX package wrote by the port's, bit for
bit; the collectives equal JAX's numpy mirrors (``np_psum`` and the rest)
exactly (int64)."""
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_rank_fns as fns
from _torch_ranks import run_ranks
from repro.checkpoint import ckpt as j_ckpt
from repro.dist import collectives as JC
from repro_torch.checkpoint import ckpt
from repro_torch.tree import leaves


def test_sharded_roundtrip_single_device():
    tree = {"w": torch.arange(24.0).reshape(4, 6),
            "b": {"s": torch.tensor(7.0)}}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_sharded(d, 3, tree, wts=9)
        out, man = ckpt.restore_sharded(d, tree)
        assert man["sharded"] and man["wts"] == 9
        for a, b in zip(leaves(out), leaves(tree)):
            assert torch.equal(a, b)


def test_restore_sharded_rejects_dense_checkpoint():
    tree = {"a": torch.ones(4)}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, tree)
        with pytest.raises(ValueError, match="save_sharded"):
            ckpt.restore_sharded(d, tree)


def test_restore_rejects_a_sharded_checkpoint_and_a_shape_mismatch():
    tree = {"a": torch.ones(4)}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_sharded(d, 1, tree)
        with pytest.raises(ValueError, match="restore_sharded"):
            ckpt.restore(d, tree)
        with pytest.raises(ValueError, match="shape"):
            ckpt.restore_sharded(d, {"a": torch.ones(5)})


def test_sharded_save_restore_across_mesh_shapes():
    """On 2 ranks: one piece per rank of a row-sharded leaf (a per-layer
    list's shards stacked into one piece), restored row-sharded,
    column-sharded, replicated and plain -- all bit-identical; then the
    same files restored on 4 ranks as a 2 x 2 mesh."""
    with tempfile.TemporaryDirectory() as d:
        out = run_ranks(fns.sharded_roundtrip, 2, d)
        for r in out:
            assert r["same"] == {"row": True, "col": True, "rep": True,
                                 "plain": True}, r
            assert r["wts"] == 11
        # layers/a (3, 4, 2) and w (4, 6) split in 2 pieces; the rest 1
        assert out[0]["pieces"] == [2, 1, 1, 2]
        assert len(out[0]["shards"]) == 2            # one file a rank
        assert run_ranks(fns.restore_on_2d_mesh, 4, d) == [True] * 4


def test_port_sharded_checkpoint_reads_in_jax_and_back():
    with tempfile.TemporaryDirectory() as d:
        run_ranks(fns.sharded_roundtrip, 2, os.path.join(d, "t"))
        tree = fns._tree()
        jlike = {"layers": {"a": jnp.zeros((3, 4, 2)), "n": jnp.zeros((3, 3))},
                 "s": jnp.zeros(()), "w": jnp.zeros((4, 6))}
        jout, man = j_ckpt.restore_sharded(os.path.join(d, "t"), jlike)
        assert man["wts"] == 11
        want = {"layers": {"a": torch.stack([l["a"] for l in tree["layers"]]),
                           "n": torch.stack([l["n"] for l in tree["layers"]])},
                "s": tree["s"], "w": tree["w"]}
        for k in ("s", "w"):
            np.testing.assert_array_equal(np.asarray(jout[k]), want[k].numpy())
        for k in ("a", "n"):
            np.testing.assert_array_equal(np.asarray(jout["layers"][k]),
                                          want["layers"][k].numpy())
        # and a checkpoint the JAX package wrote, read by the port
        j_ckpt.save_sharded(os.path.join(d, "j"), 2,
                            {k: (jnp.asarray(v.numpy()) if k != "layers"
                                 else {kk: jnp.asarray(vv.numpy())
                                       for kk, vv in v.items()})
                             for k, v in want.items()}, wts=4)
        tout, tman = ckpt.restore_sharded(os.path.join(d, "j"), tree)
        assert tman["wts"] == 4
        for a, b in zip(leaves(tout), leaves(tree)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_jax_numpy_mirrors(world):
    out = run_ranks(fns.collectives, world, world)
    xs = [r["x"] for r in out]
    for name, mirror in (("psum", JC.np_psum),
                         ("all_gather", JC.np_all_gather),
                         ("reduce_scatter", JC.np_reduce_scatter),
                         ("all_to_all", JC.np_all_to_all)):
        want = mirror(xs)
        for r, w in zip(out, want):
            np.testing.assert_array_equal(r[name], w)


def test_shard_batch_places_rows_over_the_ranks():
    tokens = np.arange(32, dtype=np.int32).reshape(4, 8)
    out = run_ranks(fns.batch_on_mesh, 2, tokens)
    np.testing.assert_array_equal(out[0][0], tokens[:2])
    np.testing.assert_array_equal(out[1][0], tokens[2:])
    for _local, full in out:
        np.testing.assert_array_equal(full, tokens)
