"""Rank bodies of the port's multi-rank tests (run by ``_torch_ranks``):
torch and the port only, so a spawned rank starts fast."""
import numpy as np
import torch


def collectives(rank, world, seed):
    """Each device collective on a per-rank (world * 2, 3) int64 input;
    returns the inputs and the outputs as numpy."""
    from repro_torch.dist import collectives as C
    rng = np.random.default_rng(seed * 10 + rank)
    x = torch.from_numpy(rng.integers(-50, 50, (world * 2, 3)))
    return {"x": x.numpy(), "psum": C.psum(x).numpy(),
            "all_gather": C.all_gather(x).numpy(),
            "reduce_scatter": C.reduce_scatter(x).numpy(),
            "all_to_all": C.all_to_all(x).numpy()}


def _mesh(world, shape=None):
    from torch.distributed.device_mesh import init_device_mesh
    shape = shape or (world,)
    names = ("data",) if len(shape) == 1 else ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.arange(24.0).reshape(4, 6),
            "layers": [{"a": torch.randn(4, 2, generator=g),
                        "n": torch.randn(3, generator=g)} for _ in range(3)],
            "s": torch.tensor(7.0)}


def _placed(tree, mesh, place):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.tree import tree_map
    return tree_map(lambda t: distribute_tensor(t, mesh, place(t)), tree)


def sharded_roundtrip(rank, world, ckpt_dir):
    """Save the tree row-sharded over the ranks; restore it row-sharded,
    column-sharded (another placement), replicated and as plain tensors;
    every restored leaf's full value bit for bit the saved one.  Returns
    the manifest's pieces per leaf and the checks."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.checkpoint import ckpt
    from repro_torch.tree import leaves
    mesh = _mesh(world)
    tree = _tree()

    def row(t):
        return [Shard(0)] if t.dim() and t.shape[0] % world == 0 \
            else [Replicate()]

    def col(t):
        return [Shard(t.dim() - 1)] if t.dim() and \
            t.shape[-1] % world == 0 else [Replicate()]
    ckpt.save_sharded(ckpt_dir, 5, _placed(tree, mesh, row), wts=11)
    want = [t.numpy() for t in leaves(tree)]
    same = {}
    for name, place in (("row", row), ("col", col),
                        ("rep", lambda t: [Replicate()])):
        like = _placed({k: v for k, v in tree.items()}, mesh, place)
        out, man = ckpt.restore_sharded(ckpt_dir, like)
        same[name] = all(
            np.array_equal(a.full_tensor().numpy(), b) and
            a.placements == lk.placements
            for a, b, lk in zip(leaves(out), want, leaves(like)))
    plain, man = ckpt.restore_sharded(ckpt_dir, tree)
    same["plain"] = all(np.array_equal(a.numpy(), b)
                        for a, b in zip(leaves(plain), want))
    return {"same": same, "wts": man["wts"],
            "pieces": [len(e["pieces"]) for e in man["leaves"]],
            "shards": man["shards"]}


def restore_on_2d_mesh(rank, world, ckpt_dir):
    """Restore a checkpoint on a (2, world / 2) mesh, sharded on both
    dims where they divide; returns whether every leaf is bit-exact."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.checkpoint import ckpt
    from repro_torch.tree import leaves
    mesh = _mesh(world, (2, world // 2))
    tree = _tree()

    def both(t):
        if t.dim() == 2:
            return [Shard(0), Shard(1)]
        return [Replicate(), Replicate()]
    out, _man = ckpt.restore_sharded(ckpt_dir, _placed(tree, mesh, both))
    return all(np.array_equal(a.full_tensor().numpy(), b.numpy())
               for a, b in zip(leaves(out), leaves(tree)))


def batch_on_mesh(rank, world, tokens):
    """``shard_batch`` over the ranks' DP axis: each rank's local rows."""
    from repro_torch.data import shard_batch
    from repro_torch.dist import sharding as shd
    mesh = _mesh(world)
    sh = shd.batch_shardings(mesh, {"tokens": torch.as_tensor(tokens)})
    out = shard_batch({"tokens": tokens}, sh)
    return out["tokens"].to_local().numpy(), \
        out["tokens"].full_tensor().numpy()
