"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's: the twin of ``tests/test_system.py::
test_dryrun_machinery_small_mesh`` and the dry run's bookkeeping.

  * the cell logic on a 1 x 1 mesh (a one-rank fake process group) with
    reduced tinyllama-1.1b and mamba2-130m: the train, prefill and decode
    steps trace on fake DTensors and count flops > 0;
  * ``arg_bytes_per_device`` equals the JAX package's formula (its own
    function, over JAX's abstract parameters and optimizer state carrying
    JAX's specs) for every arch on both production meshes;
  * the skipped cells are the ones JAX's ``should_skip`` gives;
  * ``abstract_params`` / ``abstract_init`` allocate nothing and have JAX's
    shapes and dtypes;
  * the CLI writes where ``--out`` says and refuses the repo's
    ``dryrun_multi.json``."""
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS, SHAPES
from repro.configs import get_arch as j_get_arch
from repro.dist import sharding as jshd
from repro.launch import dryrun as J
from repro.models import abstract_params as j_abstract_params
from repro.optim import adamw as j_adamw
from repro_torch.configs import ShapeSet, get_arch, reduced
from repro_torch.launch import dryrun as D
from repro_torch.models import abstract_params
from repro_torch.optim import adamw
from repro_torch.tree import leaves


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
          "multi": FakeMesh({"pod": 2, "data": 16, "model": 16})}


@pytest.fixture
def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already running")
    D.start_fake_group(1)
    try:
        yield make_host_mesh(data=1, model=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_dryrun_machinery_small_mesh(arch, host_mesh):
    cfg = reduced(get_arch(arch))
    for kind in ("train", "prefill", "decode"):
        rec = D.run_cell(arch, "small", host_mesh, "host_1x1", cfg=cfg,
                         shape=ShapeSet("small", 32, 4, kind))
        assert rec["status"] == "ok", rec
        assert rec["flops_total"] > 0
        assert rec["arg_bytes_per_device"] > 0
        assert set(rec["collective_bytes"]) == set(D._COLLECTIVES)
        assert rec["op_count"] > 0
        assert "cost_analysis" not in rec and "hlo_chars" not in rec


def _sharded(mesh, t):
    from torch.distributed.tensor import DTensor, Shard
    return DTensor.from_local(t, mesh, [Shard(0), Shard(1)],
                              run_check=False)


def test_fallback_replicates_an_unplaceable_operator(host_mesh):
    """An operator with no sharding rule runs on replicated inputs and
    returns a replicated result: its inputs' gathers are counted apart
    from the placed collectives, the operator under its reason."""
    x = _sharded(host_mesh, torch.arange(8.0).reshape(4, 2))
    v = _sharded(host_mesh, torch.tensor([[0.5], [2.5], [4.5], [9.0]]))
    comm = D._comm_bytes_mode()
    fb = D._ReplicateFallback()
    with comm, fb:
        out = torch.searchsorted(x, v)
    # the values are not carried (a cell's tensors are fake): the shape is
    assert tuple(out.shape) == (4, 1) and out.dtype == torch.int64
    assert all(p.is_replicate() for p in out.placements)
    assert fb.fallbacks == {"no sharding rule": {"searchsorted": 1}}
    assert (fb.gathers, fb.gather_bytes) == (2, 8 * 4 + 4 * 4)
    assert sum(comm.counts.values()) == 0


@pytest.mark.parametrize("msg", [
    "shape '[128, 1, 4, 64]' is invalid for input of size 2048",
    "Cannot view a tensor with shape torch.Size([128, 1, 256])",
    # torch 2.11's words, on tinyllama's decode_32k cell
    "('Attempted to split the sharded dimension 2 into multiple "
    "subdimensions. ', 'It cannot be performed without redistribution, "
    "which is disallowed by the current operator.')"])
def test_a_view_that_splits_a_sharded_dim_is_unplaceable(msg):
    """Each torch version's words for a view DTensor cannot place give the
    same reason; the same words from another operator are a fault."""
    view = torch.ops.aten.view.default
    assert D._unplaceable(view, (), {}, RuntimeError(msg)) == \
        "view of a sharded dim"
    assert D._unplaceable(torch.ops.aten.mm.default, (), {},
                          RuntimeError(msg)) == ""


def test_fallback_raises_a_genuine_fault(host_mesh):
    """An error that is not one of DTensor's placement limits (here a
    shape mismatch) propagates: it is not retried on replicated inputs."""
    a = _sharded(host_mesh, torch.ones(4, 3))
    b = _sharded(host_mesh, torch.ones(4, 3))
    fb = D._ReplicateFallback()
    with fb, pytest.raises(RuntimeError, match="same reduction dim"):
        torch.mm(a, b)
    assert not fb.fallbacks and fb.gathers == 0


class _Leaf:
    """A JAX abstract leaf with a spec: what ``arg_bytes_per_device``
    reads (size, dtype, shape, sharding.spec)."""

    def __init__(self, sds, spec):
        self.size, self.dtype, self.shape = sds.size, sds.dtype, sds.shape

        class _S:
            pass
        self.sharding = _S()
        self.sharding.spec = spec


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_arg_bytes_per_device_matches_jax(arch, mesh):
    m = MESHES[mesh]
    jp = j_abstract_params(j_get_arch(arch))
    specs = [jshd.param_spec(m, jshd._path_names(kp), leaf.shape)
             for kp, leaf in jax.tree_util.tree_leaves_with_path(jp)]
    jleaves = [_Leaf(leaf, sp) for leaf, sp in zip(jax.tree.leaves(jp),
                                                   specs)]
    jopt = jax.eval_shape(j_adamw.init, jp)
    rep = jax.sharding.PartitionSpec()
    oleaves = ([_Leaf(leaf, sp) for leaf, sp in
                zip(jax.tree.leaves(jopt["m"]), specs)]
               + [_Leaf(jopt["step"], rep)]
               + [_Leaf(leaf, sp) for leaf, sp in
                  zip(jax.tree.leaves(jopt["v"]), specs)])
    params = abstract_params(get_arch(arch))
    opt = adamw.abstract_init(params)
    assert D.arg_bytes_per_device(m, params) == \
        J.arg_bytes_per_device(m, jleaves)
    assert D.arg_bytes_per_device(m, params, opt) == \
        J.arg_bytes_per_device(m, jleaves, oleaves)


def test_skipped_cells_match_jax():
    for arch in sorted(ARCHS):
        for shape in SHAPES:
            assert D.should_skip(get_arch(arch), shape) == \
                J.should_skip(j_get_arch(arch), shape)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_params_and_opt_allocate_nothing(arch):
    params = abstract_params(get_arch(arch), torch.float32)
    opt = adamw.abstract_init(params)
    assert all(t.is_meta for t in leaves(params) + leaves(opt))
    jp = j_abstract_params(j_get_arch(arch), jnp.float32)
    from repro_torch.dist.sharding import jax_layout
    assert [s for _p, s, _t in jax_layout(params)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jp)]
    assert {str(t.dtype) for t in leaves(params)} == {"torch.float32"}
    assert opt["step"].dtype == torch.int32 and opt["step"].dim() == 0


def test_cli_refuses_the_repo_record():
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(SystemExit, match="dryrun_multi.json"):
            D.main(["--out", os.path.join(d, "dryrun_multi.json")])
        assert not os.listdir(d)


def test_cli_writes_out_with_the_skipped_cell():
    """The CLI on the 16 x 16 fake group, one cell that JAX skips: the
    record lands in ``--out`` with JAX's reason, and the group is torn
    down after."""
    if dist.is_initialized():
        pytest.skip("a process group is already running")
    long = [s for s in SHAPES if s.name == "long_500k"][0]
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "dry.json")
        assert D.main(["--mesh", "single", "--archs", "tinyllama-1.1b",
                       "--shapes", "long_500k", "--out", out]) == 0
        with open(out) as f:
            recs = json.load(f)
    assert [r["status"] for r in recs] == ["skipped"]
    assert recs[0]["reason"] == J.should_skip(
        j_get_arch("tinyllama-1.1b"), long)
    assert not dist.is_initialized()
