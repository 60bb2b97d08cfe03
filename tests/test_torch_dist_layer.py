"""The port's distribution layer against the JAX package's: the twins of
``tests/test_dist_layer.py`` (all 17) and of the sharding rules of
``tests/test_substrates.py``, plus every spec of every arch.

Each twin drives the port's function (``repro_torch.dist.sharding`` /
``annotate``, ``repro_torch.launch.steps``) where the JAX test drives
JAX's, and holds the result to JAX's on the same input: specs compare as
tuples (JAX's ``PartitionSpec`` is one).  Then, for every arch on the
16 x 16 and 2 x 16 x 16 fake meshes, ``param_spec`` of every leaf (the
port's per-layer lists read in the JAX layout, leaf for leaf with JAX's
paths and stacked shapes), ``cache_spec`` of every cache leaf at the
decode cells' shapes, ``batch_spec`` / ``activation_spec`` of each
cell's inputs, and ``opt_shardings`` equal JAX's.  The ``DTensor``
placements of a spec are checked on a one-rank gloo mesh, and the
annotations keep values and gradients there."""
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS, SHAPES
from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.dist import sharding as jshd
from repro.launch.steps import cache_specs as j_cache_specs
from repro.launch.steps import input_specs as j_input_specs
from repro.models import abstract_params as j_abstract_params
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_arch, reduced
from repro_torch.dist import annotate
from repro_torch.dist import sharding as shd
from repro_torch.launch.steps import cache_specs, input_specs
from repro_torch.models import abstract_params
from repro_torch.optim import adamw
from repro_torch.tree import leaves


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": SINGLE, "2x16x16": MULTI}


@pytest.fixture
def one_rank():
    """A one-rank gloo group (file:// rendezvous) and its (data, model)
    host mesh; torn down after the test."""
    from repro_torch.launch.mesh import make_host_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already running")
    d = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method=f"file://{d}/rdv", rank=0,
                            world_size=1)
    try:
        yield make_host_mesh(data=1, model=1)
    finally:
        dist.destroy_process_group()


# ---- twins of tests/test_dist_layer.py ------------------------------------

class TestBatchSpec:
    def test_batch_dim_over_dp(self):
        assert shd.batch_spec(MULTI, (256, 4096)) == \
            jshd.batch_spec(MULTI, (256, 4096)) == P(("pod", "data"), None)

    def test_indivisible_batch_replicates(self):
        assert shd.batch_spec(MULTI, (1, 64)) == \
            jshd.batch_spec(MULTI, (1, 64)) == P(None, None)

    def test_uneven_batch_drops_pod(self):
        assert shd.batch_spec(MULTI, (16, 64)) == \
            jshd.batch_spec(MULTI, (16, 64)) == P("data", None)

    def test_scalar_leaf_replicates(self):
        assert shd.batch_spec(MULTI, ()) == jshd.batch_spec(MULTI, ()) \
            == P()

    def test_activation_spec_sequence_parallel(self):
        for shape in ((16, 500000, 1024), (256, 4096, 1024)):
            assert shd.activation_spec(MULTI, shape) == \
                jshd.activation_spec(MULTI, shape)
        assert shd.activation_spec(MULTI, (16, 500000, 1024)) == \
            P("data", "model", None)

    def test_activation_spec_guards(self):
        for shape in ((256, 4096), (16, 4097, 1024), ()):
            assert shd.activation_spec(MULTI, shape) == \
                jshd.activation_spec(MULTI, shape)

    def test_shardings_tree_structure(self, one_rank):
        batch = {"tokens": torch.empty((4, 32), dtype=torch.int32),
                 "labels": torch.empty((4, 32), dtype=torch.int32)}
        out = shd.batch_shardings(one_rank, batch)
        assert set(out) == {"tokens", "labels"}
        for ns in out.values():
            assert isinstance(ns, shd.NamedSharding)
            assert len(ns.spec) == 2 and ns.mesh is one_rank


class TestCacheSpec:
    def test_kv_cache_rule(self):
        cfg = get_arch("tinyllama-1.1b")
        cache = cache_specs(cfg, 128, 32768)
        sk = shd.cache_spec(MULTI, "k", cache["k"].shape)
        assert sk == jshd.cache_spec(MULTI, "k", tuple(cache["k"].shape))
        assert sk[1] == ("pod", "data")
        hk = cache["k"].shape[3]
        assert sk[3] == ("model" if hk % 16 == 0 else None)
        assert sk[0] is None and sk[2] is None

    def test_ssm_cache_rule(self):
        cfg = get_arch("mamba2-130m")
        cache = cache_specs(cfg, 128, 32768)
        st = shd.cache_spec(MULTI, "state", cache["state"].shape)
        assert st == jshd.cache_spec(MULTI, "state",
                                     tuple(cache["state"].shape))
        assert st[1] == ("pod", "data")
        h = cache["state"].shape[2]
        assert st[2] == ("model" if h % 16 == 0 else None)

    def test_shardings_tree_matches_for_every_family(self, one_rank):
        for arch in ("tinyllama-1.1b", "kimi-k2-1t-a32b", "zamba2-2.7b",
                     "whisper-large-v3"):
            cfg = get_arch(arch)
            cache = cache_specs(cfg, 128, 1024,
                                1024 if cfg.family == "encdec" else 0)
            out = shd.cache_shardings(one_rank, cache)
            assert set(out) == set(cache)
            jc = j_cache_specs(j_get_arch(arch), 128, 1024,
                               1024 if cfg.family == "encdec" else 0)
            assert set(out) == set(jc)
            for k, ns in out.items():
                assert isinstance(ns, shd.NamedSharding)
                assert tuple(cache[k].shape) == tuple(jc[k].shape)


class TestOptShardings:
    def test_moments_mirror_params_step_replicates(self, one_rank):
        cfg = reduced(get_arch("tinyllama-1.1b"))
        params = abstract_params(cfg, torch.float32)
        pshard = shd.param_shardings(one_rank, params)
        opt = adamw.abstract_init(params)
        out = shd.opt_shardings(one_rank, opt, pshard)
        assert set(out) == set(opt)
        assert out["m"] is pshard and out["v"] is pshard
        assert out["step"].spec == ()


class TestAnnotate:
    def test_noop_without_mesh(self):
        assert annotate.ambient_mesh() is None
        x = torch.ones((4, 8, 16))
        assert annotate.batch_activations(x) is x
        assert annotate.replicate(x) is x

    def test_noop_under_a_mesh_on_plain_tensors(self, one_rank):
        x = torch.ones((4, 8))
        with annotate.use_mesh(one_rank):
            assert annotate.ambient_mesh() is one_rank
            assert annotate.batch_activations(x) is x
        assert annotate.ambient_mesh() is None

    def test_constrains_under_ambient_mesh(self, one_rank):
        from torch.distributed.tensor import Replicate, distribute_tensor
        x = torch.arange(4 * 8 * 16.0).reshape(4, 8, 16)
        xd = distribute_tensor(x, one_rank, [Replicate(), Replicate()])
        with annotate.use_mesh(one_rank):
            y = annotate.batch_activations(xd)
            z = annotate.replicate(xd)
        np.testing.assert_array_equal(y.full_tensor().numpy(), x.numpy())
        np.testing.assert_array_equal(z.full_tensor().numpy(), x.numpy())

    def test_value_preserved_through_grad(self, one_rank):
        from torch.distributed.tensor import Replicate, distribute_tensor
        x = torch.arange(8.0).reshape(2, 4)
        xd = distribute_tensor(x, one_rank, [Replicate(), Replicate()])
        xd.requires_grad_()
        with annotate.use_mesh(one_rank):
            (annotate.batch_activations(xd) ** 2).sum().backward()
        np.testing.assert_allclose(xd.grad.full_tensor().numpy(),
                                   2 * x.numpy())


class TestParamShardingsEndToEnd:
    def test_every_leaf_gets_named_sharding(self, one_rank):
        params = abstract_params(get_arch("kimi-k2-1t-a32b"))
        pshard = shd.param_shardings(one_rank, params)
        flat_p, flat_s = leaves(params), leaves(pshard)
        assert len(flat_p) == len(flat_s)
        for leaf, ns in zip(flat_p, flat_s):
            assert isinstance(ns, shd.NamedSharding)
            assert len(ns.spec) == leaf.dim()

    def test_moe_expert_placement_spec(self):
        cfg = get_arch("kimi-k2-1t-a32b")
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
        n_moe = cfg.n_layers - cfg.first_dense_layers
        for leaf, shape in (("w_up", (n_moe, e, d, f)),
                            ("w_down", (n_moe, e, f, d))):
            path = ("layers", "moe", leaf)
            assert shd.param_spec(MULTI, path, shape) == \
                jshd.param_spec(MULTI, path, shape)
        up = shd.param_spec(MULTI, ("layers", "moe", "w_up"),
                            (n_moe, e, d, f))
        assert up[0] is None and up[1] == "model"
        assert up[2] == shd._dp_axes(MULTI, d) == jshd._dp_axes(MULTI, d)


# ---- twins of tests/test_substrates.py's TestShardingRules ---------------

@pytest.mark.parametrize("mesh,path,shape", [
    (SINGLE, ("layers", "attn", "wk"), (40, 4096, 256)),
    (SINGLE, ("layers", "ssm", "A_log"), (24, 24)),
    (MULTI, ("layers", "moe", "w_gate"), (60, 384, 7168, 2048)),
    (MULTI, ("layers", "attn", "wq"), (2, 16, 512))])
def test_sharding_rules_match_jax(mesh, path, shape):
    assert shd.param_spec(mesh, path, shape) == \
        jshd.param_spec(mesh, path, shape)


# ---- every leaf of every arch on both production meshes -------------------

@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return j_abstract_params(j_get_arch(arch))


@pytest.mark.parametrize("mesh", list(MESHES), ids=str)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_opt_specs_match_jax_leaf_for_leaf(arch, mesh):
    m = MESHES[mesh]
    jp = _jax_params(arch)
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    want = [tuple(jshd.param_spec(m, jshd._path_names(kp), leaf.shape))
            for kp, leaf in leaves]
    params = abstract_params(get_arch(arch))
    lay = shd.jax_layout(params)
    assert [p for p, _s, _t in lay] == [jshd._path_names(kp)
                                        for kp, _l in leaves]
    assert [s for _p, s, _t in lay] == [tuple(leaf.shape)
                                        for _kp, leaf in leaves]
    got = shd.param_specs(m, params)
    assert got == want
    # the per-layer specs: the stacked spec less its (replicated) stack axes
    per_layer = shd.param_placements(m, params)
    flat = []

    def walk(t, like):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], like[k])
        elif isinstance(t, list):
            walk(t[0], like[0])
        else:
            flat.append((t, like))
    walk(per_layer, params)
    for (spec, leaf), stacked in zip(flat, got):
        assert spec == stacked[len(stacked) - leaf.dim():]
        assert all(a is None for a in stacked[:len(stacked) - leaf.dim()])
    # the optimizer state: moments mirror, the step replicates
    jopt = jax.eval_shape(j_adamw.init, jp)
    jo = {k: (jax.tree.leaves(jopt[k]) if k != "step" else jopt[k])
          for k in jopt}
    ospec = shd.opt_specs(m, adamw.abstract_init(params), got)
    assert ospec["m"] == ospec["v"] == want
    assert ospec["step"] == () == tuple(jo["step"].shape)


@pytest.mark.parametrize("mesh", list(MESHES), ids=str)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_and_cache_specs_match_jax(arch, mesh):
    m = MESHES[mesh]
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    for shape in SHAPES:
        mine, theirs = input_specs(cfg, shape), j_input_specs(jcfg, shape)
        assert set(mine) == set(theirs)
        if "batch" in mine:
            assert set(mine["batch"]) == set(theirs["batch"])
            for k, t in mine["batch"].items():
                js = tuple(theirs["batch"][k].shape)
                assert tuple(t.shape) == js
                assert shd.batch_spec(m, t.shape) == jshd.batch_spec(m, js)
                assert shd.activation_spec(m, t.shape) == \
                    jshd.activation_spec(m, js)
        if "cache" in mine:
            assert set(mine["cache"]) == set(theirs["cache"])
            specs = shd.cache_specs(m, mine["cache"])
            for k, t in mine["cache"].items():
                js = tuple(theirs["cache"][k].shape)
                assert tuple(t.shape) == js
                assert specs[k] == jshd.cache_spec(m, k, js)


def test_placements_nest_the_dp_axes_in_mesh_order():
    """``("pod", "data")`` on one dim: Shard(d) on both mesh dims, pod
    first; checked on a fake 2 x 2 x 2 process group."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        pytest.skip("a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        pl = shd.placements(mesh, (("pod", "data"), "model", None))
        assert pl == [Shard(0), Shard(0), Shard(1)]
        assert shd.placements(mesh, (None, None)) == [Replicate()] * 3
        assert shd.num_shards(mesh, (("pod", "data"), "model")) == 8
    finally:
        dist.destroy_process_group()


def test_reduced_param_specs_on_a_host_mesh(one_rank):
    """On a 1 x 1 mesh nothing shards, in both packages."""
    cfg, jcfg = reduced(get_arch("zamba2-2.7b")), j_reduced(
        j_get_arch("zamba2-2.7b"))
    m = {"data": 1, "model": 1}
    jp = j_abstract_params(jcfg, jnp.float32)
    want = [tuple(jshd.param_spec(FakeMesh(m), jshd._path_names(kp),
                                  leaf.shape))
            for kp, leaf in jax.tree_util.tree_leaves_with_path(jp)]
    assert shd.param_specs(one_rank, abstract_params(cfg, torch.float32)) \
        == want
    assert all(a is None for s in want for a in s)
