"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) against the JAX
package's: the same on-disk layout, read both ways.

Held: a round trip of (params, AdamW state) is bit for bit, dtypes kept
(bf16 leaves through their uint16 bits); ``keep`` leaves the newest
checkpoints and ``LATEST`` names the last; a tree whose leaf count or a
leaf's shape differs is refused; a checkpoint the JAX package wrote
restores into the port's trees (per-layer lists, the hybrid's list of
lists) equal to ``convert.params_from_jax`` / ``opt_state_from_jax`` of
the JAX state, and one the port wrote restores in the JAX package equal
to the JAX state; the manifests agree key for key (the treedef string
included)."""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_arch, reduced
from repro.models import init_params
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.models import init_params as t_init_params
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map

ARCHS = ["tinyllama-1.1b", "zamba2-2.7b", "kimi-k2-1t-a32b"]


@functools.lru_cache(maxsize=None)
def _jax_state(arch, seed=0):
    cfg = reduced(get_arch(arch), vocab=128)
    params = init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    st = j_adamw.init(params)
    st = {"m": jax.tree.map(lambda a: a + 0.25, st["m"]),
          "v": jax.tree.map(lambda a: a + 0.5, st["v"]),
          "step": jnp.int32(11)}
    return params, st


def _equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_for_bit(tmp_path, arch, dtype):
    cfg = t_reduced(t_get_arch(arch), vocab=128)
    params = t_init_params(cfg, torch.Generator().manual_seed(1),
                           getattr(torch, dtype))
    st = adamw.init(params)
    path = ckpt.save(str(tmp_path), 7, (params, st), wts=7)
    assert os.path.basename(path) == "step_7"
    assert ckpt.latest_step(str(tmp_path)) == 7
    (p2, st2), manifest = ckpt.restore(str(tmp_path), (params, st))
    _equal(p2, params)
    _equal(st2, st)
    assert manifest["step"] == 7 and manifest["wts"] == 7
    if dtype == "bfloat16":
        assert "bfloat16" in {e["dtype"] for e in manifest["leaves"]}


def test_keep_collects_old_checkpoints(tmp_path):
    tree = ({"w": torch.arange(6.0).reshape(2, 3)},)
    for step in range(1, 6):
        ckpt.save(str(tmp_path), step, tree, keep=2)
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) \
        == ["step_4", "step_5"]
    assert (tmp_path / "LATEST").read_text() == "step_5"
    assert ckpt.latest_step(str(tmp_path)) == 5
    (got,), m = ckpt.restore(str(tmp_path), tree, step=4)
    assert m["step"] == 4 and torch.equal(got["w"], tree[0]["w"])
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)


def test_restore_rejects_a_shape_or_leaf_mismatch(tmp_path):
    tree = {"a": torch.zeros(4, 3), "b": [torch.zeros(2), torch.zeros(2)]}
    ckpt.save(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"a": torch.zeros(3, 4),
                                     "b": tree["b"]})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"a": tree["a"], "b": [torch.zeros(2)]})
    with pytest.raises(ValueError, match="tree mismatch"):
        ckpt.restore(str(tmp_path), {"a": tree["a"]})


@pytest.mark.parametrize("arch", ARCHS)
def test_port_reads_a_jax_checkpoint(tmp_path, arch):
    params, st = _jax_state(arch)
    jckpt.save(str(tmp_path), 11, (params, st), wts=11)
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    tst = opt_state_from_jax(jax.tree.map(np.asarray, st))
    like = (tree_map(torch.zeros_like, tparams),
            tree_map(torch.zeros_like, tst))
    (p2, st2), manifest = ckpt.restore(str(tmp_path), like)
    _equal(p2, tparams)
    _equal(st2, tst)
    assert manifest["step"] == 11


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_reads_a_port_checkpoint(tmp_path, arch):
    params, st = _jax_state(arch)
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    tst = opt_state_from_jax(jax.tree.map(np.asarray, st))
    ckpt.save(str(tmp_path / "t"), 11, (tparams, tst), wts=11)
    jckpt.save(str(tmp_path / "j"), 11, (params, st), wts=11)
    (p2, st2), manifest = jckpt.restore(str(tmp_path / "t"), (params, st))
    for a, b in zip(jax.tree.leaves((p2, st2)),
                    jax.tree.leaves((params, st))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with open(tmp_path / "j" / "step_11" / "manifest.json") as f:
        jm = json.load(f)
    assert manifest == jm
