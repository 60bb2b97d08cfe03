"""The port's elastic data-parallel trainer against the JAX package's: the
twin of ``tests/test_system.py::test_elastic_dp_bounded_staleness``.

Both trainers start from one set of weights (the JAX package's, carried
across by ``convert.params_from_jax``) and see the same batches and the
same worker schedule.  Held: every integer of the report -- joins,
leaves, renewals, data-less renewals, max staleness, the version each
worker read, the wire flits and bytes and the payload bytes -- equal to
JAX's, the reference test's own bounds, and each worker step's loss
within rtol 2e-4 of JAX's (fp32 through 8 AdamW updates)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_arch, reduced
from repro.models import init_params, loss_fn as j_loss_fn
from repro.runtime import ElasticTrainer as JElastic
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import loss_fn
from repro_torch.runtime import ElasticTrainer
from repro_torch.tree import value_and_grad

OVER = dict(n_layers=2, d_model=64, vocab=128)
SCHEDULE = [1, 2, 3, 2, 4, 2, 1, 2]


def _batch(s, i, vocab):
    rng = np.random.default_rng(s * 100 + i)
    t = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    return {"tokens": t, "labels": t}


def test_elastic_dp_matches_jax():
    cfg = reduced(get_arch("tinyllama-1.1b"), **OVER)
    tcfg = t_reduced(t_get_arch("tinyllama-1.1b"), **OVER)
    params = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    j_grad = jax.jit(jax.value_and_grad(lambda p, b: j_loss_fn(cfg, p, b)))

    def j_make(s, i):
        return jax.tree.map(jnp.asarray, _batch(s, i, cfg.vocab))

    def t_grad(p, b):
        return value_and_grad(lambda pp, bb: loss_fn(tcfg, pp, bb), p, b)

    def t_make(s, i):
        import torch
        return {k: torch.from_numpy(v)
                for k, v in _batch(s, i, cfg.vocab).items()}

    jrep = JElastic(params, j_grad, j_make, lease=2).run(
        8, schedule=lambda s: SCHEDULE[s])
    trep = ElasticTrainer(tparams, t_grad, t_make, lease=2).run(
        8, schedule=lambda s: SCHEDULE[s])
    assert trep.joins >= 4 and trep.leaves >= 2
    assert trep.renewals > 0
    assert trep.max_staleness <= 3 * (2 + 1)
    jd, td = dataclasses.asdict(jrep), dataclasses.asdict(trep)
    for key in jd:
        if key != "losses":
            assert td[key] == jd[key], key
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=2e-4)
