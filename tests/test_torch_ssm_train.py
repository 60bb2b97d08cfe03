"""The ssm and hybrid families through the port's fault-tolerant training
loop, kernel route forced on the CPU, against the JAX package's loop.

Reduced mamba2-130m and zamba2-2.7b (fp32) take two ``runtime.train``
steps in each package from one initial state: every step's loss within
rtol 2e-4 (``tests/test_torch_train.py``'s ``STEP_LOSS``) and every
parameter leaf after the two AdamW steps within 1e-4 of the leaf's
largest magnitude.  The port's SSD scans and gated norms run as the
``torch.autograd.Function``s of K7 / K12 and K8 / K11's gate variant
(their plain versions on CPU tensors), and each backward wrapper runs
once a Mamba2 layer a step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced
from repro.models import init_params as j_init_params
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import train as j_train
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import attention, layers, ssm
from repro_torch.runtime import TrainConfig, train
from repro_torch.tree import leaves

STEP_LOSS = dict(rtol=2e-4, atol=0)
PARAM_REL = 1e-4


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_two_train_steps_match_jax(arch, monkeypatch):
    monkeypatch.setattr(attention, "_flash_kernel_eligible",
                        lambda q, k, window: window == 0)
    monkeypatch.setattr(ssm, "_ssd_kernel_eligible", lambda x: True)
    monkeypatch.setattr(layers, "_rmsnorm_kernel_eligible", lambda x: True)
    calls = {"ssd": 0, "gate": 0}
    sb, nb = ssd_ops.ssd_chunk_backward, norm_ops.rmsnorm_backward_gate

    def ssd_count(*a, **k):
        calls["ssd"] += 1
        return sb(*a, **k)

    def norm_count(*a, **k):
        calls["gate"] += 1
        return nb(*a, **k)
    monkeypatch.setattr(ssd_ops, "ssd_chunk_backward", ssd_count)
    monkeypatch.setattr(norm_ops, "rmsnorm_backward_gate", norm_count)

    cfg = reduced(get_arch(arch))
    tcfg = t_reduced(t_get_arch(arch))
    params = j_init_params(cfg, jax.random.PRNGKey(1), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    kw = dict(steps=2, batch=2, seq=32, warmup=1, base_lr=1e-3)
    jout = j_train(cfg, params, JTrainConfig(**kw))
    tout = train(tcfg, tparams, TrainConfig(**kw), device="cpu")
    assert calls == {"ssd": 2 * cfg.n_layers, "gate": 2 * cfg.n_layers}
    assert tout["final_step"] == jout["final_step"] == 2
    np.testing.assert_allclose(tout["losses"], jout["losses"], **STEP_LOSS)
    want = leaves(params_from_jax(jax.tree.map(np.asarray,
                                               jout["params"])))
    got = leaves(tout["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-12)
        err = float((g - w).abs().max())
        assert err <= PARAM_REL * scale, (tuple(g.shape), err, scale)
