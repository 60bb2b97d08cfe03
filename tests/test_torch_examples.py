"""The port's example twins against the JAX package's examples, on the CPU.

Both sides start from the JAX package's weights (``init_params`` from
``PRNGKey(0)``, carried across by ``convert.params_from_jax``) and take the
same requests, batches and schedules; the JAX side runs its example's own
code (``examples/*.py`` loaded as modules), its Pallas kernels in
interpret mode as its own tests run them.  Held:

  * ``serve_tardis_torch`` at ``scripts/check.sh``'s argv under
    ``TARDIS_SANITIZE=1``: every request's greedy stream identical and
    every integer counter of the two ``coherence_report``s equal, after
    the first half of the stream and after the ``publish_weights``
    hot-swap and the second half; the example's ``--check`` assertions;
  * ``elastic_dp_torch``: every integer of the report equal, each worker
    step's loss within rtol 2e-4 of JAX's (``test_torch_elastic.py``'s
    tolerance; the JAX example's gradient function is compiled with
    ``jax.jit`` here, its code otherwise unchanged -- eager it takes ~80 s);
  * ``train_ft_lm_torch`` at its default config cut to 12 steps (a crash
    at step 6, a checkpoint every 4): restarts and final step equal, every
    step's loss, replays included, within rtol 2e-4 (``test_torch_train.py``);
  * ``quickstart_torch``'s part 4 against the JAX quickstart's
    ``tiny_training``: its 20 losses within rtol 2e-4;
  * the three example twins import with ``jax`` and ``repro`` made
    unimportable.
"""
import dataclasses
import subprocess
import sys
import tempfile
import textwrap
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced
from repro.models import init_params
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import train as j_train
from chip_smoke import _example as _load
from repro_torch.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
STEP_LOSS = dict(rtol=2e-4, atol=0)
# scripts/check.sh's serving smoke
SERVE_ARGV = ["--replicas", "2", "--requests", "16", "--max-new", "4",
              "--layers", "2", "--d-model", "64", "--check"]


def _to_torch(params):
    return params_from_jax(jax.tree.map(np.asarray, params))


def _ints(report):
    return {k: v for k, v in report.items()
            if isinstance(v, (int, np.integer)) and not isinstance(v, bool)}


def test_serving_example_matches_jax(monkeypatch):
    monkeypatch.setenv("TARDIS_SANITIZE", "1")
    jmod = _load("serve_tardis")
    seen = {}

    class Recording(jmod.ServingCluster):
        def __init__(self, cfg, init_params_fn, **kw):
            seen["params"] = init_params_fn()
            seen["cluster"] = self
            super().__init__(cfg, init_params_fn, **kw)

        def run(self, requests):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                done, report = super().run(requests)
            seen.setdefault("runs", []).append(
                ([r.output.copy() for r in requests], dict(report)))
            return done, report

    monkeypatch.setattr(jmod, "ServingCluster", Recording)
    monkeypatch.setattr(sys, "argv", ["serve_tardis.py"] + SERVE_ARGV)
    jmod.main()
    assert len(seen["runs"]) == 2

    tmod = _load("serve_tardis_torch")
    args = tmod.parse_args(SERVE_ARGV + ["--device", "cpu"])
    cfg = tmod.model_config(args)
    cluster, reqs, reports, wts, _dt = tmod.serve(
        cfg, _to_torch(seen["params"]), args, "cpu")
    assert wts == seen["cluster"].publisher.pts
    half = len(reqs) // 2
    for (j_out, j_rep), t_reqs, t_rep in zip(
            seen["runs"], (reqs[:half], reqs[half:]), reports):
        assert len(j_out) == len(t_reqs)
        for a, r in zip(j_out, t_reqs):
            np.testing.assert_array_equal(r.output, a,
                                          err_msg=f"request {r.rid}")
        assert set(t_rep) == set(j_rep)
        j_ints, t_ints = _ints(j_rep), _ints(t_rep)
        j_ints.pop("sanitize_checks", None)
        assert t_ints.pop("sanitize_checks", 0) > 0
        assert t_ints == j_ints
    tmod.check(cluster, reqs, reports[1], args)


def test_elastic_example_matches_jax(monkeypatch):
    jmod = _load("elastic_dp")
    seen = {}

    class Recording(jmod.ElasticTrainer):
        def __init__(self, params, grad_fn, make_batch, **kw):
            seen["params"], seen["kw"] = params, kw
            super().__init__(params, jax.jit(grad_fn), make_batch, **kw)

        def run(self, steps, schedule):
            seen["rep"] = super().run(steps, schedule)
            return seen["rep"]

    monkeypatch.setattr(jmod, "ElasticTrainer", Recording)
    jmod.main()
    assert seen["kw"] == dict(lease=2, lr=3e-3)

    tmod = _load("elastic_dp_torch")
    trep = tmod.run(tmod.model_config(), _to_torch(seen["params"]), "cpu")
    jd, td = dataclasses.asdict(seen["rep"]), dataclasses.asdict(trep)
    assert trep.steps == len(tmod.SCHEDULE) == 16
    assert trep.joins >= 4 and trep.leaves >= 2 and trep.renewals > 0
    for key in jd:
        if key != "losses":
            assert td[key] == jd[key], key
    np.testing.assert_allclose(trep.losses, seen["rep"].losses, **STEP_LOSS)


def test_training_example_matches_jax():
    tmod = _load("train_ft_lm_torch")
    tcfg, steps, batch, seq = tmod.model_config(steps=12)
    assert (steps, batch, seq, tcfg.n_layers, tcfg.d_model) == \
        (12, 8, 128, 4, 256)
    cfg = reduced(get_arch("tinyllama-1.1b"), n_layers=4, d_model=256,
                  n_heads=8, n_kv_heads=4, d_ff=512, d_head=32, vocab=2048)
    params = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = _to_torch(params)      # before JAX's step donates them
    with tempfile.TemporaryDirectory() as d:
        tc = dataclasses.replace(
            tmod.train_config(steps, batch, seq, d + "/t"), ckpt_every=4)
        assert (tc.fail_at_step, tc.n_micro, tc.grad_compression) == \
            (6, 2, True)
        jkw = {f.name: getattr(tc, f.name)
               for f in dataclasses.fields(JTrainConfig)}
        jout = j_train(cfg, params, JTrainConfig(**{**jkw,
                                                    "ckpt_dir": d + "/j"}))
        tout, _stragglers, _dt = tmod.run(tcfg, tparams, tc, "cpu")
    assert tout["restarts"] == jout["restarts"] == 1
    assert tout["final_step"] == jout["final_step"] == 12
    assert tout["losses"][-1] < tout["losses"][0]
    # the 12 steps and the 2 replayed after the restore from step 4
    assert len(tout["losses"]) == len(jout["losses"]) == 14
    np.testing.assert_allclose(tout["losses"], jout["losses"], **STEP_LOSS)


def test_quickstart_training_matches_jax(monkeypatch):
    jmod = _load("quickstart")
    seen = {}

    def recording_train(cfg, params, tc):
        seen["params"] = _to_torch(params)   # before JAX's step donates them
        seen["out"] = j_train(cfg, params, tc)
        return seen["out"]

    monkeypatch.setattr(jmod, "train", recording_train)
    jmod.tiny_training()
    tmod = _load("quickstart_torch")
    tout = tmod.tiny_training("cpu", params=seen["params"])
    assert len(tout["losses"]) == len(seen["out"]["losses"]) == 20
    np.testing.assert_allclose(tout["losses"], seen["out"]["losses"],
                               **STEP_LOSS)


def test_example_twins_import_without_jax():
    code = textwrap.dedent(f"""
        import importlib.util, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path.insert(0, {str(ROOT / "src")!r})
        for name in ("serve_tardis_torch", "elastic_dp_torch",
                     "train_ft_lm_torch", "quickstart_torch"):
            spec = importlib.util.spec_from_file_location(
                name, {str(EXAMPLES)!r} + "/" + name + ".py")
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        assert "jax" not in [m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["ok"]


@pytest.mark.parametrize("name", ["serve_tardis_torch", "elastic_dp_torch",
                                  "train_ft_lm_torch", "quickstart_torch"])
def test_example_twins_default_to_the_card(name, monkeypatch):
    """Without ``--device`` an example resolves its device to the card: with
    no card ``pick_device`` raises, naming ``device='cpu'`` (no fall-back to
    the CPU); with one the example's device is cuda (stopped there, before
    it runs)."""
    import torch
    mod = _load(name)
    resolved = []

    class Resolved(Exception):
        pass

    def recording(device=None):
        resolved.append(pick(device))
        raise Resolved

    pick = mod.pick_device
    monkeypatch.setattr(mod, "pick_device", recording)
    run = ((lambda: mod.tiny_training(None)) if name == "quickstart_torch"
           else (lambda: mod.main([])))
    if torch.cuda.is_available():
        with pytest.raises(Resolved):
            run()
        assert [d.type for d in resolved] == ["cuda"]
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
        assert resolved == []
