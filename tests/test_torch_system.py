"""End-to-end behaviour of the port on the CPU: the twin of
``tests/test_system.py::test_serving_cluster_coherence`` and the CLI smokes
of ``scripts/check.sh`` run in-process.

  * The single-host cluster from the JAX package's weights (carried across
    by ``convert.params_from_jax``) serves the reference test's requests,
    hot-swaps the weights with ``publish_weights`` and serves one more:
    the reference test's assertions hold on the port (every request done
    with its 4 tokens, ``replica_local_hits > 0``, ``data_less_renewals +
    payload_transfers >= 1`` after the swap), each request's greedy tokens
    equal JAX's, and every integer counter of both reports equals the JAX
    cluster's;
  * the one-cell dry run (``launch.dryrun.main``): an ok cell with
    ``flops_total > 0``;
  * the kimi moe serve, the ``--hosts 2`` serve and the ``--roles
    prefill,decode`` serve (``launch.serve.main`` with ``--device cpu``,
    the last two under ``TARDIS_SANITIZE=1``), each with check.sh's argv
    and its ``grep -Eq`` assertions on the printed report, as
    ``chip_smoke.py`` runs them on the card (``CLI_SMOKES``).
"""
import json
import os
import re
import tempfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from repro.configs import get_arch, reduced
from repro.models import init_params
from repro.runtime import Request as JRequest
from repro.runtime import ServingCluster as JCluster
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import dryrun as dryrun_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.runtime import Request, ServingCluster

OVER = dict(n_layers=2, d_model=64, vocab=128)


def _ints(report):
    return {k: v for k, v in report.items()
            if isinstance(v, (int, np.integer)) and not isinstance(v, bool)}


def test_serving_cluster_coherence_matches_jax():
    cfg = reduced(get_arch("tinyllama-1.1b"), **OVER)
    tcfg = t_reduced(t_get_arch("tinyllama-1.1b"), **OVER)
    params = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    kw = dict(n_replicas=2, lease=6, cache_len=64, selfinc_period=2)
    jc = JCluster(cfg, lambda: params, **kw)
    tc = ServingCluster(tcfg, lambda: tparams, device="cpu", **kw)

    def both(reqs_of, swap):
        if swap:
            jc.publish_weights(params)
            tc.publish_weights(tparams)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jdone, jrep = jc.run(reqs_of(JRequest))
        tdone, trep = tc.run(reqs_of(Request))
        for a, b in zip(jdone, tdone):
            np.testing.assert_array_equal(b.output, a.output,
                                          err_msg=f"request {a.rid}")
        assert set(trep) == set(jrep)
        assert _ints(trep) == _ints(jrep)
        return tdone, trep

    done, rep = both(lambda R: [
        R(i, np.arange(1, 9, dtype=np.int32) % OVER["vocab"], max_new=4)
        for i in range(6)], swap=False)
    assert all(r.done and len(r.output) == 4 for r in done)
    assert rep["replica_local_hits"] > 0             # leases actually used
    # weight hot-swap: no invalidations ever recorded by Tardis itself
    _, rep = both(lambda R: [R(99, np.arange(1, 5, dtype=np.int32),
                               max_new=2)], swap=True)
    assert rep["data_less_renewals"] + rep["payload_transfers"] >= 1


def test_dryrun_one_cell_smoke():
    """check.sh's one-cell dry run: an ok cell, nonzero flops."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "dry.json")
        assert dryrun_cli.main(["--mesh", "single", "--archs",
                                "tinyllama-1.1b", "--shapes", "decode_32k",
                                "--no-hlo", "--out", out]) == 0
        with open(out) as f:
            recs = json.load(f)
    ok = [r for r in recs if r["status"] == "ok"]
    assert ok, recs
    assert any(r.get("flops_total", 0) > 0 for r in ok), recs


@pytest.mark.parametrize("smoke", cs.CLI_SMOKES, ids=lambda sm: sm[0])
def test_serve_cli_smoke(smoke, monkeypatch, capsys):
    """``chip_smoke.CLI_SMOKES`` (check.sh's argv and grep patterns) on the
    CPU."""
    _name, argv, sanitize, patterns = smoke
    if sanitize:
        monkeypatch.setenv("TARDIS_SANITIZE", "1")
    done, report = serve_cli.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    for pat in patterns:
        assert re.search(pat, text), (pat, text[-3000:])
    assert all(r.done and len(r.output) == 2 for r in done)
    if sanitize:
        assert report["sanitize_checks"] > 0
