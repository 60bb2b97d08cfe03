"""Shared by the simulator twins: one trace through the JAX package's
simulator and through the port's (``device="cpu"``: the plain loop), and
every result field held equal -- stats as floats, cycles, ops, aborted,
pts and each log array."""
import dataclasses

import numpy as np
import torch

from repro_torch.core import Geometry, SimConfig, simulate
from repro_torch.core import traces as TTR

try:
    from repro.core import SimConfig as JaxConfig
    from repro.core import simulate as jax_simulate
    from repro.core.geometry import Geometry as JaxGeometry
    from repro.core.traces import Trace as JaxTrace
except ImportError:      # the card's machine has no JAX: card tests only
    JaxConfig = jax_simulate = JaxGeometry = JaxTrace = None

FIELDS = ("op_type", "op_addr", "op_aux", "op_think")


def pad(tr, length):
    """The trace with END columns appended up to ``length``: the same
    program (a core is done at its first END), and one trace shape for
    many generators, so the JAX runner compiles once per protocol."""
    extra = length - tr.length
    assert extra >= 0, (tr.name, tr.length, length)
    cols = [np.pad(getattr(tr, f), ((0, 0), (0, extra)),
                   constant_values=TTR.END if f == "op_type" else 0)
            for f in FIELDS]
    return type(tr)(*cols, tr.n_addr, tr.name)


def as_port(tr):
    return TTR.Trace(*[getattr(tr, f) for f in FIELDS], tr.n_addr, tr.name)


def as_jax(tr):
    return JaxTrace(*[getattr(tr, f) for f in FIELDS], tr.n_addr, tr.name)


def geom_pair(geom):
    if geom is None:
        return None, None
    kw = dataclasses.asdict(geom)
    return Geometry(**kw), JaxGeometry(**kw)


def assert_same(jres, tres):
    assert sorted(jres.stats) == sorted(tres.stats)
    bad = {k: (jres.stats[k], tres.stats[k]) for k in jres.stats
           if jres.stats[k] != tres.stats[k]}
    assert not bad, bad
    assert (jres.cycles, jres.ops, jres.aborted) == \
        (tres.cycles, tres.ops, tres.aborted)
    np.testing.assert_array_equal(np.asarray(jres.pts), tres.pts)
    assert (jres.log is None) == (tres.log is None)
    if jres.log is not None:
        assert sorted(jres.log) == sorted(tres.log)
        for k in jres.log:
            np.testing.assert_array_equal(np.asarray(jres.log[k]),
                                          tres.log[k], err_msg=k)


def twin(tr, proto, geom=None, log=True, **cfg):
    """(JAX's result, the port's CPU result) of one run, held equal."""
    tg, jg = geom_pair(geom)
    jres = jax_simulate(as_jax(tr), proto, JaxConfig(**cfg), geom=jg,
                        log=log)
    tres = simulate(as_port(tr), proto, SimConfig(**cfg), geom=tg, log=log,
                    device="cpu")
    assert_same(jres, tres)
    return jres, tres


def flat(st, pre=""):
    """{dotted key: tensor} of a (nested) simulator state."""
    out = {}
    for k, v in st.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


def assert_states_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    bad = [k for k in fa if not torch.equal(torch.as_tensor(fa[k]).cpu(),
                                            torch.as_tensor(fb[k]).cpu())]
    assert not bad, bad
