"""Spans and counters inside the port: one process-wide tracer, off by
default.

Turned on and off by :func:`enable` / :func:`disable`, read by
:func:`export` and cleared by :func:`reset`; no environment variable or
setting turns it on.  Off, :func:`span` returns the shared :data:`NOOP`
context manager (nothing allocated), callers skip :func:`count` /
:func:`emit` / :func:`event` behind ``if obs.on:``, and :func:`to_host` /
:func:`to_device` are ``t.cpu()`` / ``torch.as_tensor(x, device=device)``
behind one test.  A span site then costs a call and the ``with``
protocol, ~0.26 us on an H100's host (a ``to_host`` ~0.1 us over
``.cpu()``): ~9 us a serving tick.

On, it keeps in memory:

- **spans**: a name, start and end on ``time.perf_counter_ns()`` (the
  benchmark harness's clock), the id of the span that caused it (the
  innermost span open when it began; -1 for none) and, for
  ``host.sync``, the attributes :data:`ATTRS` names;
- **counters** by name and site (``host.syncs``: every blocking copy
  between host and device that the instrumented paths make, at its site;
  on the card each one waits for the stream to drain);
- **emissions** ``(rid, t_ns, n)``: n tokens of request ``rid`` known on
  the host at ``t_ns``;
- **events** ``(rid, t_ns)`` by name (``sched.admitted``: a request
  leaves its queue);
- **anchors** ``(perf_counter_ns, time_ns)``, one at each :func:`enable`
  and :func:`export`, so that :func:`realtime` maps the spans onto the
  realtime clock ``torch.profiler``'s device events carry.

One thread records (the serving loop's); the tracer outlives every
object it observes, so a caller may drop the cluster before it exports.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch

on = False

# attribute names per span name, in the order the span receives them
ATTRS: Dict[str, Tuple[str, ...]] = {"host.sync": ("site", "to_host")}

_clock = time.perf_counter_ns


class _Noop:
    """The span every call returns while the tracer is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NOOP = _Noop()


class _Record:
    """What one tracing session holds: span columns preallocated and
    grown by doubling, the stack of open spans, counters, emissions,
    events and clock anchors."""

    def __init__(self, capacity: int = 1 << 14):
        self.n = 0
        self.name: List = [None] * capacity
        self.t0: List[int] = [0] * capacity
        self.t1: List[int] = [0] * capacity
        self.parent: List[int] = [-1] * capacity
        self.attrs: List[tuple] = [()] * capacity
        self.stack: List[int] = []
        self.counters: Dict[str, Dict[str, int]] = {}
        self.emits: List[Tuple[int, int, int]] = []
        self.events: Dict[str, List[Tuple[int, int]]] = {}
        self.anchors: List[Tuple[int, int]] = []

    def grow(self) -> None:
        k = len(self.name)
        self.name += [None] * k
        self.t0 += [0] * k
        self.t1 += [0] * k
        self.parent += [-1] * k
        self.attrs += [()] * k


_rec = _Record()


class _Span:
    """An open span."""
    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _rec.t1[self.i] = _clock()
        _rec.stack.pop()
        return None


def span(name: str, *attrs):
    """A span over a ``with`` block: ``name`` and its attributes
    (``ATTRS[name]`` names them).  Off: :data:`NOOP`."""
    if not on:
        return NOOP
    r = _rec
    i = r.n
    if i == len(r.name):
        r.grow()
    r.n = i + 1
    r.name[i] = name
    r.parent[i] = r.stack[-1] if r.stack else -1
    r.attrs[i] = attrs
    r.stack.append(i)
    r.t0[i] = _clock()
    return _Span(i)


def count(name: str, site: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` at ``site`` (call behind ``if
    obs.on:``)."""
    c = _rec.counters.get(name)
    if c is None:
        c = _rec.counters[name] = {}
    c[site] = c.get(site, 0) + n


def emit(rid: int, n: int = 1) -> None:
    """``n`` tokens of request ``rid`` are known on the host now (call
    behind ``if obs.on:``)."""
    _rec.emits.append((rid, _clock(), n))


def emit_many(rids) -> None:
    """One token of each of ``rids``, all known now."""
    t = _clock()
    _rec.emits.extend((rid, t, 1) for rid in rids)


def event(name: str, rid: int) -> None:
    """Event ``name`` of request ``rid`` happens now (call behind ``if
    obs.on:``)."""
    ev = _rec.events.get(name)
    if ev is None:
        ev = _rec.events[name] = []
    ev.append((rid, _clock()))


def to_host(t: torch.Tensor, site: str) -> torch.Tensor:
    """``t.cpu()``; on, also a ``host.sync`` span (``to_host`` 1) and one
    ``host.syncs`` at ``site``."""
    if not on:
        return t.cpu()
    with span("host.sync", site, 1):
        out = t.cpu()
    count("host.syncs", site)
    return out


def to_device(x, device, site: str) -> torch.Tensor:
    """``torch.as_tensor(x, device=device)`` of host data ``x`` (a numpy
    array or a list); on, also a ``host.sync`` span (``to_host`` 0) and
    one ``host.syncs`` at ``site``: a copy from pageable host memory waits
    for the device's stream to drain."""
    if not on:
        return torch.as_tensor(x, device=device)
    with span("host.sync", site, 0):
        out = torch.as_tensor(x, device=device)
    count("host.syncs", site)
    return out


def _anchor() -> Tuple[int, int]:
    """One (perf_counter_ns, time_ns) pair, the realtime read between two
    reads of the performance clock."""
    a = _clock()
    real = time.time_ns()
    b = _clock()
    return (a + b) // 2, real


def enable() -> None:
    """Start recording (an anchor is taken)."""
    global on
    _rec.anchors.append(_anchor())
    on = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`reset`."""
    global on
    on = False


def reset() -> None:
    """Drop everything recorded (the on / off state is kept)."""
    global _rec
    _rec = _Record()


def export() -> Dict:
    """What was recorded, as plain lists and dicts (an anchor is taken
    first).  Spans are columns indexed by span id; a span still open has
    ``t1`` 0."""
    r = _rec
    r.anchors.append(_anchor())
    n = r.n
    return {"anchors": [list(a) for a in r.anchors],
            "spans": {"name": r.name[:n], "t0": r.t0[:n], "t1": r.t1[:n],
                      "parent": r.parent[:n],
                      "attrs": [list(a) for a in r.attrs[:n]]},
            "attr_names": {k: list(v) for k, v in ATTRS.items()},
            "counters": {k: dict(v) for k, v in r.counters.items()},
            "emits": [list(e) for e in r.emits],
            "events": {k: [list(e) for e in v] for k, v in r.events.items()}}


def realtime(exported: Dict) -> Callable[[int], int]:
    """The map of a ``perf_counter_ns`` reading onto ``time_ns``, by the
    line through the export's first and last anchors."""
    (p0, r0), (p1, r1) = exported["anchors"][0], exported["anchors"][-1]
    rate = (r1 - r0) / (p1 - p0) if p1 > p0 else 1.0
    return lambda t: r0 + round((t - p0) * rate)
