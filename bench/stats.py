"""Latency arithmetic over one measured window, frozen with the benchmark.

Times are host-clock seconds.  A request is *sent* at the end of the tick
in which its client's last request finished, and a token *exists* at the
end of the tick that emitted it (the tick ends in the decode step's host
copy of the argmax).
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    order statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttft_samples(sends: Iterable, t0: float, t_end: float) -> List[float]:
    """Seconds to first token of every request sent in [t0, t_end): from
    its send to the tick end that emitted its first token, or to ``t_end``
    where it has none by then.  ``sends`` yields (sent_at, first_at or
    None)."""
    out = []
    for sent, first in sends:
        if not t0 <= sent < t_end:
            continue
        out.append((first if first is not None and first <= t_end
                    else t_end) - sent)
    return out


def itl_samples(token_times: Iterable[Sequence[float]], t0: float,
                t_end: float, running: Iterable[bool]) -> List[float]:
    """Every gap between consecutive tokens of one request that lies in
    [t0, t_end], and the open gap from a running request's last token to
    ``t_end``.  ``token_times`` yields each request's token times in order,
    ``running`` whether that request was still unfinished at ``t_end``."""
    out = []
    for times, live in zip(token_times, running):
        prev = None
        for t in times:
            if t > t_end:
                break
            if prev is not None and prev >= t0:
                out.append(t - prev)
            prev = t
        if live and prev is not None and t0 <= prev < t_end:
            out.append(t_end - prev)
    return out

