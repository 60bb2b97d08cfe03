"""Exhaustive BFS enumeration of the guarded-action Tardis model.

Walks every reachable state of a bounded :class:`~repro_torch.analysis.model.
Config`, checking the proof's invariants on each state and each transition:

  * ``wts <= rts`` on every valid line (private and LLC),
  * a single exclusive owner, consistent with the manager's owner field,
  * value--timestamp consistency: a load at ``pts`` returns the version
    whose ``[wts, rts]`` validity interval contains it,
  * per-core ``pts`` monotonicity on every non-rebase transition,
  * no-deadlock: at least one rule is enabled in every reachable state.

Violations come back with a *witness trace* -- the rule sequence from the
initial state -- reconstructed from BFS parent pointers.  When a
:class:`~repro_torch.analysis.bridge.Bridge` is supplied, every distinct
protocol-scalar call and manager-table operation recorded on a transition
is replayed against the port's ``core.protocol`` and ``LeaseEngine`` and
must match bit-for-bit.  (The port's copy of ``repro.analysis.explore``.)
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .model import TardisModel


@dataclass
class Violation:
    kind: str                 # "state" | "transition" | "deadlock" | "cap"
    message: str
    state_repr: str
    trace: List[str]          # rule names from the initial state

    def __str__(self):
        path = " -> ".join(self.trace) if self.trace else "<initial>"
        return f"[{self.kind}] {self.message}\n  at {self.state_repr}\n" \
               f"  via {path}"


@dataclass
class ExploreResult:
    closed: bool              # frontier exhausted (not capped)
    n_states: int
    n_transitions: int
    max_depth: int
    wall_time: float
    violations: List[Violation] = field(default_factory=list)
    rule_counts: Dict[str, int] = field(default_factory=dict)
    bridge_counts: Dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.closed and not self.violations


def explore(model: TardisModel, bridge=None, max_states: int = 2_000_000,
            max_violations: int = 16) -> ExploreResult:
    """BFS from the initial state until the frontier closes.

    Stops early once ``max_states`` distinct states have been expanded
    (``closed=False``) or ``max_violations`` have been collected.
    """
    if bridge is not None and model.is_mutant:
        raise ValueError(
            "cross-validation bridge requires the default rule set -- a "
            "mutant would fail transcription checks before its semantic "
            "bug ever reached the invariant checker")
    t0 = time.perf_counter()
    init = model.initial_state()
    # state -> (parent_state or None, rule_name, depth)
    seen: Dict[tuple, Tuple[Optional[tuple], str, int]] = {
        init: (None, "", 0)}
    frontier = deque([init])
    res = ExploreResult(closed=True, n_states=0, n_transitions=0,
                        max_depth=0, wall_time=0.0)

    def trace_of(state) -> List[str]:
        rules = []
        cur = state
        while True:
            parent, rule, _ = seen[cur]
            if parent is None:
                break
            rules.append(rule)
            cur = parent
        rules.reverse()
        return rules

    def add_violation(kind, message, state):
        res.violations.append(Violation(
            kind, message, model.describe(state), trace_of(state)))

    for bad in model.check_state(init):
        add_violation("state", bad, init)

    while frontier:
        if res.n_states >= max_states:
            res.closed = False
            break
        if len(res.violations) >= max_violations:
            res.closed = False
            break
        state = frontier.popleft()
        depth = seen[state][2]
        res.n_states += 1
        res.max_depth = max(res.max_depth, depth)
        n_succ = 0
        for nxt, info in model.successors(state):
            n_succ += 1
            res.n_transitions += 1
            res.rule_counts[info.rule] = res.rule_counts.get(info.rule,
                                                            0) + 1
            fresh = nxt not in seen
            if fresh:
                seen[nxt] = (state, info.rule, depth + 1)
            for bad in info.violations:
                add_violation("transition", bad,
                              nxt if fresh else state)
            if bridge is not None:
                for bad in bridge.validate(info):
                    add_violation("transition", f"bridge: {bad}",
                                  nxt if fresh else state)
            if fresh:
                if len(res.violations) < max_violations:
                    for bad in model.check_state(nxt):
                        add_violation("state", bad, nxt)
                frontier.append(nxt)
        if n_succ == 0:
            add_violation("deadlock", "no rule enabled", state)

    res.wall_time = time.perf_counter() - t0
    if bridge is not None:
        res.bridge_counts = dict(bridge.counts)
    return res
