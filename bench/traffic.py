"""The one traffic generator: closed-loop clients in multi-turn sessions.

A mix is a data file (``bench/mixes/<name>.json``) of parameters; this
module reads any of them.  Every client holds one session at a time and
sends its next request the moment its last one finishes (no think time).
A session opens with one of the shared system prompts, then a document
and a question; each later turn sends the previous prompt, the previous
answer as served and a new message.  A session ends after its turns, or
early when the next prompt plus its answer would pass ``max_context``;
the client then opens its next session.

With ``"fresh_tokens": true`` every prompt is drawn anew at the length the
shared mix would give it (the previous answer counted at its length), so
no block is ever reused: the control for anything that works through
prefix reuse.

Sizes come from the mix's own ``sizes_seed``: sessions open in the pool's
order, so every run seed serves the same sizes and arrivals.  The run
seed orders the clients' first sends (which client, and so which replica,
takes which session) and draws every token id (uniform over the
vocabulary).

A mix file also names the published trace its lengths follow (``source``)
and the cuts from it (``scale``, ``cuts``); ``request_stats`` gives what
the shape pool makes of it, for the tests to hold against the source.
Only closed loops without think time are implemented: a key this module
does not read is refused, so a mix that asks for more fails to load.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

MIX_DIR = Path(__file__).resolve().parent / "mixes"
POOL_SESSIONS = 4096            # session shapes drawn per mix


# keys a mix file may hold: what the generator reads, and the record of
# where its lengths come from
MIX_KEYS = {"about", "source", "scale", "cuts", "assumed", "sizes_seed",
            "system_prompts", "document", "question", "message", "answer",
            "turns", "max_context", "fresh_tokens", "warmup_ticks"}


def load_mix(name: str) -> Dict:
    with open(MIX_DIR / f"{name}.json") as f:
        mix = json.load(f)
    unknown = sorted(set(mix) - MIX_KEYS)
    if unknown:
        raise ValueError(f"mix {name!r}: keys {unknown} are not implemented "
                         f"(closed-loop sessions only; see traffic.py)")
    return mix


def _length(rng: np.random.Generator, spec: Dict, n: int) -> np.ndarray:
    """Log-normal lengths around ``median`` with log-sd ``sigma``, rounded
    and clipped to [min, max]."""
    x = spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class SessionShape:
    system: int                 # which shared system prompt
    first: int                  # document + question tokens of turn 0
    messages: tuple             # new-message tokens of turns 1..
    answers: tuple              # max_new of each turn


def session_shapes(mix: Dict) -> List[SessionShape]:
    """The mix's pool of session shapes, from its ``sizes_seed`` alone."""
    rng = np.random.default_rng(mix["sizes_seed"])
    n = POOL_SESSIONS
    lo, hi = mix["turns"]["min"], mix["turns"]["max"]
    turns = rng.integers(lo, hi + 1, n)
    system = rng.integers(0, mix["system_prompts"]["count"], n)
    doc = _length(rng, mix["document"], n)
    question = _length(rng, mix["question"], n)
    msgs = _length(rng, mix["message"], (n, hi))
    answers = _length(rng, mix["answer"], (n, hi))
    return [SessionShape(int(system[i]), int(doc[i] + question[i]),
                         tuple(int(m) for m in msgs[i, 1:turns[i]]),
                         tuple(int(a) for a in answers[i, :turns[i]]))
            for i in range(n)]


def request_stats(mix: Dict, block_tokens: int) -> Dict[str, float]:
    """What the shape pool makes of the mix, over every request its
    sessions send (the session cap applied; an answer served at its
    ``max_new``): mean prompt and answer tokens, mean pages of prompt +
    answer (a configuration's decode-page region is its clients times
    this), and the share of prompt tokens an unbounded prefix cache would
    serve (whole blocks of an earlier request's prompt: a shared system
    prompt once seen, a session's previous prompt; none with fresh
    tokens)."""
    bt = block_tokens
    sys_len = mix["system_prompts"]["tokens"]
    cap = mix["max_context"]
    fresh = bool(mix.get("fresh_tokens", False))
    seen, n, inp, out, pages, reuse = set(), 0, 0, 0, 0, 0
    for sh in session_shapes(mix):
        plen, prev = sys_len + sh.first, 0
        for t, ans in enumerate(sh.answers):
            if t:
                plen += sh.answers[t - 1] + sh.messages[t - 1]
            if plen + ans > cap:
                break
            hit = prev if t else (sys_len if sh.system in seen else 0)
            if not fresh:
                reuse += hit // bt * bt
            seen.add(sh.system)
            n, inp, out = n + 1, inp + plen, out + ans
            pages += -(-(plen + ans) // bt)
            prev = plen
    return {"requests": n, "mean_input": inp / n, "mean_output": out / n,
            "mean_context_pages": pages / n, "reuse_share": reuse / inp}


@dataclasses.dataclass
class Send:
    """One request as a client sends it."""
    client: int
    prompt: np.ndarray          # int32 token ids
    max_new: int
    turn: int


class ClosedLoop:
    """``clients`` callers, each in its own run of sessions."""

    def __init__(self, mix: Dict, seed: int, clients: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.clients = int(clients)
        self.vocab = int(vocab)
        self.shapes = session_shapes(mix)
        self.start_order = np.random.default_rng(
            [self.seed, 0]).permutation(self.clients)
        sp = mix["system_prompts"]
        srng = np.random.default_rng([self.seed, 1])
        self.systems = [srng.integers(0, self.vocab, sp["tokens"])
                        .astype(np.int32) for _ in range(sp["count"])]
        self.fresh = bool(mix.get("fresh_tokens", False))
        self.cap = int(mix["max_context"])
        self._sessions_opened = 0
        # per client: its session slot, shape, turn and last prompt
        self._state: List[Optional[Dict]] = [None] * self.clients

    def _tokens(self, n: int, *key) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 2, *key])
        return rng.integers(0, self.vocab, n).astype(np.int32)

    def _open(self, client: int) -> Send:
        slot = self._sessions_opened
        self._sessions_opened += 1
        shape = self.shapes[slot % len(self.shapes)]
        body = self._tokens(shape.first, slot, 0)
        if self.fresh:
            sys_tok = self._tokens(len(self.systems[shape.system]), slot,
                                   0, 1)
        else:
            sys_tok = self.systems[shape.system]
        prompt = np.concatenate([sys_tok, body])
        self._state[client] = {"slot": slot, "shape": shape, "turn": 0,
                               "prompt": prompt}
        return Send(client, prompt, shape.answers[0], 0)

    def first(self, client: int) -> Send:
        return self._open(client)

    def next(self, client: int, answer: np.ndarray) -> Send:
        """The client's next request, its last one answered with
        ``answer`` (the served tokens)."""
        st = self._state[client]
        shape, t = st["shape"], st["turn"] + 1
        if t < len(shape.answers):
            msg_len = shape.messages[t - 1]
            plen = len(st["prompt"]) + len(answer) + msg_len
            if plen + shape.answers[t] <= self.cap:
                if self.fresh:
                    prompt = self._tokens(plen, st["slot"], t)
                else:
                    prompt = np.concatenate(
                        [st["prompt"], np.asarray(answer, np.int32),
                         self._tokens(msg_len, st["slot"], t)])
                st["turn"], st["prompt"] = t, prompt
                return Send(client, prompt, shape.answers[t], t)
        return self._open(client)
