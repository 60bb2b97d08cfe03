"""What decides ``correct``: served tokens held to the plain reference.

Once the window has closed, a sample of the requests the window finished,
drawn from the seed with the longest among them, is run through the
reference over each prompt with its served tokens (teacher-forced).  The
number compared is the widest gap by which a served token's logit lies
below the reference's best logit at its position: 0 where every served
token is the reference's greedy choice, small where bf16 rounding turned
a near tie, large where the program served a token the model would not.
Where the window finished a request whose admission served part of its
prompt from leased pool blocks (a suffix prefill), the sample holds one.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from reference.model import logits_at

SAMPLE_TOKENS = 256     # served tokens compared, at least (where finished)
MAX_SAMPLE = 6          # requests compared, at most


def _skipped(tr) -> int:
    return tr.skipped or 0


def sample(finished: Sequence, seed: int) -> List[Tuple[np.ndarray,
                                                         np.ndarray, int]]:
    """(prompt, served tokens, prompt tokens its admission skipped) of the
    longest finished request, of the first request in an order drawn from
    ``seed`` whose admission skipped tokens (where the longest did not and
    one did), and of others in that order, until SAMPLE_TOKENS served
    tokens or MAX_SAMPLE requests."""
    if not finished:
        return []
    size = [len(tr.req.prompt) + len(tr.req.output) for tr in finished]
    first = int(np.argmax(size))
    out = [finished[first]]
    rest = [tr for i, tr in enumerate(finished) if i != first]
    order = [rest[int(i)] for i in
             np.random.default_rng([int(seed), 3]).permutation(len(rest))]
    if not _skipped(out[0]):
        suffix = [tr for tr in order if _skipped(tr)]
        if suffix:
            out.append(suffix[0])
            order = [tr for tr in order if tr is not suffix[0]]
    served = sum(len(tr.req.output) for tr in out)
    for tr in order:
        if served >= SAMPLE_TOKENS or len(out) >= MAX_SAMPLE:
            break
        out.append(tr)
        served += len(tr.req.output)
    return [(np.asarray(tr.req.prompt), np.asarray(tr.req.output),
             _skipped(tr)) for tr in out]


def _inputs(sample, device):
    seqs = [torch.as_tensor(np.concatenate([p, o[:-1]]).astype(np.int64),
                            device=device) for p, o, _ in sample]
    pos = [range(len(p) - 1, len(p) - 1 + len(o)) for p, o, _ in sample]
    return seqs, pos


def served_gaps(run: Dict, w, sample, device) -> np.ndarray:
    """Each served token's gap below the reference's best logit."""
    seqs, pos = _inputs(sample, device)
    out = []
    for logits, (_p, o, _) in zip(logits_at(run, w, seqs, pos), sample):
        idx = torch.as_tensor(o.astype(np.int64), device=logits.device)
        best = logits.max(dim=-1).values
        out.append((best - logits.gather(1, idx[:, None])[:, 0]).cpu())
    return torch.cat(out).numpy()


def control_gaps(run: Dict, w, sample, device) -> np.ndarray:
    """The control: the gap of the token that the reference in float8
    puts first, at each position of the same prompts and served tokens."""
    seqs, pos = _inputs(sample, device)
    ref = logits_at(run, w, seqs, pos)
    low = logits_at(run, w, seqs, pos, quant="fp8")
    out = []
    for a, b in zip(ref, low):
        pick = b.argmax(dim=-1)
        out.append((a.max(dim=-1).values
                    - a.gather(1, pick[:, None])[:, 0]).cpu())
    return torch.cat(out).numpy()


def judge(run: Dict, w, sample, check: Dict, device, suffix_due: int = 0,
          gaps=served_gaps) -> Dict:
    """The verdict and each number compared beside its limit: the widest
    gap at most the cell's limit, and at least ``suffix_due`` sampled
    requests admitted over leased blocks (1 where the window finished
    one).  ``gaps`` reads the served tokens' gaps; the control passes
    ``control_gaps`` to be judged by the same comparison."""
    lim = float(check["logit_gap"]["limit"])
    n_suffix = sum(1 for _p, _o, skip in sample if skip)
    checks = {"logit_gap": {"value": None, "limit": lim},
              "suffix_sampled": {"value": n_suffix, "limit": suffix_due,
                                 "at_least": True}}
    if not sample:
        return {"correct": False, "served_tokens": 0, "checks": checks}
    g = gaps(run, w, sample, device)
    checks["logit_gap"]["value"] = float(g.max())
    ok = float(g.max()) <= lim and n_suffix >= suffix_due
    return {"correct": bool(ok), "served_tokens": int(g.size),
            "checks": checks}
