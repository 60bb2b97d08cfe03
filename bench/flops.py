"""Operations and bytes the work needs, and the card's published peaks.

Frozen here so that a change to the program cannot change its yardstick.
The rules are those the port's kernel table uses: each input and output
byte counted once, operations at their type's peak, and a kernel's least
time the larger of its operations over the peak rate and its bytes over
the memory bandwidth.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM (data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def layer_weight_params(run: Dict) -> int:
    """Parameters of one decoder layer's projections (norm gains left
    out: they cost no multiply-adds worth counting)."""
    d, f = run["d_model"], run["d_ff"]
    qd = run["n_heads"] * run["head_dim"]
    kd = run["n_kv_heads"] * run["head_dim"]
    return d * qd + 2 * d * kd + qd * d + 3 * d * f


def attn_pair_flops(run: Dict) -> int:
    """Operations of one (query, key) pair over every head of one layer:
    the score's and the output's multiply-adds, 4 Dh a head."""
    return 4 * run["head_dim"] * run["n_heads"]


def causal_pairs(n_q: int, q_offset: int) -> int:
    """(query, key) pairs a causal pass over ``n_q`` queries at positions
    ``q_offset .. q_offset + n_q - 1`` attends."""
    return n_q * q_offset + n_q * (n_q + 1) // 2


def prefill_flops(run: Dict, computed: int, skipped: int) -> int:
    """A prompt prefill that computes ``computed`` tokens after
    ``skipped`` tokens served from the pool: every layer's projections for
    the computed tokens, attention over the causal pairs, and the head
    once (the logits of the last position)."""
    n = run["n_layers"]
    return (2 * n * layer_weight_params(run) * computed
            + n * attn_pair_flops(run) * causal_pairs(computed, skipped)
            + 2 * run["d_model"] * run["vocab"])


def decode_flops(run: Dict, lengths) -> int:
    """A decode step over streams holding ``lengths`` tokens each: one new
    token a stream, attending its ``length + 1`` keys."""
    n, b = run["n_layers"], len(lengths)
    keys = sum(int(x) + 1 for x in lengths)
    return (2 * n * layer_weight_params(run) * b
            + n * attn_pair_flops(run) * keys
            + 2 * run["d_model"] * run["vocab"] * b)


def k4_work(run: Dict, lengths, elem_bytes: int = 2):
    """(flops, bytes) of one paged-decode attention call (K4, one layer)
    over streams with ``lengths`` tokens in pages: every live K and V row
    read once, q, the fresh k / v and the output once."""
    dh, h, hk = run["head_dim"], run["n_heads"], run["n_kv_heads"]
    b = len(lengths)
    keys = sum(int(x) + 1 for x in lengths)
    rows = sum(int(x) for x in lengths)
    nbytes = elem_bytes * (rows * 2 * hk * dh + b * (2 * h * dh + 2 * hk * dh))
    return attn_pair_flops(run) * keys, nbytes


def k6_work(run: Dict, n_q: int, q_offset: int, n_kv: int,
            elem_bytes: int = 2):
    """(flops, bytes) of one causal flash-prefill call (K6, one layer):
    ``n_q`` queries at ``q_offset`` over ``n_kv`` keys; q, k, v read once
    and the output written once."""
    dh, h, hk = run["head_dim"], run["n_heads"], run["n_kv_heads"]
    nbytes = elem_bytes * dh * (2 * h * n_q + 2 * hk * n_kv)
    return attn_pair_flops(run) * causal_pairs(n_q, q_offset), nbytes
