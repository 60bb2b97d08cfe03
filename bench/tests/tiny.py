"""A tiny cell for CPU tests: the harness's whole run at a size the CPU
holds, the port's plain kernel versions under it."""
from __future__ import annotations

import copy
import dataclasses

import harness

RUN = {"family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
       "n_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab": 256,
       "rope_theta": 10000.0, "norm_eps": 1e-05, "tie_embeddings": False,
       "dtype": "bfloat16"}
CONF = {"port_arch": "glm4-9b", "run": RUN,
        "serving": {"replicas": 2, "max_batch": 4, "block_tokens": 16,
                    "max_pages": 16, "n_decode_pages": 96,
                    "n_prefix_blocks": 256}}
LEN = {"sigma": 0.4}
MIX = {"sizes_seed": 7, "system_prompts": {"count": 2, "tokens": 32},
       "document": dict(LEN, median=48, min=32, max=96),
       "question": dict(LEN, median=10, min=8, max=16),
       "message": dict(LEN, median=24, min=16, max=48),
       "answer": dict(LEN, median=6, min=4, max=12),
       "turns": {"min": 2, "max": 3}, "max_context": 256,
       "fresh_tokens": False, "warmup_ticks": 8}
CELL = "tiny.sessions"
BENCH = {"workloads": [{"name": CELL, "config": "tiny", "traffic": "tiny",
                        "chips": 1}],
         "end_to_end": [{"name": n, "unit": u} for n, u in (
             ("tokens_per_s", "tokens/s"), ("ttft_p95_ms", "ms"),
             ("itl_p95_ms", "ms"), ("setup_s", "s"))],
         "per_layer": [{"name": n, "unit": u} for n, u in (
             ("sched.admit_ms", "ms"), ("sched.batch_fill", "%"),
             ("lease.hit_share", "%"), ("lease.skip_share", "%"),
             ("lease.ms_per_tick", "ms"),
             ("mfu", "%"), ("paged_decode_roofline", "%"),
             ("flash_prefill_roofline", "%"), ("device.idle_share", "%"))]}


def tiny_arch(conf):
    """The port's glm4-9b configuration cut to ``RUN``'s sizes."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    r = conf["run"]
    return dataclasses.replace(
        reduced(get_arch(conf["port_arch"])), n_layers=r["n_layers"],
        d_model=r["d_model"], n_heads=r["n_heads"],
        n_kv_heads=r["n_kv_heads"], d_head=r["head_dim"], d_ff=r["d_ff"],
        vocab=r["vocab"])


# the tiny cell's limit: sound runs read 0-0.031 on seeds 1-44, the
# float8 control 0.077-0.754 on the same seeds, a decode step that appends
# no KV 0.35-1.05 on seeds 1-5 (CPU, bf16)
LIMIT = 0.055


def run(monkeypatch, seed=1, seconds=1.5, trace=False, limit=LIMIT,
        fresh=False):
    monkeypatch.setattr(harness, "port_arch", tiny_arch)
    mix = copy.deepcopy(MIX)
    mix["fresh_tokens"] = fresh
    return harness.run_cell(
        CELL, seed, seconds, trace, device="cpu", bench=BENCH,
        conf=copy.deepcopy(CONF), mix=mix,
        check={"logit_gap": {"limit": limit}}, log=lambda m: None)
