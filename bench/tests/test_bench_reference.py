"""The plain reference against the port's CPU path at a tiny size, from
the benchmark's own weights (this test may import both; the reference
module may not)."""
import numpy as np
import pytest
import torch

import tiny
import weights
from reference.model import logits_at


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_bench_reference_matches_port_forward(seed):
    from repro_torch.models.transformer import forward, logits_fn
    cfg = tiny.tiny_arch(tiny.CONF)
    w = weights.draw(tiny.RUN, seed, "cpu", dtype=torch.float32)
    p = weights.port_params(w)
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, tiny.RUN["vocab"], (1, 40)))
    port = logits_fn(cfg, p, forward(cfg, p, {"tokens": toks}))[0]
    ref = logits_at(tiny.RUN, w, [toks[0]], [range(40)])[0]
    np.testing.assert_allclose(ref.numpy(), port.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_bench_reference_matches_port_paged_serving():
    """Prefill into pool pages, a prefix-hit suffix prefill and paged
    decode steps of the port (CPU, fp32 weights) give the reference's
    greedy tokens and logits."""
    from repro_torch.runtime import Request, ServingCluster
    cfg = tiny.tiny_arch(tiny.CONF)
    w = weights.draw(tiny.RUN, 5, "cpu", dtype=torch.float32)
    p = weights.port_params(w)
    cl = ServingCluster(cfg, lambda: p, n_replicas=1, n_prefix_blocks=64,
                        prefix_block_tokens=16, n_decode_pages=32,
                        max_pages=8, device="cpu", max_batch=2)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 256, 48).astype(np.int32)
    reqs = [Request(i, np.concatenate([shared, rng.integers(
        0, 256, 5 + i).astype(np.int32)]), max_new=6) for i in range(3)]
    cl.trace = []
    cl.run(reqs)
    assert cl.prefix_stats["prefix_prefill_tokens_skipped"] > 0
    for r in reqs:
        seq = torch.as_tensor(np.concatenate([r.prompt, r.output[:-1]]))
        pos = range(len(r.prompt) - 1, len(seq))
        ref = logits_at(tiny.RUN, w, [seq], [pos])[0]
        assert ref.argmax(-1).tolist() == r.output.tolist()


def test_bench_fp8_control_departs_from_the_reference():
    w = weights.draw(tiny.RUN, 8, "cpu", dtype=torch.bfloat16)
    toks = torch.as_tensor(np.random.default_rng(8).integers(0, 256, 64))
    ref = logits_at(tiny.RUN, w, [toks], [range(64)])[0]
    low = logits_at(tiny.RUN, w, [toks], [range(64)], quant="fp8")[0]
    err = (ref - low).abs().max().item()
    assert 1e-3 < err < 1.0
