#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit; build every CUDA kernel from
     ``src/repro_torch/kernels/*/csrc/*.cu`` with nvcc for sm_90a; a
     library kernel launched before the first torch.profiler session,
     and whether the profiler records the library's launches;
  2. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes (tinyllama-1.1b full width: token row 11264,
     chunk 16, B = 8, P = 32, 4608 blocks): K1-K3 bit for bit (K1 and K2
     one kernel and no other work a call, by a CUDA graph's nodes; K2
     also with no block and every block masked), K4 -- also at kimi-k2's attention (Hkv 8,
     G 8, Dh 112, its moe stack's segment at column 1792 of the token
     row) and arctic's (Dh 128, G 7) -- within
     the bf16 (3e-2, and one bf16 ulp: its tensor-core variant) and fp32
     (2e-4: its SIMT variant) tolerances; median times (CUDA events):
     each kernel's and library call's device time
     (CUDA-graph replay), the eager wrapper call and the eager plain
     version, and each kernel's bound (the larger of its bytes at
     3.35 TB/s and its ops at the peak of their type: fp32 67 TFLOP/s,
     bf16 tensor cores 989 TFLOP/s); K9 (the coherence simulator's whole
     loop, one launch) against its plain loop on the card, every tensor
     of the final state bit for bit, in each variant that takes the state
     (the L1 in shared memory, "smem", or in global memory) and the
     variants against each other, over the litmus, fft at 16 cores
     (both protocols), the tiny-cache geometry, ts_bits=4, the E-state,
     Ackwise k = 4 and speculation off: ms and us a simulated step of K9
     and of the plain loop, bound by its steps times one dependent
     shared-memory round trip plus its LLC requests times one dependent
     L2 round trip (the same source's two pointer-chase probes); K11
     also against ``F.rms_norm``'s backward by CUDA-graph replay, and
     its two kernels' times;
  3. the simulator path: every golden run (``tests/data/
     torch_sim_golden.json``: fig4's 48 runs at 64 cores and scale 1.0,
     fig8's 6 at 256 cores) through ``repro_torch.core.simulate`` on the
     card, each one K9 launch (fig4's "smem", fig8's "global") and one
     host sync, bit-identical to its entry and SC-clean; wall ms, steps
     and us a step each, fig4's and fig8's averages as
     ``benchmarks/paper_figs.py`` computes them, K9 against its plain
     loop over fig4/fft/tardis at 64 cores; then
     the main path: ``ServingCluster`` serving full-width, full-depth
     tinyllama-1.1b (random bf16 weights from a seeded generator) on the
     card -- 8 requests sharing a 64-token system prompt -- with every
     kernel's launch count set to 0 before and read after (K4's, and on
     the zamba2 wave path K7's, all on the tensor-core variant); one warm
     decode step through ``decode_step_paged`` with the counts set to 0
     before and read after (K8: 1 plain + 44 add launches) and its device
     kernels printed; then the path again, warm, timed plain and then
     under ``torch.profiler`` (device busy/idle share, time by kernel and
     kind, host time by operator);
     then multi-host serving (``MultiHostServingCluster``: hosts in one
     process ticked in lockstep over one sharded lease directory whose
     tables and home pages sit on the card) at the same width and 8 of
     its 22 layers (``FLEET_LAYERS``: the script's time limit), every
     host on the paged path's pool and the same weight tensors: fleet
     A (2 mixed hosts, 2 shards; requests 0-3 on host 0, then 4-7 on host
     1) and fleet B (prefill, decode, decode; 4 shards; routed), each with
     the launch counts set to 0 before and read after (K1-K4, K6, K8 must
     launch), zero multicasts and invalidation messages, at most one
     message pair per remote shard a wave, host 1's prefix from migrated
     pages (A) and no cold prefill on a decode pod (B), every migrated
     page bit-identical to its home row, the device syncs a directory
     wave costs (``torch.cuda.set_sync_debug_mode``), then each warm and
     then profiled (the card's activity only);
     then the fixed-wave dense-cache path, twice at full width:
     tinyllama-1.1b (22 layers) with prefix_reuse=False and zamba2-2.7b
     at 18 of its 54 layers (3 groups of 6 Mamba2 layers and the shared
     attention; hybrid, its default metadata-only prefix leases), each
     with 4 replicas, 4096-slot
     dense caches and 8 requests of 2048-3072 random prompt tokens and 16
     new tokens -- launch counts set to 0 before each run and read after
     (K5 must launch on both), one decode step as on the paged path (K8:
     tinyllama 1 plain + 44 add, zamba2 18 gate + 7 add), then each again
     warm under the profiler (the card's activity only: idle share, device
     time by kind); then the paged path serving kimi-k2-1t-a32b at full
     width (d_model 7168, 64 / 8 heads, Dh 112, vocab 163840, 384 experts
     top-8, d_ff_expert 2048, a shared expert, the dense layer's d_ff
     16384), depth cut to 2 layers (1 dense + 1 moe: two cache stacks in
     one pool token row), the same traffic as the tinyllama paged path,
     the earlier paths' weights freed first and the card's peak memory
     printed; its launch counts, one decode step and a profiled warm run
     as on the tinyllama paged path;
  4. the same requests at full width and 2 layers on the card and on the
     CPU (the plain versions, by the caller's explicit device="cpu"), bf16
     weights (norm weights drawn too): a serving run on each device --
     identical integer coherence counters, greedy agreement and the
     retired max ratio printed -- then the teacher-forced check: the card
     in bf16, the CPU in bf16 and an fp32 anchor (the same weights
     widened, on the CPU) fed the anchor's greedy tokens through the
     prefill and 4 decode steps, and at every step the card's logits at
     most 2x as far (L2) from the anchor as the CPU's, plus 1e-3 of the
     anchor's norm (``norm_check``); fleet A at full width and 2 layers
     on the card and on the CPU, every integer counter of its report (the
     directory's ``xhost_*`` ledger and the per-host columns) identical,
     greedy agreement and the first ticks' ratio printed; then the wave
     path the same way --
     tinyllama at 2 layers in bf16 and zamba2 at 6 layers (one group) in
     fp32 weights (its bf16 arithmetic is chaotic; the bf16 run's distance
     is printed; its first decode step held to the bf16 tolerance) and,
     teacher-forced with the norm check, in bf16 (K7's tensor-core variant
     in the prefill), 2048-slot caches, short prompts; and a kimi-k2
     paged lane the same way as the tinyllama one, at kimi's attention
     shapes (d_model 7168, Dh 112, G 8) and 2 layers, with the vocab cut
     to 32000 and the experts to 16 (top-8) so the CPU's fp32 anchor
     fits;
  5. the kernel JSON line, then the result line.
The training path (phases 2-4): phase 2 holds K10 (the flash-attention
backward: dq, dk, dv, reading the LSE that K6 wrote) against its plain
version (the closed form over the naive softmax) at the training shape
(B 4, S 1024, 32 / 4 heads, Dh 64) and at the paged suffix's q_offset /
kv_len, and K11 (the RMSNorm backward, plain and add) at (4096, 2048),
each in fp32 (2e-4) and bf16 (3e-2) with two calls bit-identical, beside
SDPA's and ``F.rms_norm``'s backward (eager ``torch.autograd.grad``);
K6's LSE against the plain LSE (2e-4); K10's kernels' times (D, dq,
dk/dv, the GQA partials' sum), its variant, its schedule's largest and
mean CTA work and its two bounds (fp32 SIMT; three TF32 products); K6 at
the training shape in fp32 (its tf32x3 variant) with and without its LSE
write beside SDPA's fp32 forward; phase 3 runs ``runtime.train``
on full-width, full-depth tinyllama-1.1b in fp32 weights (4 steps of
4 x 1024 tokens, no checkpoint; the earlier paths' weights freed first)
with the launch counts set to 0 before and read after (K6 and K10 22 a
step, all on their tf32x3 variants, K8 and K11 45: 1 plain + 44 add),
every parameter's gradient
finite and non-zero, ms a step, tokens/s, the peak memory and one warm
step profiled; phase 4 holds the card against the CPU at full width and 2
layers (loss, every gradient leaf, the parameters after 2 AdamW steps)
and a crash and restart on the card against an uninterrupted run.
The ssm and hybrid families train on the card too: phase 2 holds K12 (the
SSD chunk backward) and K11's gate variant against their plain versions
at zamba2's (2 x 1024 tokens, 80 heads, P = N = 64, Q 256, B / C shared)
and mamba2's (8 x 1024, 24 heads, N 128) training shapes in fp32 (2e-4,
two calls bit-identical), with K7's fp32 forward at both (both kernels on
their tf32x3 variants, the parent's SIMT kernels timed beside them against
the same bound); phase 3
runs ``runtime.train`` on full-width, full-depth zamba2-2.7b (4 steps of
2 x 1024 tokens) and mamba2-130m (3 steps of 8 x 1024) with the launches
per step held (zamba2: K7 / K12 54, all "tf32x3", K8 / K11 73 -- 54 gate
+ 19 add -- and K6 / K10 9), every zamba2 gradient finite and non-zero and
a warm
step profiled; phase 4 holds zamba2 at full width and 6 layers card
against CPU (the tinyllama lane's tolerances) and runs the train CLI for
both families on the card; then, on a one-rank NCCL group, the device
collectives against their numpy mirrors and the 6-layer training state
through ``save_sharded`` / ``restore_sharded`` bit for bit, with GB/s.
Phase 2 also holds K5 (the dense-cache split-KV decode) against its plain
version at both wave shapes (tinyllama: B = 4, Hkv = 4, G = 8, Dh = 64;
zamba2: B = 4, Hkv = 32, G = 1, Dh = 80; T = 4096, kv_len = 3000), with
SDPA over the live slice as its library yardstick; and the prefill
kernels: K6 (causal GQA flash prefill) at both wave paths' 4 x 3072-token
prompts (bf16; zamba2 also fp32) and the paged suffix prefill (16
queries at q_offset 64, kv_len 80) against SDPA -- the suffix also at
kimi-k2's attention (64 / 8 heads, Dh 112) and a cold 64-token kimi
prompt --, K7 (the SSD intra-chunk
scan) at zamba2's (b 4, 12 chunks of 256, 80 heads, N = P = 64; bf16
inputs on its tensor-core variant, bound by its bytes or its three-part
bf16 products at 989 TFLOP/s; fp32 inputs on its tf32x3 variant, timed
beside its bound), K8 (RMSNorm) in each of its variants (plain; add:
the residual add fused in, h equal to the eager add bit for bit; gate:
Mamba2's rmsnorm(y * silu(z))) at the prefill rows (4 x 3072) of
tinyllama's norms and zamba2's, and at decode's rows, every (row, w)
dtype mix, the plain one against ``F.rms_norm`` and the fused ones beside
the eager chain they replace (``unfused_ms``).  K6's bound takes the
bf16 tensor-core peak (989 TFLOP/s); each K6 call's variant is held
(bf16: "wgmma"; fp32: "tf32x3").  Phase 3 asserts that K6 and K8
launch on the paged path and both wave paths and K7 on zamba2's, and
K1-K4, K6 and K8 on the kimi-k2 paged path; every bf16 K6 launch there
on "wgmma".  K3's rows carry the time of the library's empty kernel
(``floor_ms``): the floor any one-launch kernel pays.

    python3 chip_smoke.py --phase4-seeds 0,1,2,3
    python3 chip_smoke.py --phase4-mutants 0,1,2,3

build the kernels and print phase 4's readings (measured, not held) for
weights and requests drawn from each seed: ``--phase4-seeds`` one JSON
line per seed (the retired max ratio and the norm check of each bf16
lane, the zamba2 lane's ratio); ``--phase4-mutants`` each bf16 lane clean
and under each wrapper-level off-by-one (K6 q_offset + 1, K4 lengths - 1,
K5 kv_len - 1, K8's weight rolled, K7's cum shifted by one position on
the zamba2 lanes, K8's add variant dropping r, its gate variant reading z
one column off; the paged-path ones on the kimi lane too), both checks'
readings a line, then
which seeds each check fails for each injection (exit 1 if the new check
misses one the retired check caught).  Phase 1 also counts the HGMMA
instructions (K6's wgmma) in the library's SASS, and the HMMA
instructions (mma.sync) of K4's and K7's tensor-core variants.
The encdec family (whisper-large-v3, arXiv:2212.04356): phase 2 holds
K6 and K10 at its attention shapes (20 / 20 heads, Dh 64, non-causal, 1500
encoder positions: the encoder's self-attention, the prefill's and a
decode step's cross-attention in bf16, training's encoder and
cross-attention in fp32 with the LSE, K10 at both) beside SDPA; phase 3
serves it at full width and 16 + 16 of its 32 + 32 layers (``WS_LAYERS``;
random bf16 weights from seed 0: 4 clips of 1500 frames, a 4-token
prompt, 64 greedy tokens each, 448-slot caches; K6 48 launches a prefill
and 16 a decode step, all "wgmma") and
trains it in fp32 weights (3 steps of 2 clips and 448 tokens; K6 / K10 96
and K8 / K11 161 launches a step); phase 4 holds it at full width and 2 +
2 layers, card against CPU (fp32 loss, gradients and an AdamW step; the
bf16 path teacher-forced).  The protocol model checker (phase 3) closes
the SC, no-pw-opt and TSO lanes of the 2-core / 1-block config with its
bridge replaying every distinct engine read (K1) and write (K2) on the
card, with the numpy lane's counts.
The decoder configurations (phase 3): glm4-9b and mistral-nemo-12b at
their published 40 layers, qwen2-vl-72b at 24 of its 80, llama3-405b at 6
of 126 and arctic-480b at 2 of 35 (``DECODERS``), each at full width on
the paged path with the tinyllama cell's traffic (random bf16 weights from
seed 0, each configuration's freed before the next's): the launch counts
set to 0 before and read after (K1-K4, K6, K8; every K4 launch "mma",
every K6 launch "wgmma"), every request done, the pool finite, a prefix
hit; tokens/s first and warm, the peak memory, one decode step's
launches, a profiled run's idle share.  Phase 2 holds K4 (B 8, P 32: the
paged path's page-table width) and K6 at their attention shapes beside
SDPA -- K6 at what their paged paths give it (a cold prompt padded to 80
tokens, a 16-query suffix at q_offset 64) and, as timing rows no path
runs, at B 4, S 3072 -- and K4's fp32 q over a bf16 pool (fp32 weights on
the paged path) on its SIMT variant.
Then the example twins on the card: ``examples/serve_tardis_torch.py``
at full tinyllama-1.1b (its fp32 weights, traffic and hot-swap, under
TARDIS_SANITIZE=1, every ``--check`` assertion),
``examples/elastic_dp_torch.py`` at its reduced config card against CPU
from the same weights (every worker step's loss within 2e-4) and at full
tinyllama-1.1b in fp32 (its joins, leaves, renewals, data-less renewals
and staleness equal to the reduced run's; again at lr 3e-4, printed),
``examples/train_ft_lm_torch.py --full`` at 60 of its 200 steps
(``TRAIN_EXAMPLE_STEPS``: the script's time limit; one restart, the last
step, a lower loss; ms a step and tokens/s); and
``scripts/check.sh``'s CLI smokes through ``launch.dryrun.main`` and
``launch.serve.main`` on the card, with check.sh's assertions.  Phase 4
holds one teacher-forced paged lane per decoder configuration
(``decoder_phase4_config``: 2 layers, vocab 32000, every MLP width 16,
arctic's experts 16 top-2) with the norm check.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest.mock import patch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
TF32_TC_FLOPS = 495e12           # H100 SXM TF32 tensor cores, dense
BF16_TC_FLOPS = 989e12           # H100 SXM bf16 tensor cores, dense
BF16 = dict(rtol=3e-2, atol=3e-2)
BF16_ULP = dict(rtol=2 ** -7, atol=1e-5)  # one bf16 rounding step apart
FP32 = dict(rtol=2e-4, atol=2e-4)
SEED = 0
# the wrappers whose kernels the paged main path runs (K1-K4, then K6's
# suffix and cold prefills and K8's norms)
PAGED_KERNELS = ("lease_pass", "write_advance", "row_copy.gather",
                 "row_copy.scatter", "paged_decode", "flash_prefill",
                 "rmsnorm")
# ... and each wave path (K5 decode, K6 prefill, K8 norms; K7 for zamba2)
WAVE_KERNELS = {"tinyllama-1.1b": ("dense_decode", "flash_prefill",
                                   "rmsnorm"),
                "zamba2-2.7b": ("dense_decode", "flash_prefill", "ssd_chunk",
                                "rmsnorm")}

# The decoder configurations served on the paged path at full width
# (phase 3) and their depth on the card: the published depth where the
# bf16 weights fit beside the pool (glm4, mistral-nemo), cut where they do
# not (qwen2-vl 80 -> 24, llama3 126 -> 6, arctic 35 -> 2); and the short
# names of their kernel rows
DECODERS = (("glm4-9b", 40), ("mistral-nemo-12b", 40), ("qwen2-vl-72b", 24),
            ("llama3-405b", 6), ("arctic-480b", 2))
DECODER_ROWS = {"glm4-9b": "glm4", "mistral-nemo-12b": "mistral_nemo",
                "qwen2-vl-72b": "qwen2_vl", "llama3-405b": "llama3",
                "arctic-480b": "arctic"}


def log(*a):
    print(*a, flush=True)


def median_ms(fn, iters=20, reps=7):
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, timed with CUDA events after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[len(times) // 2]


def graph_ms(fn, iters=20, reps=7):
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the wrapper's Python and launch overhead drop out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return median_ms(graph.replay, iters=1, reps=reps) / iters


def profile_rows(prof, device_type):
    """``prof.key_averages()``'s rows of one device type (``key``,
    ``count``, ``self_device_time_total`` and ``self_cpu_time_total`` in
    us: the events' own spans, which is their self time where they nest
    nothing -- device kernels, the CUDA runtime's calls), summed straight
    from the profiler's events: key_averages builds a tree of every event
    first, ~0.1 ms of host time an event on the card's machine, which a
    path's 10^5 kernels make many seconds."""
    import collections
    from types import SimpleNamespace
    count, span = collections.Counter(), collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != device_type or e.is_async()
                or e.start_thread_id() != e.end_thread_id()):
            continue
        count[e.name()] += 1
        span[e.name()] += (e.end_ns() - e.start_ns()) / 1e3
    return [SimpleNamespace(key=k, count=n, self_device_time_total=span[k],
                            self_cpu_time_total=span[k])
            for k, n in count.items()]


def device_kernels(fn):
    """{name: count} of the device kernels one call of ``fn`` runs, read
    by ``torch.profiler`` (copies and fills left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in profile_rows(prof, DeviceType.CUDA)
            if not e.key.startswith(("Memcpy", "Memset"))}


def graph_nodes(fn):
    """{name: count} of the work one call of ``fn`` enqueues, read through
    the driver API (``cuGraphGetNodes``) from a CUDA graph captured of the
    call: kernels by their mangled names, fills and copies as "memset" /
    "memcpy", any other node by its type.  Unlike ``torch.profiler`` it
    sees the kernel library's launches whatever came first."""
    import ctypes
    import torch
    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def ok(r, what):
        assert r == 0, f"{what} returned CUresult {r}"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw, n = vp(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (vp * n.value)()
    ok(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = {}
    for node in nodes:
        kind = ctypes.c_int()
        ok(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        key = {1: "memcpy", 2: "memset"}.get(kind.value,
                                             f"node type {kind.value}")
        if kind.value == 0:                 # CU_GRAPH_NODE_TYPE_KERNEL
            # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56
            params = (ctypes.c_byte * 128)()
            ok(cu.cuGraphKernelNodeGetParams_v2(vp(node), params),
               "cuGraphKernelNodeGetParams_v2")
            func, kern = (vp.from_buffer(params, at).value for at in (0, 56))
            name = ctypes.c_char_p()
            if func:
                ok(cu.cuFuncGetName(ctypes.byref(name), vp(func)),
                   "cuFuncGetName")
            else:
                ok(cu.cuKernelGetName(ctypes.byref(name), vp(kern)),
                   "cuKernelGetName")
            key = name.value.decode()
        out[key] = out.get(key, 0) + 1
    del graph
    return out


def profiler_sees_library():
    """Whether ``torch.profiler`` records the kernel library's launches.
    On the H100 it records them only where the library launched a kernel
    before the process's first profiler session (the library links the
    CUDA runtime statically), so K2 runs once first; where the profiler
    still shows none, the kernel splits and idle shares it gives below
    leave the library's kernels out, and the log says so."""
    import torch
    from repro_torch.kernels.tardis_lease import kernel as K
    z = torch.zeros(4608, dtype=torch.int32, device="cuda")
    K.write_advance(z, z, z, 1)
    torch.cuda.synchronize()
    seen = any("write_advance" in k for k in device_kernels(
        lambda: K.write_advance(z, z, z, 1)))
    log("torch.profiler records the kernel library's launches" if seen else
        "torch.profiler records none of the kernel library's launches: "
        "the kernel splits, idle shares and device ms by kind it gives "
        "below leave them out")
    return seen


def timings(kernel, plain, library=None, iters=20, plain_iters=20):
    """ms: the kernel's device time (graph replay); call_ms: one eager
    wrapper call, host overhead included; plain_ms: the plain version,
    eager; library_ms: the library call's device time (graph replay).
    Long calls take fewer ``iters`` (the plain version ``plain_iters``)."""
    return dict(ms=graph_ms(kernel, iters), call_ms=median_ms(kernel, iters),
                plain_ms=median_ms(plain, plain_iters, reps=3 if plain_iters
                                   < 20 else 7),
                library_ms=None if library is None else graph_ms(library,
                                                                  iters))


def bound(nbytes, nops, peak=FP32_FLOPS):
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the operations at ``peak`` (fp32 outside the tensor cores
    by default; the bf16 tensor-core peak for bf16 products)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def variant_of(wrapper, call):
    """``call()`` and the variant of the one launch it made of a wrapper
    that counts its kernels by variant (K4, K7)."""
    before = dict(wrapper.variants)
    out = call()
    (v,) = [k for k, n in wrapper.variants.items() if n != before.get(k, 0)]
    return out, v


def max_err(a, b):
    import torch
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase1_card_and_build():
    import torch
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.library()
    log(f"built {lib.name} from {len(_build.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    profiler_sees_library()
    # K6's bf16 variant must issue wgmma (HGMMA in the library's SASS),
    # K4's, K7's and K12's tensor-core variants mma.sync (HMMA)
    n_hgmma = sum(sass_counts(lib, "HGMMA").values())
    log(f"cuobjdump -sass {lib.name}: {n_hgmma} HGMMA instructions")
    assert n_hgmma, "no HGMMA in the kernel library: K6 issues no wgmma"
    hmma = sass_counts(lib, "HMMA")
    for kernel in ("paged_decode_mma", "ssd_chunk_mma", "ssd_chunk_tf32",
                   "ssd_bwd_tf32"):
        found = {f: n for f, n in hmma.items() if kernel in f}
        log(f"  HMMA in {kernel}: {len(found)} instances, "
            f"{sorted(found.values())} instructions")
        assert found and all(found.values()), f"no HMMA in {kernel}"
    return smi


@functools.lru_cache(maxsize=None)
def _sass(lib):
    """The library's SASS (``cuobjdump -sass``), dumped once."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout


def sass_counts(lib, opcode):
    """{kernel function: how many ``opcode`` lines} in the library's SASS
    (``cuobjdump -sass``)."""
    counts, fn = {}, None
    for line in _sass(lib).splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn and opcode in line and any(
                t.startswith(opcode + ".") or t == opcode
                for t in line.split()):
            counts[fn] += 1
    return {f: n for f, n in counts.items() if n}


def phase2_kernels(rows):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_ref
    from repro_torch.configs import get_arch
    from repro_torch.kernels.tardis_lease import kernel as K
    from repro_torch.kernels.tardis_lease import ref as R
    from repro_torch.models import pool_layout
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    n_blocks, chunk, token_row, n_layers = 4608, 16, 11264, 22
    # --- K1 lease_pass: 4608 blocks, a wave of 4 distinct requesters -----
    n, grp = n_blocks, 4
    wts = randint(0, 1000, (n,))
    rts = wts + randint(0, 200, (n,))
    req = torch.where(randint(0, 2, (n,)) == 1, wts, wts - 1)
    masks = (randint(0, 8, (grp, n)) == 0).to(torch.int32)
    pts = randint(0, 1200, (grp,))
    lvec = randint(16, 512, (n,))
    err = 0.0
    for lease in (64, lvec):
        got = K.lease_pass(wts, rts, req, masks, pts, lease)
        want = R.lease_pass_ref(wts, rts, req, masks, pts, lease)
        for x, y in zip(got, want):
            assert torch.equal(x, y), "K1 lease_pass differs from plain"
            err = max(err, max_err(x, y))
    # --- K2 write_advance ----------------------------------------------
    mask = masks[0]
    for m in (mask, torch.zeros_like(mask), torch.ones_like(mask)):
        got = K.write_advance(wts, rts, m, 500)
        want = R.write_advance_ref(wts, rts, m, 500)
        for x, y in zip(got, want):
            assert torch.equal(x, y), "K2 write_advance differs from plain"
    per_call = graph_nodes(lambda: K.write_advance(wts, rts, mask, 500))
    log(f"K2 write_advance: work in one call (graph nodes): {per_call}")
    assert list(per_call.values()) == [1] and "write_advance" in next(
        iter(per_call)), f"K2 runs {per_call} a call, not one kernel"
    # one launch per call: no fill of the outputs before the kernel
    per_call = graph_nodes(lambda: K.lease_pass(wts, rts, req, masks, pts,
                                                64))
    log(f"K1 lease_pass: work in one call (graph nodes): {per_call}")
    assert list(per_call.values()) == [1] and "lease_pass" in next(
        iter(per_call)), f"K1 runs {per_call} a call, not one kernel"
    nbytes = (3 * n + grp * n + grp) * 4 + (n + grp * n + 1 + grp) * 4
    rows.append(dict(
        name="lease_pass", source="src/repro_torch/kernels/tardis_lease/"
        "csrc/lease_pass.cu", replaces="src/repro/kernels/tardis_lease/"
        "kernel.py:232", max_abs_err=err, shape=f"N={n} G={grp}",
        **timings(lambda: K.lease_pass(wts, rts, req, masks, pts, 64),
                  lambda: R.lease_pass_ref(wts, rts, req, masks, pts, 64)),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 12 * grp * n)))))
    # --- K2's row -----------------------------------------------------------
    nbytes = 3 * n * 4 + (2 * n + 1) * 4
    rows.append(dict(
        name="write_advance", source="src/repro_torch/kernels/tardis_lease/"
        "csrc/write_advance.cu", replaces="src/repro/kernels/tardis_lease/"
        "kernel.py:208", max_abs_err=0.0, shape=f"N={n}",
        **timings(lambda: K.write_advance(wts, rts, mask, 500),
                  lambda: R.write_advance_ref(wts, rts, mask, 500)),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 3 * n)))))
    # --- K3 row_copy: the serving pool, gather of 4 leased blocks ----------
    pool = torch.randn((n_blocks, chunk * token_row), generator=g,
                       device=dev).to(torch.bfloat16)
    bids = randint(0, 4096, (4,))
    got = K.gather_rows(pool, bids)
    want = R.gather_rows_ref(pool, bids, 0, pool.shape[1])
    assert torch.equal(got.view(torch.int16), want.view(torch.int16)), \
        "K3 gather differs from plain"
    view = pool.view(n_blocks * chunk, token_row)
    ridx = randint(0, n_blocks * chunk, (64,))
    for lo, w in ((0, token_row), (256, 512), (5632, 5632)):   # windows
        got = K.gather_rows(view, ridx, col_lo=lo, width=w)
        assert torch.equal(got, R.gather_rows_ref(view, ridx, lo, w)), \
            f"K3 windowed gather ({lo}, {w}) differs from plain"
    nbytes = 2 * bids.numel() * pool.shape[1] * 2 + bids.numel() * 4
    rows.append(dict(
        name="row_copy.gather", source="src/repro_torch/kernels/"
        "tardis_lease/csrc/row_copy.cu", replaces="src/repro/kernels/"
        "tardis_lease/kernel.py:349", max_abs_err=0.0,
        shape=f"pool {tuple(pool.shape)} bf16, n=4",
        **timings(lambda: K.gather_rows(pool, bids),
                  lambda: R.gather_rows_ref(pool, bids, 0, pool.shape[1]),
                  lambda: torch.index_select(pool, 0, bids)),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 0)))))
    # scatter: one decode step's B = 8 token rows; duplicates; a window
    b = 8
    tok = torch.randn((b, token_row), generator=g,
                      device=dev).to(torch.bfloat16)
    sidx = torch.randperm(n_blocks * chunk, generator=g,
                          device=dev)[:b].to(torch.int32)
    dup = torch.tensor([5, 9, 5, 77, 9, 5, 3, 77], dtype=torch.int32,
                       device=dev)
    # ... and 300 entries (the duplicate scan spans several strides of
    # the CTA), id 7 at the first, a middle and the last position
    many = torch.randperm(n_blocks * chunk, generator=g,
                          device=dev)[:300].to(torch.int32)
    many[0] = many[150] = many[299] = 7
    tok_many = torch.randn((300, token_row), generator=g,
                           device=dev).to(torch.bfloat16)
    for idx, lo in ((sidx, 0), (dup, 0), (dup, 2560), (many, 0)):
        w = token_row - lo
        r = (tok_many if idx is many else tok)[:, :w].contiguous()
        a = view.clone()
        c = view.clone()
        K.scatter_rows(a, idx, r, col_lo=lo)
        R.scatter_rows_ref(c, idx, r, lo)
        assert torch.equal(a.view(torch.int16), c.view(torch.int16)), \
            f"K3 scatter (col_lo={lo}) differs from plain"
    del a, c, tok_many
    nbytes = 2 * b * token_row * 2 + b * 4
    lib_idx = sidx.long()
    rows.append(dict(
        name="row_copy.scatter", source="src/repro_torch/kernels/"
        "tardis_lease/csrc/row_copy.cu", replaces="src/repro/kernels/"
        "tardis_lease/kernel.py:314", max_abs_err=0.0,
        shape=f"pool rows {tuple(view.shape)} bf16, n=8",
        **timings(lambda: K.scatter_rows(view, sidx, tok),
                  lambda: R.scatter_rows_ref(view, sidx, tok, 0),
                  lambda: view.index_copy_(0, lib_idx, tok)),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 0)))))
    # --- K4 paged_decode: B=8, P=32, 4 kv heads x 8 query heads, dh 64 ----
    li = n_layers - 1
    hkv, dh = 4, 64
    k4_row(rows, g, "paged_decode", "paged", view, b, hkv, 8, dh, 32, chunk,
           li * hkv * dh, (n_layers + li) * hkv * dh)
    # ... and at the other configs' attention shapes over pools of 2
    # layers: kimi-k2 (Dh 112, G 8; its moe stack's segment at offset 1792
    # of the token row, after the leading dense stack's), arctic (Dh 128,
    # G 7), glm4 (2 kv heads, G 16), mistral-nemo (G 4), qwen2-vl (G 8) and
    # llama3 (G 16), all Dh 128
    for name, arch in (("paged_decode.kimi", "kimi-k2-1t-a32b"),
                       ("paged_decode.arctic", "arctic-480b"),
                       *((f"paged_decode.{DECODER_ROWS[a]}", a)
                         for a, _depth in DECODERS if a != "arctic-480b")):
        path = arch
        cfg = dataclasses.replace(get_arch(arch), n_layers=2)
        stack = pool_layout(cfg)[-1]
        hkv, dh = cfg.n_kv_heads, cfg.head_dim()
        row = stack.offset + stack.token_elems
        kpool = torch.randn((n_blocks * chunk, row), generator=g,
                            device=dev).to(torch.bfloat16)
        li = stack.n_layers - 1
        k4_row(rows, g, name, path, kpool, b, hkv, cfg.n_heads // hkv, dh,
               32, chunk, stack.offset + li * hkv * dh,
               stack.offset + (stack.n_layers + li) * hkv * dh)
        del kpool
    launch_ms = median_ms(lambda: wts.add_(0), iters=50)
    # the floor of a one-launch kernel: the library's empty kernel, timed
    # as the rows are (graph replay)
    floor_ms = graph_ms(K.empty_probe)
    for r in rows:
        r["route"] = "cuda"
        r["launch_ms"] = launch_ms
        if r["name"].startswith("row_copy"):
            r["floor_ms"] = floor_ms
        _log_row(r)
    log(f"  (one PyTorch launch of a 1-element add: {launch_ms * 1e3:.2f} us;"
        f" the empty kernel, graph replay: {floor_ms * 1e3:.2f} us)")
    del pool, view


def k4_row(rows, g, name, path, view, b, hkv, grp_q, dh, p_max, chunk,
           k_off, v_off):
    """K4 against its plain version over the pool rows ``view`` at one
    attention shape -- bf16 on its tensor-core variant within 3e-2 and one
    bf16 rounding step, fp32 (and an fp32 q over the bf16 pool, as fp32
    weights serve) on its SIMT variant within 2e-4 -- then its row: device
    time beside gather + SDPA (a yardstick the port never calls) and its
    bound."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_ref
    dev = view.device
    n_rows = view.shape[0]
    page_rows = torch.randint(0, n_rows // chunk, (b, p_max), generator=g,
                              device=dev, dtype=torch.int32)
    lengths = torch.randint(60, 100, (b,), generator=g, device=dev,
                            dtype=torch.int32)
    q = torch.randn((b, hkv, grp_q, dh), generator=g, device=dev)
    ck = torch.randn((b, hkv, dh), generator=g, device=dev)
    cv = torch.randn((b, hkv, dh), generator=g, device=dev)
    errs = {}
    for tag, qd, pd, tol in (
            ("bf16", torch.bfloat16, torch.bfloat16, BF16),
            ("fp32", torch.float32, torch.float32, FP32),
            ("fp32 q / bf16 pool", torch.float32, torch.bfloat16, FP32)):
        pv = view if pd == torch.bfloat16 else view.float()
        args = (q.to(qd), ck.to(pd), cv.to(pd), pv, page_rows, lengths)
        got, variant = variant_of(DK.paged_decode, lambda: DK.paged_decode(
            *args, chunk=chunk, k_off=k_off, v_off=v_off))
        # bf16: the tensor-core variant; an fp32 q: the SIMT variant
        assert variant == ("mma" if qd == torch.bfloat16 else "simt"), \
            f"K4 {name} {tag} took the {variant} variant"
        want = paged_decode_attention_ref(
            args[0].reshape(b, 1, hkv * grp_q, dh),
            args[1].reshape(b, 1, hkv, dh), args[2].reshape(b, 1, hkv, dh),
            pv, page_rows, lengths, chunk=chunk, k_off=k_off, v_off=v_off,
            hkv=hkv).reshape(b, hkv, grp_q, dh)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        if qd == torch.bfloat16:
            # Both sides accumulate in fp32 and round once to bf16, so a
            # dropped position or a wrong tail tile shows as more than one
            # rounding step.
            torch.testing.assert_close(got.float(), want.float(), **BF16_ULP)
        errs[tag] = max_err(got.float(), want.float())
        del pv
    log(f"K4 {name} max |err|: {errs} (bf16: tensor-core variant; "
        f"fp32 q: SIMT)")
    args = (q.to(torch.bfloat16), ck.to(torch.bfloat16),
            cv.to(torch.bfloat16), view, page_rows, lengths)

    def plain():
        return paged_decode_attention_ref(
            args[0].reshape(b, 1, hkv * grp_q, dh),
            args[1].reshape(b, 1, hkv, dh), args[2].reshape(b, 1, hkv, dh),
            view, page_rows, lengths, chunk=chunk, k_off=k_off, v_off=v_off,
            hkv=hkv)

    t_rows = (page_rows.long()[:, :, None] * chunk
              + torch.arange(chunk, device=dev)).reshape(b, p_max * chunk)
    kpos = torch.arange(p_max * chunk, device=dev)
    attn_mask = (kpos[None, :] <= lengths[:, None].long())[:, None, None, :]
    qs = args[0].reshape(b, hkv * grp_q, 1, dh)

    def library():          # gather + SDPA: a yardstick the port never calls
        gathered = view[t_rows]
        kc = gathered[..., k_off:k_off + hkv * dh].reshape(
            b, -1, hkv, dh).transpose(1, 2)
        vc = gathered[..., v_off:v_off + hkv * dh].reshape(
            b, -1, hkv, dh).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            qs, kc, vc, attn_mask=attn_mask, enable_gqa=True)

    # Bytes the function must move: q read and out written, the current
    # token's K and V, the page-table entries of live pages, lengths, and
    # the K and V of each pool position below lengths[b].  Operations: a
    # QK dot and a PV product per (position, query head), the current
    # token's included.
    live = int(lengths.sum())
    pages = int(((lengths + chunk - 1) // chunk).sum())
    nbytes = (q.numel() * 2 * 2 + 2 * ck.numel() * 2 + pages * 4 + b * 4
              + 2 * live * hkv * dh * 2)
    rows.append(dict(
        name=name, wrapper="paged_decode", path=path,
        source="src/repro_torch/kernels/decode_attention/csrc/"
        "paged_decode.cu", replaces="src/repro/kernels/decode_attention/"
        "kernel.py:146", max_abs_err=errs["bf16"],
        shape=f"B={b} P={p_max} Hkv={hkv} G={grp_q} dh={dh} "
        f"k_off={k_off} v_off={v_off} row={view.shape[1]} bf16",
        variant="mma",
        **timings(lambda: DK.paged_decode(*args, chunk=chunk, k_off=k_off,
                                          v_off=v_off), plain, library),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(nbytes, 4 * (live + b) * hkv * grp_q * dh)))))


def _log_row(r):
    log(f"  {r['name']:22s} {r['ms'] * 1e3:9.2f} us  (eager call "
        f"{r['call_ms'] * 1e3:8.2f} us)  plain "
        f"{r['plain_ms'] * 1e3:9.2f} us  bound {r['bound_ms'] * 1e3:8.3f}"
        f" us ({r['bound_by']})  library "
        + (f"{r['library_ms'] * 1e3:9.2f} us" if r["library_ms"]
           is not None else "-") + f"  [{r['shape']}"
        + (f"; {r['variant']} variant" if r.get("variant") else "")
        + (f"; empty-kernel floor {r['floor_ms'] * 1e3:.2f} us]"
           if r.get("floor_ms") else "]"))


def phase2_dense_decode(rows):
    """K5 against its plain version at the wave path's two shapes: one
    layer's view of the stacked 4096-slot caches, kv_len 3000 on the
    device."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention.ref import \
        dense_decode_attention_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    b, t, kv_len, n_layers = 4, 4096, 3000, 2
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    for name, path, hkv, grp, dh in (
            ("dense_decode.tinyllama", "tinyllama-1.1b", 4, 8, 64),
            ("dense_decode.zamba2", "zamba2-2.7b", 32, 1, 80)):
        h = hkv * grp
        q = torch.randn((b, hkv, grp, dh), generator=g, device=dev)
        kc = torch.randn((n_layers, b, t, hkv, dh), generator=g, device=dev)
        vc = torch.randn((n_layers, b, t, hkv, dh), generator=g, device=dev)
        errs = {}
        for tag, dt, tol in (("bf16", torch.bfloat16, BF16),
                             ("fp32", torch.float32, FP32)):
            qd, kd, vd = q.to(dt), kc[1].to(dt), vc[1].to(dt)
            got = DK.dense_decode(qd, kd, vd, kvl)
            want = dense_decode_attention_ref(
                qd.reshape(b, 1, h, dh), kd, vd, kvl).reshape(b, hkv, grp, dh)
            torch.testing.assert_close(got.float(), want.float(), **tol)
            if dt == torch.bfloat16:
                torch.testing.assert_close(got.float(), want.float(),
                                           **BF16_ULP)
            errs[tag] = max_err(got.float(), want.float())
        log(f"K5 {name} max |err|: {errs}")
        kb = kc.to(torch.bfloat16)
        vb = vc.to(torch.bfloat16)
        qb = q.to(torch.bfloat16)
        kl, vl = kb[1], vb[1]
        qs = qb.reshape(b, h, 1, dh)
        k_live = kl[:, :kv_len].transpose(1, 2)      # (B, Hkv, kv_len, Dh)
        v_live = vl[:, :kv_len].transpose(1, 2)

        def library(qs=qs, k_live=k_live, v_live=v_live):
            return torch.nn.functional.scaled_dot_product_attention(
                qs, k_live, v_live, enable_gqa=True)

        def kernel(qb=qb, kl=kl, vl=vl):
            return DK.dense_decode(qb, kl, vl, kvl)

        def plain(qb=qb, kl=kl, vl=vl, h=h, dh=dh):
            return dense_decode_attention_ref(qb.reshape(b, 1, h, dh), kl,
                                              vl, kvl)

        torch.testing.assert_close(
            library().reshape(b, hkv, grp, dh).float(), kernel().float(),
            **BF16)
        # bytes: each live K and V element once, q read and out written
        # (bf16), kv_len; operations: a QK dot and a PV product per (live
        # position, query head)
        nbytes = (b * kv_len * hkv * dh * 2 + 2 * b * h * dh) * 2 + 4
        rows.append(dict(
            name=name, wrapper="dense_decode", path=path, route="cuda",
            launch_ms=rows[0]["launch_ms"],
            source="src/repro_torch/kernels/decode_attention/"
            "csrc/dense_decode.cu", replaces="src/repro/kernels/"
            "decode_attention/kernel.py:66", max_abs_err=errs["bf16"],
            shape=f"B={b} T={t} kv_len={kv_len} Hkv={hkv} G={grp} dh={dh} "
            f"bf16", **timings(kernel, plain, library),
            **dict(zip(("bound_ms", "bound_by"),
                       bound(nbytes, 4 * b * h * kv_len * dh)))))
        _log_row(rows[-1])
        del q, kc, vc, kb, vb, k_live, v_live
    torch.cuda.empty_cache()


def phase2_prefill_kernels(rows):
    """K6-K8 against their plain versions at the prefill step's full-width
    shapes: K6 at both wave paths' prompts (4 x 3072 tokens) and the paged
    paths' prefills (a cold prompt padded to 80 tokens; the suffix, 16
    queries at q_offset 64 in an 80-slot cache);
    K7 at zamba2's scan (b 4, 12 chunks of 256, 80 heads, state 64, head
    dim 64), over the conv output's column views as the model passes them;
    K8 at the prefill rows of tinyllama's norms and zamba2's gated norm and
    at one decode step's rows.  The plain versions of K6 run one request
    at a time (one request's fp32 scores alone are 1.2 GB)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    launch_ms = rows[0]["launch_ms"]
    f32, b16 = torch.float32, torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def add(row):
        row.update(route="cuda", launch_ms=launch_ms)
        rows.append(row)
        _log_row(row)

    # --- K6 flash_prefill --------------------------------------------------
    for (name, path, b, sq, skv, h, hkv, dh, q_off, kv_len, checks) in (
            ("flash_prefill.tinyllama", "tinyllama-1.1b", 4, 3072, 3072, 32,
             4, 64, 0, 3072, (("bf16", b16, BF16),)),
            ("flash_prefill.zamba2", "zamba2-2.7b", 4, 3072, 3072, 32, 32,
             80, 0, 3072, (("bf16", b16, BF16), ("fp32", f32, FP32))),
            ("flash_prefill.paged_suffix", "paged", 1, 16, 80, 32, 4, 64,
             64, 80, (("bf16", b16, BF16), ("fp32", f32, FP32))),
            # kimi-k2's attention (64 / 8 heads, Dh 112): the paged
            # suffix and a cold prompt (its 68-80 tokens padded to 80)
            ("flash_prefill.kimi_suffix", "kimi-k2-1t-a32b", 1, 16, 80, 64,
             8, 112, 64, 80, (("bf16", b16, BF16), ("fp32", f32, FP32))),
            ("flash_prefill.kimi_cold", "kimi-k2-1t-a32b", 1, 80, 80, 64, 8,
             112, 0, 80, (("bf16", b16, BF16), ("fp32", f32, FP32))),
            # the decoder configurations' attention (Dh 128; glm4 32 / 2
            # heads, mistral-nemo 32 / 8, qwen2-vl 64 / 8, llama3 128 / 8,
            # arctic 56 / 8) at what their paged paths give K6, as kimi's
            # rows: the suffix and the cold prompt ...
            *((f"flash_prefill.{DECODER_ROWS[arch]}_{part}", arch, 1, sq,
               skv, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim(), q_off, skv,
               (("bf16", b16, BF16), ("fp32", f32, FP32)))
              for arch, cfg in ((a, get_arch(a)) for a, _d in DECODERS)
              for part, sq, skv, q_off in (("suffix", 16, 80, 64),
                                           ("cold", 80, 80, 0))),
            # ... and, timing rows only, at a long prompt (B 4, S 3072): no
            # path runs these configurations there, so their launches
            # read 0 (path "none")
            *((f"flash_prefill.{DECODER_ROWS[arch]}_s3072", "none", 4, 3072,
               3072, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim(), 0, 3072,
               (("bf16", b16, BF16),))
              for arch, cfg in ((a, get_arch(a)) for a, _d in DECODERS
                                if a != "arctic-480b"))):
        q32, k32, v32 = randn(b, sq, h, dh), randn(b, skv, hkv, dh), \
            randn(b, skv, hkv, dh)
        kw = dict(causal=True, q_offset=q_off, kv_len=kv_len)

        def plain(q, k, v, kw=kw, b=b):
            return torch.cat([flash_attention_ref(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], **kw) for i in range(b)])

        errs = {}
        for tag, dt, tol in checks:
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            got, variant = variant_of(FK.flash_prefill, lambda: (
                FK.flash_prefill(q, k, v, **kw)))
            assert variant == ("wgmma" if dt == b16 else "tf32x3"), \
                f"K6 {name} {tag} took the {variant} variant"
            want = plain(q, k, v)
            torch.testing.assert_close(got.float(), want.float(), **tol)
            if dt == b16:
                # P is rounded to bf16 for P.V: each weight within 2^-9 of
                # itself moves the output by at most 2^-9 max|v|, then
                # both sides round once to bf16
                torch.testing.assert_close(
                    got.float(), want.float(), rtol=2 ** -7,
                    atol=2 ** -9 * float(v.abs().max()) + 1e-5)
            errs[tag] = max_err(got.float(), want.float())
            del got, want
        log(f"K6 {name} max |err|: {errs}")
        live = torch.clamp(torch.minimum(
            q_off + torch.arange(sq, device=dev) + 1,
            torch.tensor(kv_len, device=dev)), min=0)
        nops = 4 * b * h * dh * int(live.sum())
        if any(tag == "fp32" for tag, _dt, _tol in checks) and sq > 16:
            # the fp32 pair runs the tf32x3 variant: its time and bounds
            q, k, v = q32, k32, v32
            ms = graph_ms(lambda: FK.flash_prefill(q, k, v, **kw), 5)
            log(f"  {name} fp32 (tf32x3): {ms * 1e3:.2f} us, bounds: three "
                f"TF32 products {bound(0, 3 * nops, TF32_TC_FLOPS)[0] * 1e3:.3f}"
                f" us, fp32 SIMT {bound(0, nops)[0] * 1e3:.3f} us")
        q, k, v = q32.to(b16), k32.to(b16), v32.to(b16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        qpos = q_off + torch.arange(sq, device=dev)
        kpos = torch.arange(skv, device=dev)
        mask = (kpos[None] <= qpos[:, None]) & (kpos[None] < kv_len)

        def library(qt=qt, kt=kt, vt=vt, mask=mask, aligned=q_off == 0
                    and kv_len == skv):
            if aligned:
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

        torch.testing.assert_close(library().transpose(1, 2).float(),
                                   FK.flash_prefill(q, k, v, **kw).float(),
                                   **BF16)
        # bytes: q read and the output written once, the K/V rows below the
        # last query's causal limit once; operations: a QK dot and a PV
        # product per (query, live key, head) at the bf16 tensor-core peak
        kv_rows = min(kv_len, q_off + sq)
        nbytes = 2 * (2 * b * sq * h * dh + 2 * b * kv_rows * hkv * dh)
        big = sq * skv > 1 << 20
        add(dict(
            name=name, wrapper="flash_prefill", path=path,
            source="src/repro_torch/kernels/flash_attention/csrc/"
            "flash_prefill.cu", replaces="src/repro/kernels/flash_attention/"
            "kernel.py:64", max_abs_err=errs["bf16"],
            shape=f"B={b} Sq={sq} Skv={skv} q_offset={q_off} kv_len={kv_len} "
            f"H={h} Hkv={hkv} dh={dh} bf16", variant="wgmma",
            **timings(lambda q=q, k=k, v=v, kw=kw: FK.flash_prefill(
                q, k, v, **kw), lambda q=q, k=k, v=v: plain(q, k, v),
                library, iters=5 if big else 20,
                plain_iters=2 if big else 20),
            **dict(zip(("bound_ms", "bound_by"),
                       bound(nbytes, nops, BF16_TC_FLOPS)))))
        del q32, k32, v32, q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    # --- K7 ssd_chunk: zamba2's scan over the conv output's views -----------
    b, s, h, p, n, chunk = 4, 3072, 80, 64, 64, 256
    nc = s // chunk
    conv32 = randn(b, s, h * p + 2 * n)
    dt = F.softplus(randn(b, s, h))
    A = -torch.exp(0.5 * randn(h))
    cum = torch.cumsum((dt * A).reshape(b, nc, chunk, h), dim=2)
    tri = chunk * (chunk + 1) // 2              # (i, j) pairs with j <= i
    # fp32 operations: C.B once per chunk (heads share it), the decayed
    # M.xdt and the chunk states per head, the x * dt and decay products
    nops = (2 * b * nc * tri * n + 2 * b * nc * h * tri * p
            + b * nc * h * tri + 2 * b * nc * h * chunk * n * p
            + 2 * b * nc * h * chunk * p)
    errs = {}
    for tag, dtype, want_variant in (("bf16", b16, "mma"),
                                     ("fp32", f32, "tf32x3")):
        conv = conv32.to(dtype)
        xs = conv[..., :h * p].reshape(b, s, h, p)
        bs, cs = conv[..., h * p:h * p + n], conv[..., h * p + n:]
        (y, st), variant = variant_of(SK.ssd_chunk, lambda: SK.ssd_chunk(
            xs, dt, cum, bs, cs, chunk=chunk))
        assert variant == want_variant, f"K7 {tag} took the {variant} variant"
        wy, wst = ssd_chunk_ref(xs, dt, cum, bs, cs, chunk=chunk)
        torch.testing.assert_close(y, wy, **FP32)
        torch.testing.assert_close(st, wst, **FP32)
        errs[tag] = max(max_err(y, wy), max_err(st, wst))
        del y, st, wy, wst
        if dtype == f32:
            # the fp32 pair runs the tf32x3 variant: its time and bound
            # (its products as three TF32 products)
            ms = graph_ms(lambda: SK.ssd_chunk(xs, dt, cum, bs, cs,
                                               chunk=chunk), 5)
            log(f"  ssd_chunk fp32 (tf32x3 variant): {ms * 1e3:.2f} us, "
                f"bound {bound(0, 3 * nops, TF32_TC_FLOPS)[0] * 1e3:.3f} us "
                f"(operations as three TF32 products at 495 TFLOP/s)")
        del conv, xs, bs, cs
    log(f"K7 ssd_chunk max |err|: {errs} (bf16: the mma variant; fp32: "
        f"tf32x3)")
    conv = conv32.to(b16)
    xs = conv[..., :h * p].reshape(b, s, h, p)
    bs, cs = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    # bytes: x, B, C (bf16), dt and cum read once, y_intra and S written
    # once; operations of the tensor-core variant at the bf16 peak: C.B
    # once per chunk, the decayed M'.x and the chunk states per head, each
    # of these two in three bf16 parts
    nbytes = (2 * (b * s * h * p + 2 * b * s * n) + 4 * (b * s * h
              + b * nc * chunk * h) + 4 * (b * nc * chunk * h * p
                                           + b * nc * h * p * n))
    tc_ops = (2 * b * nc * tri * n + 3 * 2 * b * nc * h * tri * p
              + 3 * 2 * b * nc * h * chunk * n * p)
    add(dict(
        name="ssd_chunk", wrapper="ssd_chunk", path="zamba2-2.7b",
        source="src/repro_torch/kernels/ssd_scan/csrc/ssd_chunk.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:42",
        max_abs_err=errs["bf16"],
        shape=f"b={b} nc={nc} Q={chunk} heads={h} N={n} P={p} x/B/C bf16",
        variant="mma",
        **timings(lambda: SK.ssd_chunk(xs, dt, cum, bs, cs, chunk=chunk),
                  lambda: ssd_chunk_ref(xs, dt, cum, bs, cs, chunk=chunk),
                  iters=5, plain_iters=2),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(nbytes, tc_ops, BF16_TC_FLOPS)))))
    del conv32, conv, xs, bs, cs, dt, cum
    torch.cuda.empty_cache()

    # --- K8 rmsnorm: the plain norm, the add and gate prologues -------------
    for name, path, variant, r, d in K8_ROWS:
        k8_row(add, randn, name, path, variant, r, d)
    torch.cuda.empty_cache()


# K8's rows: (name, path, variant, rows, D) -- tinyllama's prefill norms
# (4 x 3072 rows of 2048), zamba2's gated norm (5120) and its add norms
# (2560), a paged decode step's 8 rows and a zamba2 decode step's 4
K8_ROWS = (("rmsnorm.tinyllama", "tinyllama-1.1b", "plain", 4 * 3072, 2048),
           ("rmsnorm.tinyllama_add", "tinyllama-1.1b", "add", 4 * 3072,
            2048),
           ("rmsnorm.zamba2_gated", "zamba2-2.7b", "gate", 4 * 3072, 5120),
           ("rmsnorm.zamba2_add", "zamba2-2.7b", "add", 4 * 3072, 2560),
           ("rmsnorm.decode", "paged", "plain", 8, 2048),
           ("rmsnorm.decode_add", "paged", "add", 8, 2048),
           ("rmsnorm.zamba2_decode_gated", "zamba2-2.7b", "gate", 4, 5120))


def k8_row(add, randn, name, path, variant, r, d):
    """One K8 variant against its plain version at every (row, w) dtype mix
    (bf16 within one bf16 rounding step, fp32 within 2e-4; the add's h
    equal to the eager add bit for bit; the gate's z a column slice of a
    wider projection row, as the model passes it), then its row: device
    time, bound, and beside it the time of the eager chain it replaces
    (``unfused_ms``: the add then the plain norm; the five passes that
    built the gated norm's input, then the plain norm), all in bf16."""
    import torch
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.rmsnorm import ref as RR
    F = torch.nn.functional
    f32, b16 = torch.float32, torch.bfloat16
    x32, r32, w32 = randn(r, d), randn(r, d), 1 + 0.1 * randn(d)
    proj32 = randn(r, 2 * d + 208)          # [x, z, B, C, dt] as in_proj
    errs = {}

    def args(xd, wd):
        w = w32.to(wd)
        if variant == "gate":
            z = proj32.to(xd)[:, d:2 * d]
            return ((x32, w), dict(gate=z),
                    lambda: RR.gated_rmsnorm_ref(x32, z, w))
        x = x32.to(xd)
        if variant == "add":
            rr = r32.to(xd)
            return ((x, w), dict(residual=rr),
                    lambda: RR.add_rmsnorm_ref(x, rr, w))
        return (x, w), {}, lambda: RR.rmsnorm_ref(x, w)

    for xd in (b16, f32):
        for wd in (b16, f32):
            a, kw, plain = args(xd, wd)
            got, want = RK.rmsnorm_2d(*a, **kw), plain()
            if variant == "add":
                assert torch.equal(got[0], a[0] + kw["residual"]), \
                    f"K8 add: h differs from the eager add ({xd}/{wd})"
                assert torch.equal(got[0], want[0])
                got, want = got[1], want[1]
            torch.testing.assert_close(
                got.float(), want.float(), **(BF16_ULP if xd == b16 else FP32))
            errs[f"{str(xd)[6:]}/{str(wd)[6:]}"] = max_err(got.float(),
                                                          want.float())
    log(f"K8 {name} ({variant}) max |err|: {errs}")
    a, kw, plain = args(b16, b16)
    x, w = a
    if variant == "plain":
        library = (lambda: F.rms_norm(x, (d,), w, 1e-5))
        unfused = None
        nbytes, nops = 2 * (2 * r * d + d), 4 * r * d
    elif variant == "add":
        rr = kw["residual"]
        library = None
        unfused = (lambda: RK.rmsnorm_2d(x + rr, w))
        nbytes, nops = 2 * (4 * r * d + d), 5 * r * d
    else:
        z = kw["gate"]
        library = None
        unfused = (lambda: RK.rmsnorm_2d(
            x.to(b16) * F.silu(z.float()).to(b16), w))
        # silu: an exponential, an add and a divide; the three roundings,
        # the product, then the norm's four
        nbytes, nops = 8 * r * d + 2 * d, 12 * r * d
    big = r * d > 1 << 20
    row = dict(
        name=name, wrapper="rmsnorm", path=path, variant=variant,
        source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm/kernel.py:24",
        max_abs_err=errs["bfloat16/bfloat16"],
        shape=f"rows={r} D={d} " + ("y fp32, z/w bf16 (z a column view)"
                                     if variant == "gate" else "x/w bf16"),
        **timings(lambda: RK.rmsnorm_2d(*a, **kw), plain, library,
                  plain_iters=5 if big else 20),
        unfused_ms=None if unfused is None else graph_ms(unfused),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes, nops))))
    add(row)
    if unfused is not None:
        log(f"  {name}: the eager chain it replaces "
            f"{row['unfused_ms'] * 1e3:.2f} us (graph replay)")


# K10 (flash-attention backward) at the training path's attention -- B 4,
# S 1024, 32 / 4 heads, Dh 64 -- and at the paged suffix's q_offset /
# kv_len; K11 (RMSNorm backward) at the training path's rows (4 x 1024
# tokens of 2048)
K10_ROWS = (("flash_backward.train", "train", 4, 1024, 1024, 32, 4, 64, 0,
             1024),
            ("flash_backward.paged_suffix", "paged", 1, 16, 80, 32, 4, 64,
             64, 80))
K11_ROWS = (("rmsnorm_backward.train", "train", "plain", 4096, 2048),
            ("rmsnorm_backward.train_add", "train", "add", 4096, 2048))


def k10_schedule(b, sq, skv, h, hkv, dh, q_off, kv_len, causal=True):
    """K10's CTAs and their work in tiles, from ``flash_backward.cu``'s
    loop bounds: the dq kernel's CTAs (64 query rows, head, batch) walk
    the KV tiles they see, the dk/dv kernel's (64 keys, query head, batch)
    the query tiles that see them (tiles of 64 for Dh <= 64, else 32)."""
    bt = 64 if dh <= 64 else 32

    def kv_end(qb):
        last = q_off + min(sq, (qb + 1) * 64) - 1
        end = min(kv_len, last + 1) if causal else kv_len
        return max(0, min(end, skv))

    dq = [-(-kv_end(qb) // bt) for qb in range(-(-sq // 64))]
    nqt = -(-sq // bt)
    dkv = [0 if kb * 64 >= kv_len else
           nqt - (max(0, kb * 64 - q_off) // bt if causal else 0)
           for kb in range(-(-skv // 64))]
    return dict(dq_ctas=len(dq) * h * b, dq_max=max(dq),
                dq_mean=sum(dq) / len(dq), dkv_ctas=len(dkv) * h * b,
                dkv_max=max(dkv), dkv_mean=sum(dkv) / len(dkv))


def kernel_times(fn, reps=5):
    """{kernel: device us a call} of the device kernels ``fn`` runs, read
    by ``torch.profiler`` over ``reps`` calls (K10's by their short
    names: delta, dq, dkv, dkv_sum)."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"flash_bwd_(\w+?)<", e.key)
        name = m.group(1) if m else e.key[:40]
        out[name] = out.get(name, 0.0) + e.self_device_time_total / reps
    return out


def k11_kernel_times(fn, reps=20):
    """{"rows": ms, "dw": ms}: the device time a call of K11's two
    kernels, read by ``torch.profiler`` over ``reps`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"rows": 0.0, "dw": 0.0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for k in out:
                if f"rmsnorm_bwd_{k}" in e.key:
                    out[k] += e.self_device_time_total / reps / 1e3
    assert all(out.values()), f"K11's kernels not traced: {out}"
    return out


def phase2_backward_kernels(rows):
    """K10 and K11 against their plain versions on the card: each shape in
    fp32 (2e-4) and bf16 (3e-2), two calls bit-identical, K10 reading the
    LSE that K6 wrote (held to the plain LSE within 2e-4); then each row's
    device time (graph replay), eager call, plain version (eager), bound
    and library yardstick (eager ``torch.autograd.grad`` through SDPA,
    ``is_causal`` / mask and ``enable_gqa``, for K10; through
    ``F.rms_norm`` for K11), in the training path's dtype, fp32.  K10's
    row also prints its kernels' times, its variant, its schedule and its
    two bounds (fp32 SIMT at 67 TFLOP/s; three TF32 products at 495); K6
    gets a row at the training shape in fp32 (with and without its LSE
    write) beside SDPA's fp32 forward."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_backward_ref, flash_attention_lse_ref,
        flash_attention_ref)
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_ref
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    launch_ms = rows[0]["launch_ms"]
    f32, b16 = torch.float32, torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def add(row):
        row.update(route="cuda", launch_ms=launch_ms)
        rows.append(row)
        _log_row(row)

    def held(name, got, again, want, tol):
        """Each output within ``tol`` of the plain version (dw relative to
        its largest value: a sum over rows) and bit-identical to the
        second call; returns the max |err|."""
        for a, a2, w in zip(got, again, want):
            assert torch.equal(a, a2), f"{name}: two calls differ"
            atol = tol["atol"] * (float(w.float().abs().max())
                                  if w.dim() == 1 else 1.0)
            torch.testing.assert_close(a.float(), w.float(),
                                       rtol=tol["rtol"], atol=atol)
        return max(max_err(a.float(), w.float()) for a, w in zip(got, want))

    # --- K10 flash_backward ------------------------------------------------
    for (name, path, b, sq, skv, h, hkv, dh, q_off, kv_len) in K10_ROWS:
        kw = dict(causal=True, q_offset=q_off, kv_len=kv_len)
        q32, k32, v32 = randn(b, sq, h, dh), randn(b, skv, hkv, dh), \
            randn(b, skv, hkv, dh)
        do32 = randn(b, sq, h, dh)
        live = torch.clamp(torch.minimum(
            q_off + torch.arange(sq, device=dev) + 1,
            torch.tensor(kv_len, device=dev)), min=0)
        # operations: five Dh-long dot products per (query, live key, head)
        # -- s, dP, dv, dq, dk -- at fp32's 67 TFLOP/s, or as three TF32
        # products each at the TF32 tensor cores' 495 (bf16: once at 989);
        # bytes: q, k, v, o, dO, the LSE read and dq, dk, dv written once
        nops = 10 * b * h * dh * int(live.sum())
        kv_rows = min(kv_len, q_off + sq)
        errs, lse_errs, times = {}, {}, {}
        for tag, dt, tol in (("fp32", f32, FP32), ("bf16", b16, BF16)):
            q, k, v, do = (t.to(dt) for t in (q32, k32, v32, do32))
            o, lse = FK.flash_prefill(q, k, v, return_lse=True, **kw)
            lse_want = flash_attention_lse_ref(q, k, **kw)
            torch.testing.assert_close(lse, lse_want, **FP32)
            lse_errs[tag] = max_err(lse, lse_want)
            got, variant = variant_of(FK.flash_backward, lambda: (
                FK.flash_backward(q, k, v, o, do, lse=lse, **kw)))
            assert variant == ("tf32x3" if dt == f32 else "bf16"), variant
            again = FK.flash_backward(q, k, v, o, do, lse=lse, **kw)
            want = flash_attention_backward_ref(q, k, v, o, do, **kw)
            errs[tag] = held(f"K10 {name} {tag}", got, again, want, tol)
            del got, again, want
            times[tag] = (variant, graph_ms(
                lambda: FK.flash_backward(q, k, v, o, do, lse=lse, **kw),
                5), kernel_times(
                lambda: FK.flash_backward(q, k, v, o, do, lse=lse, **kw)))
        log(f"K10 {name} max |err| (dq, dk, dv): {errs}; two calls "
            f"bit-identical; K6's LSE max |err| against the plain LSE: "
            f"{lse_errs}")
        sched = k10_schedule(b, sq, skv, h, hkv, dh, q_off, kv_len)
        log(f"  {name} schedule (tiles a CTA): dq {sched['dq_ctas']} CTAs, "
            f"max {sched['dq_max']}, mean {sched['dq_mean']:.2f}; dk/dv "
            f"{sched['dkv_ctas']} CTAs, max {sched['dkv_max']}, mean "
            f"{sched['dkv_mean']:.2f}")
        simt_b = bound(0, nops)[0]
        split_b = bound(0, 3 * nops, TF32_TC_FLOPS)[0]
        for tag, (variant, ms, parts) in times.items():
            log(f"  {name} {tag}: {variant} variant, {ms * 1e3:.2f} us "
                f"(graph replay); kernels (us a call, profiler): "
                + json.dumps({k: round(x, 2) for k, x in parts.items()})
                + (f"; bounds: fp32 SIMT {simt_b * 1e3:.3f} us, three TF32 "
                   f"products {split_b * 1e3:.3f} us" if tag == "fp32" else
                   f"; bound: bf16 products "
                   f"{bound(0, nops, BF16_TC_FLOPS)[0] * 1e3:.3f} us"))
        q, k, v, do = q32, k32, v32, do32
        o, lse = FK.flash_prefill(q, k, v, return_lse=True, **kw)
        nbytes = 4 * (3 * b * sq * h * dh + 2 * b * kv_rows * hkv * dh
                      + b * sq * h + b * sq * h * dh + 2 * b * skv * hkv * dh)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        qpos = q_off + torch.arange(sq, device=dev)
        kpos = torch.arange(skv, device=dev)
        mask = (kpos[None] <= qpos[:, None]) & (kpos[None] < kv_len)
        aligned = q_off == 0 and kv_len == skv
        out = (F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True) if aligned
               else F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=mask,
                                                   enable_gqa=True))
        dot = do.transpose(1, 2)
        lib = torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        got = FK.flash_backward(q, k, v, o, do, lse=lse, **kw)
        for a, w in zip(got, lib):
            torch.testing.assert_close(a, w.transpose(1, 2), **FP32)
        big = sq * skv > 1 << 16

        def library(out=out, qt=qt, kt=kt, vt=vt, dot=dot):
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        t = timings(lambda q=q, k=k, v=v, o=o, do=do, lse=lse, kw=kw:
                    FK.flash_backward(q, k, v, o, do, lse=lse, **kw),
                    lambda q=q, k=k, v=v, o=o, do=do, kw=kw:
                    flash_attention_backward_ref(q, k, v, o, do, **kw),
                    iters=5 if big else 20, plain_iters=2 if big else 20)
        t["library_ms"] = median_ms(library, 5 if big else 20,
                                    3 if big else 7)
        log(f"  {name}: SDPA's eager backward {t['library_ms'] * 1e3:.2f} "
            f"us, K10 {t['ms'] / t['library_ms']:.3f}x of it")
        add(dict(
            name=name, wrapper="flash_backward", path=path,
            variant="tf32x3", source="src/repro_torch/kernels/"
            "flash_attention/csrc/flash_backward.cu", replaces="src/repro/"
            "kernels/flash_attention/kernel.py:64", max_abs_err=errs["fp32"],
            shape=f"B={b} Sq={sq} Skv={skv} q_offset={q_off} "
            f"kv_len={kv_len} H={h} Hkv={hkv} dh={dh} fp32 (library: eager "
            f"autograd; bound: three TF32 products, fp32 SIMT "
            f"{simt_b * 1e3:.3f} us)", **t,
            **dict(zip(("bound_ms", "bound_by"),
                       bound(nbytes, 3 * nops, TF32_TC_FLOPS)))))
        del q32, k32, v32, do32, q, k, v, do, o, qt, kt, vt, out, lib, got
        torch.cuda.empty_cache()

    # --- K6 at the training shape, fp32, with its LSE write ----------------
    b, s, h, hkv, dh = 4, 1024, 32, 4, 64
    q, k, v = randn(b, s, h, dh), randn(b, s, hkv, dh), randn(b, s, hkv, dh)
    (out, lse), variant = variant_of(FK.flash_prefill, lambda: (
        FK.flash_prefill(q, k, v, return_lse=True)))
    assert variant == "tf32x3", f"K6 at the training shape: {variant}"
    want = flash_attention_ref(q, k, v)
    lse_want = flash_attention_lse_ref(q, k)
    torch.testing.assert_close(out, want, **FP32)
    torch.testing.assert_close(lse, lse_want, **FP32)
    assert torch.equal(out, FK.flash_prefill(q, k, v))
    err = max_err(out, want)
    del out, want
    no_lse_ms = graph_ms(lambda: FK.flash_prefill(q, k, v), 5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    # operations: a QK dot and a PV product per (query, live key, head) as
    # three TF32 products each at the TF32 tensor cores' 495 TFLOP/s (the
    # tf32x3 variant's arithmetic; fp32's 67 beside it); bytes: q, k, v
    # read, the output and LSE written
    nops = 4 * b * h * dh * (s * (s + 1) // 2)
    nbytes = 4 * (2 * b * s * h * dh + 2 * b * s * hkv * dh + b * h * s)
    simt_b = bound(nbytes, nops)[0]
    row = dict(
        name="flash_prefill.train", wrapper="flash_prefill", path="train",
        source="src/repro_torch/kernels/flash_attention/csrc/"
        "flash_prefill.cu", replaces="src/repro/kernels/flash_attention/"
        "kernel.py:64", max_abs_err=err, variant="tf32x3",
        shape=f"B={b} S={s} H={h} Hkv={hkv} dh={dh} fp32, LSE written "
        f"(without: {no_lse_ms * 1e3:.2f} us; library: SDPA fp32 "
        f"forward; bound: three TF32 products, fp32 SIMT "
        f"{simt_b * 1e3:.3f} us)", **timings(
            lambda: FK.flash_prefill(q, k, v, return_lse=True),
            lambda: (flash_attention_ref(q, k, v),
                     flash_attention_lse_ref(q, k)),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            iters=5, plain_iters=5),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(nbytes, 3 * nops, TF32_TC_FLOPS))))
    add(row)
    log(f"  flash_prefill.train fp32: {row['ms'] * 1e3:.2f} us with the "
        f"LSE write, {no_lse_ms * 1e3:.2f} us without; SDPA fp32 forward "
        f"{row['library_ms'] * 1e3:.2f} us; bounds: fp32 SIMT "
        f"{simt_b * 1e3:.3f} us, three TF32 products "
        f"{row['bound_ms'] * 1e3:.3f} us")
    del q, k, v, qt, kt, vt, lse, lse_want
    torch.cuda.empty_cache()

    # --- K11 rmsnorm_backward ----------------------------------------------
    for name, path, variant, r, d in K11_ROWS:
        x32, dy32, dh32 = randn(r, d), randn(r, d), randn(r, d)
        w = 1 + 0.1 * randn(d)
        errs = {}
        for tag, dt, tol in (("fp32", f32, FP32), ("bf16", b16, BF16)):
            x, dy = x32.to(dt), dy32.to(dt)
            dh = dh32.to(dt) if variant == "add" else None
            got = RK.rmsnorm_backward(x, w, dy, dh=dh)
            again = RK.rmsnorm_backward(x, w, dy, dh=dh)
            errs[tag] = held(f"K11 {name} {tag}", got, again,
                             rmsnorm_backward_ref(x, w, dy, dh=dh), tol)
        log(f"K11 {name} ({variant}) max |err| (dx, dw): {errs}; two calls "
            f"bit-identical")
        x, dy = x32, dy32
        dh = dh32 if variant == "add" else None
        xl = x.detach().requires_grad_()
        wl = w.detach().requires_grad_()
        yl = F.rms_norm(xl, (d,), wl, 1e-5)

        def library(yl=yl, xl=xl, wl=wl, dy=dy):
            return torch.autograd.grad(yl, (xl, wl), dy, retain_graph=True)

        # fresh leaves each call, so autograd's nodes for them are made on
        # the stream that runs (and, in a capture, records) the call
        def lib_fwd(x=x, w=w):
            return F.rms_norm(x.detach().requires_grad_(), (d,),
                              w.detach().requires_grad_(), 1e-5)

        def lib_fwd_bwd(x=x, w=w, dy=dy):
            xi, wi = x.detach().requires_grad_(), w.detach().requires_grad_()
            return torch.autograd.grad(F.rms_norm(xi, (d,), wi, 1e-5),
                                       (xi, wi), dy)

        # bytes: x (or h), dy (and dh) and w read, dx and dw written, fp32;
        # about 10 operations an element
        nbytes = 4 * ((3 if dh is None else 4) * r * d + 2 * d)

        def kernel(x=x, dy=dy, dh=dh):
            return RK.rmsnorm_backward(x, w, dy, dh=dh)
        t = timings(kernel, lambda x=x, dy=dy, dh=dh: rmsnorm_backward_ref(
            x, w, dy, dh=dh))
        # the library's backward by graph replay: forward + backward less
        # the forward; the eager figure of PRs 20-21 beside it
        eager_ms = median_ms(library)
        t["library_ms"] = graph_ms(lib_fwd_bwd) - graph_ms(lib_fwd)
        split = k11_kernel_times(kernel)
        add(dict(
            name=name, wrapper="rmsnorm_backward", path=path,
            variant=variant, source="src/repro_torch/kernels/rmsnorm/csrc/"
            "rmsnorm_backward.cu", replaces="src/repro/kernels/rmsnorm/"
            "kernel.py:24", max_abs_err=errs["fp32"],
            shape=f"rows={r} D={d} fp32; kernels (torch.profiler): rows "
            f"{split['rows'] * 1e3:.2f} us, dw sum {split['dw'] * 1e3:.2f} "
            f"us; library: F.rms_norm's backward by graph replay (forward + "
            f"backward less forward), eager autograd {eager_ms * 1e3:.2f} "
            f"us", **t,
            **dict(zip(("bound_ms", "bound_by"),
                       bound(nbytes, 10 * r * d)))))
    torch.cuda.empty_cache()


def _requests(Request, np, vocab, n=8, seed=SEED):
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, 64).astype(np.int32)
    return [Request(i, np.concatenate(
        [system, rng.integers(1, vocab, int(rng.integers(4, 17)))
         .astype(np.int32)]), max_new=16) for i in range(n)]


def _serve(cfg, params, dev, n_prefix_blocks, n_decode_pages, trace=False,
           seed=SEED):
    """One ``ServingCluster.run`` over the smoke's requests.  Returns
    (cluster, done, report, seconds); on the card the time ends in a
    device synchronise."""
    import numpy as np
    import torch
    from repro_torch.runtime import Request, ServingCluster
    cluster = ServingCluster(cfg, lambda: params, n_replicas=2,
                             prefix_block_tokens=16,
                             n_prefix_blocks=n_prefix_blocks,
                             n_decode_pages=n_decode_pages, max_pages=32,
                             device=dev)
    if trace:
        cluster.trace = []
    reqs = _requests(Request, np, cfg.vocab, seed=seed)
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, report = cluster.run(reqs)
    if dev == "cuda":
        torch.cuda.synchronize()
    return cluster, done, report, time.perf_counter() - t0


def profile_main_path(cfg, params, smi, top=12):
    """The main path again (warm), timed plain and then under
    ``torch.profiler``."""
    profile_path("main path", lambda: _serve(cfg, params, "cuda", 4096,
                                              512), smi, top)


def profile_path(label, serve, smi, top=12, with_host=True):
    """A path again (warm) under ``torch.profiler``: device busy and idle
    share over the run, device time by kernel and by kind.  With
    ``with_host`` the warm run is also timed without the profiler first,
    and host operators are traced too (host time by operator); without
    it only the card's activity is traced, which keeps the trace and its
    processing small.  ``serve()`` returns (cluster, done, report,
    seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if with_host:
        activities.append(ProfilerActivity.CPU)
        _c, done, _r, dt = serve()
        n_tok = sum(len(r.output) for r in done)
        log(f"profile: warm {label} on {smi}: {n_tok} tokens in {dt:.3f} s "
            f"= {n_tok / dt:.1f} tokens/s (no profiler)")
    with profile(activities=activities) as prof:
        _c, done, _r, wall = serve()
    n_tok = sum(len(r.output) for r in done)
    dev_rows = profile_rows(prof, DeviceType.CUDA)
    host_rows = ([e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU] if with_host
                 else profile_rows(prof, DeviceType.CPU))
    busy = sum(e.self_device_time_total for e in dev_rows) / 1e6   # us->s
    n_launch = sum(e.count for e in host_rows
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                "cuLaunchKernel"))
    launches = (f"{n_launch} kernel launches" if n_launch else
                "kernel launches not traced")
    log(f"profile: {label}: wall {wall:.3f} s under the profiler, device busy "
        f"{busy:.3f} s, idle share {1 - busy / wall:.3f}; {launches} for "
        f"{n_tok} tokens")
    if not dev_rows:
        log("profile: the profiler showed no device time")
        return
    kinds = {}
    ours = ("lease_pass", "write_advance", "gather_kernel",
            "scatter_kernel", "paged_decode", "dense_decode",
            "flash_prefill", "ssd_chunk", "rmsnorm_rows")
    for e in dev_rows:
        kind = ("port kernels" if any(k in e.key for k in ours) else
                "matmul" if any(k in e.key.lower() for k in
                                ("gemm", "xmma", "nvjet", "cutlass"))
                else "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    log(f"profile: {label}: device ms by kind: "
        + json.dumps({k: round(v, 3) for k, v in kinds.items()}))
    for e in sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  device {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    for e in sorted(host_rows, key=lambda e: -e.self_cpu_time_total)[:top]:
        log(f"  host   {e.self_cpu_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")


def norms_per_step(cfg):
    """K8's launches by variant in one decode step of the port's layer
    loops: a dense model's first attention norm plain, every later norm
    (the final one too) taking the residual add of the sublayer before it;
    each Mamba2 block its gated norm, the shared block's norms and the
    final one the add."""
    if cfg.family == "hybrid":
        return {"gate": cfg.n_layers,
                "add": 2 * (cfg.n_layers // cfg.attn_every) + 1}
    return {"plain": 1, "add": 2 * cfg.n_layers}


def decode_step_launches(cfg, params, path):
    """One warm decode step at the config's width through the entry point
    of ``path``: "paged" (``decode_step_paged``, 8 requests on 4 pool pages
    each) or "wave" (``decode_step``, a wave of 4 in 64-slot dense caches).
    The launch counts are set to 0 just before the step and read just
    after; then the step runs once more under ``torch.profiler``, then 3 x
    5 times between CUDA events (the card idles most of a step: the time
    is the host's).  Returns (launch counts, K8's launches by variant --
    None where the wrapper does not count them --, the step's device
    kernels {name: count}, the median ms a step)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_2d
    from repro_torch.kernels.tardis_lease.kernel import LANES
    from repro_torch.models import (decode_step, decode_step_paged,
                                    init_cache, pool_layout)
    dev = "cuda"
    dtype = params["embed"].dtype
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    b = 8 if path == "paged" else 4
    toks = torch.randint(1, cfg.vocab, (b, 1), generator=g, device=dev,
                         dtype=torch.int32)
    if path == "paged":
        chunk, pages = 16, 4
        last = pool_layout(cfg)[-1]
        row = -(-(last.offset + last.token_elems) // LANES) * LANES
        pool = torch.randn((b * pages * chunk, row), generator=g,
                           device=dev).to(dtype)
        page_rows = torch.arange(b * pages, dtype=torch.int32,
                                 device=dev).reshape(b, pages)
        lengths = torch.full((b,), 40, dtype=torch.int32, device=dev)

        def step():
            decode_step_paged(cfg, params, pool, page_rows, lengths, toks,
                              chunk=chunk)
    else:
        cache = init_cache(cfg, b, 64, dtype, dev)
        cur = torch.tensor(40, dtype=torch.int32, device=dev)

        def step():
            decode_step(cfg, params, cache, toks, cur)
    step()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    norms = (dict(rmsnorm_2d.variants) if hasattr(rmsnorm_2d, "variants")
             else None)
    return counts, norms, device_kernels(step), median_ms(step, 5, 3)


def _hold_step(label, cfg, params, path):
    """``decode_step_launches`` on the card, printed, K8's launches by
    variant held to ``norms_per_step``."""
    counts, norms, kernels, ms = decode_step_launches(cfg, params, path)
    n_dev = sum(kernels.values())
    log(f"one decode step ({label}): {ms:.3f} ms warm, {n_dev} device "
        f"kernels; K8 by variant "
        f"{norms}; port launches {counts}")
    assert norms == norms_per_step(cfg), \
        f"{label}: K8 launches by variant in a decode step {norms}, want " \
        f"{norms_per_step(cfg)}"
    return n_dev


def phase3_main_path(smi):
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.models import init_params
    cfg = get_arch("tinyllama-1.1b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, torch.bfloat16)
    reset_launch_counts()
    cluster, done, report, dt = _serve(cfg, params, "cuda", 4096, 512)
    counts = launch_counts()
    variants = variant_counts()
    n_tok = sum(len(r.output) for r in done)
    assert all(r.done and len(r.output) == r.max_new for r in done)
    assert all(0 <= int(t) < cfg.vocab for r in done for t in r.output)
    assert bool(torch.isfinite(cluster.prefix_engine._kv_pool).all())
    assert report["prefix_prefill_tokens_skipped"] > 0, "no prefix hit"
    log(f"main path on {smi}: tinyllama-1.1b full width ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}), {len(done)} requests served, "
        f"{n_tok} tokens in {dt:.2f} s = {n_tok / dt:.1f} tokens/s")
    log(f"coherence_report on {smi}: " + json.dumps(
        {k: (int(v) if isinstance(v, (int, np.integer)) else v)
         for k, v in report.items()}))
    log(f"launches on the main path: {counts}")
    log(f"launches by variant on the main path: {variants}")
    missing = [k for k in PAGED_KERNELS if counts[k] <= 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    # every K4 and K6 launch of the bf16 path on the tensor-core variant
    assert variants["paged_decode"] == {"mma": counts["paged_decode"]}, \
        f"K4 launches by variant: {variants['paged_decode']}"
    assert variants["flash_prefill"] == {"wgmma": counts["flash_prefill"]}, \
        f"K6 launches by variant: {variants['flash_prefill']}"
    del cluster
    _hold_step("paged path, tinyllama-1.1b", cfg, params, "paged")
    profile_main_path(cfg, params, smi)
    del params
    torch.cuda.empty_cache()
    return counts, variants, n_tok / dt


# The paper's coherence simulator: K9 runs the JAX package's whole
# while_loop in one launch.  Phase 2 holds it against the plain loop on the
# card, bit for bit, over the whole state; phase 3 runs every golden run
# (tests/data/torch_sim_golden.json, scripts/sim_golden.py: fig4 at 64
# cores and scale 1.0, fig8's 256-core point) through core.simulate.
SIM_GOLDEN = ROOT / "tests" / "data" / "torch_sim_golden.json"
SIM_TINY = dict(n_cores=8, l1_sets=4, l1_ways=2, llc_sets=4, llc_ways=2)


def _sim_litmus():
    from repro_torch.core.traces import _Builder
    b = _Builder(2)
    b.store(0, 0)
    b.load(0, 1)
    b.store(1, 1)
    b.load(1, 0)
    return b.build(4, "litmus")


def _sim_case_state(tr, proto, geom_kw=None, **cfg_kw):
    """(geom, state()) for one run as ``simulate`` sizes it (log on), each
    ``state()`` a fresh ``init_state`` on the card."""
    from repro_torch.core import Geometry, SimConfig
    from repro_torch.core.simulator import init_state
    cfg = SimConfig(**{"max_steps": 4_000_000, **cfg_kw})
    geom = dataclasses.replace(
        Geometry(**(geom_kw or {"n_cores": tr.n_cores})),
        n_cores=tr.n_cores, trace_len=tr.length,
        n_addr=max(Geometry().n_addr, int(tr.n_addr)),
        log_size=int(min(cfg.max_steps, tr.total_ops() * 8 + 4096)))

    def state():
        return init_state(geom, tr, cfg.as_tensors("cuda"),
                          directory=proto == "directory", device="cuda")
    return geom, state


def _flat(st, pre=""):
    out = {}
    for k, v in st.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


def _chase_cycle(n):
    """A random cycle over n int32 entries (``nxt[i]`` the next), on the
    card."""
    import torch
    g = torch.Generator().manual_seed(SEED)
    perm = torch.randperm(n, generator=g)
    nxt = torch.empty(n, dtype=torch.int64)
    nxt[perm] = perm.roll(-1)
    return nxt.to(torch.int32).cuda()


def _chase_ms(probe, nxt, hops, reps=5):
    """ms a dependent load of ``probe``: median over ``reps`` of (a chase
    of ``2 hops`` less one of ``hops``) / hops, so the launch and the
    probe's set-up drop out."""
    import torch
    probe(nxt, hops)
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        probe(nxt, hops)
        ev[1].record()
        probe(nxt, 2 * hops)
        ev[2].record()
        torch.cuda.synchronize()
        times.append((ev[1].elapsed_time(ev[2]) - ev[0].elapsed_time(ev[1]))
                     / hops)
    return sorted(times)[len(times) // 2]


def l2_round_trip_ms():
    """One dependent L2 round trip on this card: K9's source's probe
    follows a random cycle over 4 MB (L2-resident, past L1) through
    ``ld.global.cg``."""
    from repro_torch.kernels.coherence_sim.kernel import l2_chase
    nxt = _chase_cycle(1 << 20)
    nxt.sum()                                   # bring it into L2
    return _chase_ms(l2_chase, nxt, 20000)


def smem_round_trip_ms():
    """One dependent shared-memory round trip on this card: the same
    source's probe follows a random cycle over 32 KB in one thread's
    shared memory."""
    from repro_torch.kernels.coherence_sim.kernel import smem_chase
    return _chase_ms(smem_chase, _chase_cycle(8192), 200000)


def k9_bound_ms(res_steps, n_llc_req, t_l2, t_smem):
    """K9's bound (ms) for a run: each step at least one dependent
    shared-memory round trip, each LLC request one L2 round trip (the
    LLC fits no SM); beside it PR 19's, each step one L2 round trip."""
    return res_steps * t_smem + n_llc_req * t_l2, res_steps * t_l2


def _k9_run(st, geom, proto, variant):
    """ms of one K9 launch on ``st``: CUDA events around it, the card
    kept busy (``torch.cuda._sleep``, ~2 ms) while the host prepares the
    launch, so the events time the kernel and not the wrapper's Python."""
    import torch
    from repro_torch.kernels.coherence_sim import kernel as CK
    torch.cuda.synchronize()
    torch.cuda._sleep(K9_SLEEP_CYCLES)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    CK.sim_run(st, geom, proto, variant=variant)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


K9_SLEEP_CYCLES = 4_000_000     # ~2 ms of the card's clock


def _k9_row(variant, shape, ms, call_ms, plain_ms, err, steps, n_llc, t_l2,
            t_smem):
    new, old = k9_bound_ms(steps, n_llc, t_l2, t_smem)
    return dict(name="sim_run", wrapper="sim_run", variant=variant,
                route="cuda", path="simulator",
                source="src/repro_torch/kernels/coherence_sim/csrc/"
                "sim_run.cu",
                replaces="src/repro/core/simulator.py:570 "
                "(lax.while_loop; no Pallas kernel)",
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=new, bound_by="serial steps",
                library_ms=None, launch_ms=None,
                shape=f"{shape}: {steps} steps, {n_llc} LLC requests; us/step "
                f"K9 ({variant}) {ms / steps * 1e3:.3f}, plain "
                f"{plain_ms / steps * 1e3:.1f}; bound: steps x "
                f"{t_smem * 1e6:.1f} ns (shared-memory round trip) + LLC "
                f"requests x {t_l2 * 1e6:.1f} ns (L2 round trip); PR 19's "
                f"bound (steps x L2) {old:.3f} ms")


def phase2_coherence_sim(rows):
    """K9 against its plain loop on the card, every tensor of the final
    state bit for bit, in each variant that takes the state ("smem": the
    L1 in shared memory; "global"), the variants also against each other:
    the litmus (both protocols), fft at 16 cores and scale 0.1 (both), the
    tiny-cache geometry, ts_bits=4, the E-state, Ackwise (k = 4) and
    speculation off.  ms and us a simulated step of each (K9: CUDA events
    around its one launch; the plain loop: the host's clock,
    synchronised).  Two rows, the fft / Tardis run's in each variant;
    their bound that run's steps times one shared-memory round trip plus
    its LLC requests times one L2 round trip (the source's two probes).
    Returns the probes' (L2, shared-memory) round trips in ms."""
    import torch
    from repro_torch.core.traces import make_trace
    from repro_torch.kernels.coherence_sim import kernel as CK
    from repro_torch.kernels.coherence_sim.ref import sim_run_ref
    fft16 = make_trace("fft", 16, scale=0.1)
    cases = (("litmus/tardis", _sim_litmus(), "tardis", None, {}),
             ("litmus/directory", _sim_litmus(), "directory", None, {}),
             ("fft16/tardis", fft16, "tardis", None, {}),
             ("fft16/directory", fft16, "directory", None, {}),
             ("tiny-cache barnes8/tardis", make_trace("barnes", 8, scale=0.1),
              "tardis", SIM_TINY, {}),
             ("ts_bits=4 volrend8", make_trace("volrend", 8, scale=0.1),
              "tardis", None, {"ts_bits": 4}),
             ("estate water_sp4", make_trace("water_sp", 4, scale=0.1),
              "tardis", None, {"estate": True}),
             ("ackwise_k=4 barnes8/directory",
              make_trace("barnes", 8, scale=0.1), "directory", None,
              {"ackwise_k": 4}),
             ("speculate=False volrend8", make_trace("volrend", 8,
                                                     scale=0.1),
              "tardis", None, {"speculate": False}))
    t_l2 = l2_round_trip_ms()
    t_smem = smem_round_trip_ms()
    log(f"  one dependent L2 round trip (K9's probe): {t_l2 * 1e6:.1f} ns; "
        f"one dependent shared-memory round trip: {t_smem * 1e6:.1f} ns")
    for label, tr, proto, geom_kw, cfg_kw in cases:
        geom, state = _sim_case_state(tr, proto, geom_kw, **cfg_kw)
        want = state()
        t0 = time.perf_counter()
        sim_run_ref(want, geom, proto)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        fb = _flat(want)
        steps = int(want["steps"])
        got = {}
        for variant in CK.VARIANTS:
            if CK.smem_bytes(geom, variant) > CK.SMEM_LIMIT:
                continue
            st = state()
            k9_ms = _k9_run(st, geom, proto, variant)
            fa = _flat(st)
            err = max(max_err(fa[k], fb[k]) for k in fa)
            bad = [k for k in fa if not torch.equal(fa[k], fb[k])]
            log(f"  K9 {label} ({variant}, {CK.smem_bytes(geom, variant)} "
                f"B shared): {steps} steps; K9 {k9_ms:.3f} ms = "
                f"{k9_ms / steps * 1e3:.3f} us/step, plain {plain_ms:.1f} ms"
                f" = {plain_ms / steps * 1e3:.1f} us/step; "
                + ("bit-identical" if not bad else f"DIFFERS in {bad}"))
            assert not bad, f"K9 ({label}, {variant}) differs from its " \
                f"plain loop: {bad}"
            got[variant] = fa
        assert got, f"no K9 variant takes {label}"
        if len(got) == 2:
            bad = [k for k in got["smem"]
                   if not torch.equal(got["smem"][k], got["global"][k])]
            assert not bad, f"K9's variants differ on {label}: {bad}"
        if label == "fft16/tardis":
            n_llc = int(want["stats"]["n_llc_req"])
            for variant in CK.VARIANTS:
                times, calls = [], []
                for _ in range(5):
                    st = state()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    times.append(_k9_run(st, geom, proto, variant))
                    calls.append((time.perf_counter() - t0) * 1e3)
                row = _k9_row(variant, "fft, 16 cores, scale 0.1, Tardis",
                              sorted(times)[2], sorted(calls)[2], plain_ms,
                              err, steps, n_llc, t_l2, t_smem)
                rows.append(row)
                _log_row(row)
        del got, want
    return t_l2, t_smem


def phase3_simulator_path(smi, rows, t_l2, t_smem):
    """Every golden run (fig4: 12 benchmarks x {MSI, Ackwise k=4, Tardis,
    Tardis without speculation} at 64 cores and scale 1.0; fig8: fmm, fft
    and lu_c at 256 cores and scale 0.08 under MSI and Tardis) through
    ``repro_torch.core.simulate`` on the card, each on its stored trace
    (``tests/data/torch_sim_traces.npz``: the reference's inputs, which
    this machine's numpy need not regenerate -- the generators it does
    reproduce are printed): each exactly one K9 launch and one host sync
    (``torch.cuda.set_sync_debug_mode``), bit-identical to its golden
    entry (stats, cycles, ops, aborted, pts, the log's sha256s, steps)
    and SC-clean (``check_sc``), in the K9 variant its geometry takes
    (fig4: "smem", fig8: "global"); wall ms, steps and us a step each;
    fig4's and fig8's averages as ``benchmarks/paper_figs.py`` computes
    them; then fig4/fft/tardis again, K9 alone (CUDA events) beside the
    plain loop on the card, bit for bit: K9's row at 64 cores.  Returns
    the launch counts of the runs and their counts by variant."""
    import warnings

    import numpy as np
    import torch
    from repro_torch.core import SimConfig, Trace, make_trace, simulate
    from repro_torch.core.check import check_sc
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.kernels.coherence_sim import kernel as CK
    from repro_torch.kernels.coherence_sim.ref import sim_run_ref
    sys.path.insert(0, str(ROOT / "scripts"))
    from sim_golden import load_traces, result_entry, trace_key
    golden = json.loads(SIM_GOLDEN.read_text())
    traces = load_traces(Trace)
    same = [k for k, tr in traces.items() if all(
        np.array_equal(getattr(tr, f), getattr(make_trace(
            tr.name, tr.n_cores, scale=float(k.split("/")[2])), f))
        for f in ("op_type", "op_addr", "op_aux", "op_think"))]
    log(f"  numpy {np.__version__}: this machine's generators rebuild "
        f"{len(same)} of the {len(traces)} stored traces (not: "
        f"{sorted(set(traces) - set(same))})")
    res_by_key, walls = {}, []
    reset_launch_counts()
    for entry in golden["runs"]:
        tr = traces[trace_key(entry)]
        cfg = SimConfig(max_steps=golden["max_steps"], **entry["config"])
        before = launch_counts()["sim_run"]
        before_v = dict(CK.sim_run.variants)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                res = simulate(tr, entry["proto"], cfg, log=True)
                wall = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        launches = launch_counts()["sim_run"] - before
        (variant,) = [v for v, k in CK.sim_run.variants.items()
                      if k != before_v.get(v, 0)]
        got = result_entry(res)
        bad = [k for k in ("stats", "cycles", "ops", "aborted", "pts",
                           "log_n", "log_sha256") if got[k] != entry[k]]
        if res.steps != entry["steps"]:
            bad.append("steps")
        check_sc(res.log, entry["n_cores"])
        walls.append((wall, res.steps))
        log(f"  {entry['key']:36s} {wall:9.2f} ms wall, {res.steps:6d} "
            f"steps, {wall / res.steps * 1e3:6.3f} us/step, {launches} "
            f"launch ({variant}), {syncs} sync, SC clean, "
            + ("bit-identical to golden" if not bad else f"DIFFERS: {bad}"))
        assert launches == 1 and syncs == 1, (entry["key"], launches, syncs)
        assert variant == {"fig4": "smem", "fig8": "global"}[entry["fig"]], \
            (entry["key"], variant)
        assert not bad, f"{entry['key']} differs from its golden entry: {bad}"
        res_by_key[entry["key"]] = res
    counts, variants = launch_counts(), variant_counts()
    wall = sum(w for w, _ in walls)
    steps = sum(n for _, n in walls)
    for fig in ("fig4", "fig8"):
        fw = [(w, n) for (w, n), e in zip(walls, golden["runs"])
              if e["fig"] == fig]
        log(f"  {fig}: {len(fw)} runs, {sum(n for _, n in fw)} steps in "
            f"{sum(w for w, _ in fw):.1f} ms wall = "
            f"{sum(w for w, _ in fw) / sum(n for _, n in fw) * 1e3:.3f} "
            f"us/step")
    log(f"simulator path on {smi}: {len(walls)} runs, {steps} steps in "
        f"{wall:.1f} ms wall = {wall / steps * 1e3:.3f} us/step; K9 "
        f"launches {counts['sim_run']} {variants['sim_run']}")
    # one run's breakdown: K9's device time (CUDA events around the one
    # launch, median of 3) against simulate's wall time for the same run,
    # and the plain loop on the card over the same run
    entry = next(e for e in golden["runs"] if e["key"] == "fig4/fft/tardis")
    geom, state = _sim_case_state(traces[trace_key(entry)], "tardis")
    k9 = []
    for _ in range(3):
        st = state()
        k9.append(_k9_run(st, geom, "tardis", None))
    k9_ms = sorted(k9)[1]
    run_ms = next(w for (w, _), e in zip(walls, golden["runs"])
                  if e is entry)
    want = state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim_run_ref(want, geom, "tardis")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    fa, fb = _flat(st), _flat(want)
    bad = [k for k in fa if not torch.equal(fa[k], fb[k])]
    assert not bad, f"K9 differs from its plain loop on {entry['key']}: {bad}"
    log(f"  fig4/fft/tardis: K9 {k9_ms:.2f} ms on the card of simulate's "
        f"{run_ms:.2f} ms wall ({k9_ms / run_ms:.3f}; the rest: state "
        f"set-up, launch, one read-back); the plain loop {plain_ms:.1f} ms, "
        f"bit-identical")
    row = _k9_row(CK.pick_variant(geom), "fig4/fft/tardis: fft, 64 cores, "
                  "scale 1.0, Tardis", k9_ms, run_ms, plain_ms, 0.0,
                  int(st["steps"]), int(st["stats"]["n_llc_req"]), t_l2,
                  t_smem)
    rows.append(row)
    _log_row(row)

    def rel(fig, bench, a, b, stat=None):
        ra = res_by_key[f"{fig}/{bench}/{a}"]
        rb = res_by_key[f"{fig}/{bench}/{b}"]
        if stat:
            return ra.stats[stat] / max(1, rb.stats[stat])
        return ra.cycles / max(1, rb.cycles)

    fig4 = sorted({e["bench"] for e in golden["runs"]
                   if e["fig"] == "fig4"})
    out = {
        "tardis_vs_msi": float(np.mean([rel("fig4", b, "directory",
                                            "tardis") for b in fig4])),
        "nospec_vs_msi": float(np.mean([rel("fig4", b, "directory",
                                            "tardis,speculate=False")
                                        for b in fig4])),
        "ackwise_vs_msi": float(np.mean([rel("fig4", b, "directory",
                                             "directory,ackwise_k=4")
                                         for b in fig4])),
        "traffic_vs_msi": float(np.mean([rel("fig4", b, "tardis",
                                             "directory", "traffic")
                                         for b in fig4]))}
    log(f"fig4 (64 cores, scale 1.0, {len(fig4)} benchmarks) on the card: "
        + json.dumps(out))
    fig8 = sorted({e["bench"] for e in golden["runs"]
                   if e["fig"] == "fig8"})
    out8 = {"tardis_vs_msi": float(np.mean([rel("fig8", b, "directory",
                                                "tardis") for b in fig8])),
            "traffic_vs_msi": float(np.mean([rel("fig8", b, "tardis",
                                                 "directory", "traffic")
                                             for b in fig8]))}
    log(f"fig8 (256 cores, scale 0.08, {', '.join(fig8)}) on the card: "
        + json.dumps(out8))
    assert counts["sim_run"] == len(golden["runs"]), counts
    return counts, variants


# Multi-host serving: the JAX package's model of a fleet -- K hosts, each a
# ServingCluster with the paged path's pool (4096 + 512 blocks of 16
# tokens), ticked in lockstep in one process and sharing one sharded lease
# directory whose tables and home pages sit on the card beside them.
# Fleet A is symmetric: 2 mixed hosts over 2 shards, requests 0-3 pinned
# to host 0 and then 4-7 to host 1 (as ``launch/serve.py`` runs it); fleet
# B is disaggregated: a prefill pod and two decode pods over 4 shards
# (shard 3 on host 0), every request routed.
FLEETS = {"A": dict(n_hosts=2, n_shards=2),
          "B": dict(n_hosts=3, n_shards=4,
                    roles=("prefill", "decode", "decode"))}
# phase 3's fleets run tinyllama-1.1b at full width and this many of its
# 22 layers, so that the script keeps within its time limit
FLEET_LAYERS = 8


def _serve_fleet(cfg, params, dev, fleet, n_prefix_blocks=4096,
                 n_decode_pages=512, trace=False, seed=SEED,
                 on_build=None):
    """One serving run of fleet ``fleet`` (a key of ``FLEETS``) over the
    smoke's requests, the directory on the device backend; ``on_build``
    sees the fleet before it serves.  Returns (fleet, done, report,
    seconds); on the card the time ends in a device synchronise."""
    import numpy as np
    import torch
    from repro_torch.runtime import MultiHostServingCluster, Request
    kw = dict(FLEETS[fleet])
    roles = kw.pop("roles", None)
    mh = MultiHostServingCluster(
        cfg, lambda: params, n_replicas=2, prefix_block_tokens=16,
        n_prefix_blocks=n_prefix_blocks, n_decode_pages=n_decode_pages,
        max_pages=32, device=dev, dir_backend="device",
        roles=None if roles is None else list(roles), **kw)
    if trace:
        for host in mh.hosts:
            host.trace = []
    if on_build is not None:
        on_build(mh)
    reqs = _requests(Request, np, cfg.vocab, seed=seed)
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if roles is None:
        half = len(reqs) // 2
        mh.run(reqs[:half], affinity=[0] * half)
        _, report = mh.run(reqs[half:], affinity=[1] * (len(reqs) - half))
    else:
        _, report = mh.run(reqs)
    if dev == "cuda":
        torch.cuda.synchronize()
    return mh, reqs, report, time.perf_counter() - t0


def check_fleet(fleet, mh, done, report):
    """The fleet's contract: every request served, no multicast and no
    invalidation message, at most one message pair per remote shard a
    wave; fleet A's host 1 served the prefix from migrated pages, fleet
    B's decode pods never prefilled a cold prefix; and every page a host
    took by migration bit-identical to its owner shard's home row.
    Returns the pages compared."""
    import torch
    vocab = mh.hosts[0].cfg.vocab
    assert all(r.done and len(r.output) == r.max_new for r in done)
    assert all(0 <= int(t) < vocab for r in done for t in r.output)
    dirx = mh.directory
    assert report["xhost_multicasts"] == 0, report["xhost_multicasts"]
    assert report["xhost_invalidation_msgs"] == 0
    assert dirx.max_msgs_per_wave() <= 2 * (dirx.n_shards - 1), \
        f"fleet {fleet}: {dirx.max_msgs_per_wave()} messages in one wave"
    if fleet == "A":
        assert report["host1_xhost_pages_fetched"] > 0
        assert report["host1_prefix_prefill_tokens_skipped"] > 0
    else:
        for h, role in enumerate(FLEETS[fleet]["roles"]):
            if role == "decode":
                assert report[f"host{h}_role_cold_prefills"] == 0, h
        assert report["router_handoffs"] > 0
    n_pages = 0
    for h, host in enumerate(mh.hosts):
        for bid in sorted(host._migrated):
            assert dirx.home_ok(bid) and host._tags[bid] == dirx.tags[bid]
            mine = host.prefix_engine._kv_pool[bid]
            home = dirx.home_rows(bid)
            assert mine.device == home.device
            assert torch.equal(mine.view(torch.uint8),
                               home.view(torch.uint8)), \
                f"fleet {fleet}: host {h}'s migrated page {bid} differs " \
                f"from its home row"
            n_pages += 1
    assert n_pages > 0, f"fleet {fleet}: no page migrated"
    return n_pages


def count_wave_syncs(tally):
    """An ``on_build`` hook: every directory wave of the fleet runs under
    ``torch.cuda.set_sync_debug_mode("warn")`` and appends to ``tally``
    the synchronising operations it made (the host reads of K1's and K2's
    results)."""
    import warnings

    import torch

    def hook(mh):
        dirx = mh.directory
        wave = dirx.wave

        def counted(*a, **k):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    out = wave(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            tally.append(sum("synchroniz" in str(w.message)
                             for w in caught))
            return out
        dirx.wave = counted
    return hook


def phase3_multi_host(smi):
    """Fleets A and B at full width and ``FLEET_LAYERS`` layers
    (tinyllama-1.1b, bf16 weights from seed 0, every host sharing the
    same weight tensors), the
    directory on the card: per fleet the launch counts set to 0 just
    before its run and read just after (K1-K4, K6 and K8 must launch),
    ``check_fleet``, the device syncs a directory wave costs, the
    directory's report, then the fleet again warm and timed, and once
    more under ``torch.profiler`` (the card's activity).  Returns {fleet:
    launch counts}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b"),
                              n_layers=FLEET_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, torch.bfloat16)
    out = {}
    for fleet, kw in FLEETS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        syncs = []
        reset_launch_counts()
        mh, done, report, dt = _serve_fleet(
            cfg, params, "cuda", fleet, on_build=count_wave_syncs(syncs))
        counts = launch_counts()
        variants = variant_counts()
        n_tok = sum(len(r.output) for r in done)
        n_pages = check_fleet(fleet, mh, done, report)
        label = (f"fleet {fleet} ({kw['n_hosts']} hosts"
                 + (f" {','.join(kw['roles'])}" if "roles" in kw else
                    " mixed") + f", {kw['n_shards']} shards)")
        log(f"multi-host {label} on {smi}: tinyllama-1.1b full width "
            f"({cfg.n_layers} of its 22 layers), {len(done)} requests served, "
            f"{n_tok} tokens in {dt:.2f} s = {n_tok / dt:.1f} tokens/s; "
            f"{n_pages} migrated pages bit-identical to their home rows; "
            f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        log(f"directory report ({label}) on {smi}: "
            + json.dumps(mh.directory.report()))
        log(f"coherence_report ({label}) on {smi}: " + json.dumps(
            {k: (int(v) if isinstance(v, (int, np.integer)) else v)
             for k, v in report.items()}))
        log(f"device syncs a directory wave ({label}): "
            f"{sum(syncs)} over {len(syncs)} waves, mean "
            f"{sum(syncs) / max(1, len(syncs)):.2f}, max {max(syncs)}")
        log(f"launches on {label}: {counts}")
        log(f"launches by variant on {label}: {variants}")
        missing = [k for k in PAGED_KERNELS if counts[k] <= 0]
        assert not missing, f"kernels never launched on {label}: {missing}"
        out[fleet] = counts
        del mh
        gc.collect()               # the sync hook made a reference cycle

        def serve(fleet=fleet):
            return _serve_fleet(cfg, params, "cuda", fleet)

        _mh, done, _r, dt = serve()
        log(f"warm multi-host {label} on {smi}: {n_tok} tokens in "
            f"{dt:.3f} s = {n_tok / dt:.1f} tokens/s (no profiler)")
        del _mh
        # the card's activity only: tracing the host's ~80000 launches
        # too would cost the script ~40 s a fleet
        profile_path(f"multi-host {label}", serve, smi, with_host=False)
    del params
    torch.cuda.empty_cache()
    return out


# The fixed-wave dense-cache path: (arch, its depth on the card,
# ServingCluster kwargs); zamba2 at 3 of its 9 groups (each 6 Mamba2
# layers and the shared attention), so that the script keeps within its
# time limit
WAVE_PATHS = (("tinyllama-1.1b", 22, dict(prefix_reuse=False)),
              ("zamba2-2.7b", 18, {}))


def _wave_requests(Request, np, vocab, n=8, lo=2048, hi=3072, max_new=16,
                   seed=SEED):
    """Document-length prompts: random tokens, lengths in [lo, hi]."""
    rng = np.random.default_rng(seed + 1)
    return [Request(i, rng.integers(1, vocab, int(rng.integers(lo, hi + 1)))
                    .astype(np.int32), max_new=max_new) for i in range(n)]


def _serve_waves(cfg, params, dev, cache_len, reqs_kw, trace=False, **kw):
    """One wave-path ``ServingCluster.run`` (4 replicas: waves of 4).
    Returns (cluster, done, report, seconds)."""
    import numpy as np
    import torch
    from repro_torch.runtime import Request, ServingCluster
    cluster = ServingCluster(cfg, lambda: params, n_replicas=4,
                             prefix_block_tokens=16, cache_len=cache_len,
                             device=dev, **kw)
    assert not cluster.paged
    if trace:
        cluster.trace = []
    reqs = _wave_requests(Request, np, cfg.vocab, **reqs_kw)
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, report = cluster.run(reqs)
    if dev == "cuda":
        torch.cuda.synchronize()
    return cluster, done, report, time.perf_counter() - t0


def phase3_wave_paths(smi):
    """The fixed-wave path at full width (``WAVE_PATHS``' depths), once per
    configuration with the launch counts set to 0 just before and read
    just after, one
    decode step's launches (``_hold_step``), then warm and profiled.
    Returns {arch: (launch counts, launches by variant)}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.models import init_params, param_leaves
    out = {}
    for arch, depth, kw in WAVE_PATHS:
        cfg = dataclasses.replace(get_arch(arch), n_layers=depth)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = init_params(cfg, gen, torch.bfloat16)
        n_par = sum(t.numel() for t in param_leaves(params))

        def serve(cfg=cfg, params=params, kw=kw):
            return _serve_waves(cfg, params, "cuda", 4096, {}, **kw)

        reset_launch_counts()
        cluster, done, report, dt = serve()
        counts = launch_counts()
        variants = variant_counts()
        n_tok = sum(len(r.output) for r in done)
        assert all(r.done and len(r.output) == r.max_new for r in done)
        assert all(0 <= int(t) < cfg.vocab for r in done for t in r.output)
        lens = [len(r.prompt) for r in done]
        log(f"wave path on {smi}: {arch} full width ({cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, {n_par / 1e9:.3f} B params, "
            f"prefix_reuse={cluster.prefix_reuse}), {len(done)} requests "
            f"(prompts {min(lens)}-{max(lens)} tokens, 4096-slot caches), "
            f"{n_tok} tokens in {dt:.2f} s = {n_tok / dt:.1f} tokens/s")
        log(f"coherence_report ({arch} waves) on {smi}: " + json.dumps(
            {k: (int(v) if isinstance(v, (int, np.integer)) else v)
             for k, v in report.items()}))
        log(f"launches on the {arch} wave path: {counts}")
        log(f"launches by variant on the {arch} wave path: {variants}")
        missing = [k for k in WAVE_KERNELS[arch] if counts[k] <= 0]
        assert not missing, \
            f"kernels never launched on the {arch} wave path: {missing}"
        # every K7 and K6 launch of the bf16 path on the tensor-core variant
        assert variants["ssd_chunk"] == ({"mma": counts["ssd_chunk"]}
                                         if counts["ssd_chunk"] else {}), \
            f"K7 launches by variant: {variants['ssd_chunk']}"
        assert variants["flash_prefill"] == {
            "wgmma": counts["flash_prefill"]}, \
            f"K6 launches by variant: {variants['flash_prefill']}"
        del cluster
        torch.cuda.empty_cache()
        _hold_step(f"wave path, {arch}", cfg, params, "wave")
        # the run above already timed the path without the profiler
        profile_path(f"{arch} wave path", serve, smi, with_host=False)
        out[arch] = counts, variants
        del params
        torch.cuda.empty_cache()
    return out


# kimi-k2-1t-a32b on the paged path: full width (d_model 7168, 64 / 8
# heads, Dh 112, vocab 163840, 384 experts top-8, d_ff_expert 2048, one
# shared expert, the dense layer's d_ff 16384), depth cut to 2 layers --
# the leading dense layer and one moe layer, the reference tests' own
# reduction of kimi -- so that its ~40 GB of bf16 weights fit the card
KIMI = "kimi-k2-1t-a32b"


def kimi_config():
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(KIMI), n_layers=2)


def kimi_phase4_config():
    """Phase 4's kimi lane: the attention at full width (d_model 7168, Dh
    112, G 8) and the dense layer's d_ff, 2 layers, with what the CPU's
    fp32 anchor cannot hold cut: vocab 163840 -> 32000 and 384 experts ->
    16 (top-8 kept)."""
    return dataclasses.replace(kimi_config(), vocab=32000, n_experts=16)


def phase3_kimi_path(smi):
    """``phase3_decoder_path`` serving kimi-k2 at full width
    (``kimi_config``), its two cache stacks held too: both in the pool's
    token rows, each appended with every token.  Returns (launch counts,
    launches by variant)."""
    def two_stacks(report):
        assert report["kv_pool_stacks"] == "dense,moe", \
            report["kv_pool_stacks"]
        assert (report["pool_tokens_appended_dense"]
                == report["pool_tokens_appended_moe"]
                == report["kv_tokens_appended"] > 0)
    return phase3_decoder_path(smi, kimi_config(), check=two_stacks)


def decoder_config(arch, depth):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch), n_layers=depth)


def phase3_decoder_path(smi, cfg, check=None):
    """The paged path serving ``cfg`` at full width, the earlier paths'
    weights freed first and this one's drawn in bf16 on the card: the
    launch counts set to 0 just before the run and read just after (K1-K4,
    K6, K8 must launch; every K4 launch on "mma", every K6 launch on
    "wgmma"), every request done with its 16 tokens, the pool finite, a
    prefix hit, ``check(report)``; tokens/s of the first run, the card's
    peak memory, one decode step's launches, a warm run and a profiled one
    (the card's activity only: its idle share).  Returns (launch counts,
    launches by variant)."""
    import numpy as np
    import torch
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.models import init_params, param_leaves
    gc.collect()        # a cluster's engine and replicas form cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), torch.bfloat16)
    torch.cuda.synchronize()
    leaves = param_leaves(params)
    n_par = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    del leaves
    label = (f"{cfg.name} paged path ({cfg.n_layers} layers"
             + (f": {cfg.first_dense_layers} dense + "
                f"{cfg.n_layers - cfg.first_dense_layers} moe"
                if cfg.first_dense_layers else "")
             + f", d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} "
             f"heads, Dh {cfg.head_dim()}, vocab {cfg.vocab}"
             + (f", {cfg.n_experts} experts top-{cfg.top_k}"
                if cfg.n_experts else "") + ")")
    log(f"{cfg.name} weights on {smi}: {n_par / 1e9:.3f} B params, "
        f"{n_bytes / 1e9:.2f} GB, drawn in {time.perf_counter() - t0:.1f} s")
    reset_launch_counts()
    cluster, done, report, dt = _serve(cfg, params, "cuda", 4096, 512)
    counts = launch_counts()
    variants = variant_counts()
    # read before the check below: isfinite's temporaries take 2.5x the pool
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(r.output) for r in done)
    assert all(r.done and len(r.output) == r.max_new == 16 for r in done)
    assert all(0 <= int(t) < cfg.vocab for r in done for t in r.output)
    assert bool(torch.isfinite(cluster.prefix_engine._kv_pool).all())
    assert report["prefix_prefill_tokens_skipped"] > 0, "no prefix hit"
    if check is not None:
        check(report)
    log(f"{label} on {smi}: {len(done)} requests served, {n_tok} tokens in "
        f"{dt:.2f} s = {n_tok / dt:.1f} tokens/s (first run); "
        f"max_memory_allocated {peak / 1e9:.2f} GB (weights and pool "
        f"{(n_bytes + cluster.prefix_engine._kv_pool.nbytes) / 1e9:.2f} GB)")
    log(f"coherence_report ({cfg.name}) on {smi}: " + json.dumps(
        {k: (int(v) if isinstance(v, (int, np.integer)) else v)
         for k, v in report.items()}))
    log(f"launches on the {cfg.name} paged path: {counts}")
    log(f"launches by variant on the {cfg.name} paged path: {variants}")
    missing = [k for k in PAGED_KERNELS if counts[k] <= 0]
    assert not missing, \
        f"kernels never launched on the {cfg.name} path: {missing}"
    assert variants["paged_decode"] == {"mma": counts["paged_decode"]}, \
        f"K4 launches by variant ({cfg.name}): {variants['paged_decode']}"
    assert variants["flash_prefill"] == {"wgmma": counts["flash_prefill"]}, \
        f"K6 launches by variant ({cfg.name}): {variants['flash_prefill']}"
    del cluster
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _hold_step(f"paged path, {cfg.name}", cfg, params, "paged")
    _c, done, _r, dt = _serve(cfg, params, "cuda", 4096, 512)
    n_tok = sum(len(r.output) for r in done)
    log(f"profile: warm {cfg.name} paged path on {smi}: {n_tok} tokens in "
        f"{dt:.3f} s = {n_tok / dt:.1f} tokens/s (no profiler)")
    del _c, done, _r
    gc.collect()
    profile_path(f"{cfg.name} paged path", lambda: _serve(
        cfg, params, "cuda", 4096, 512), smi, with_host=False)
    log(f"{cfg.name}: max_memory_allocated over the decode step, the warm "
        f"and the profiled run {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts, variants


def phase3_decoder_paths(smi):
    """``phase3_decoder_path`` for each of ``DECODERS``.  Returns {arch:
    (launch counts, launches by variant)}."""
    out = {}
    for arch, depth in DECODERS:
        t0 = time.perf_counter()
        out[arch] = phase3_decoder_path(smi, decoder_config(arch, depth))
        log(f"[{arch}: {time.perf_counter() - t0:.1f} s]")
    return out


def _example(name):
    """``examples/<name>.py`` loaded as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase3_serving_example(smi):
    """``examples/serve_tardis_torch.py`` on the card: its traffic (24
    requests on 3 replicas, a 32-token system prompt in blocks of 8,
    random budgets up to 8 tokens), its fp32 weights and its hot-swap
    between the halves, at the published tinyllama-1.1b config (22
    layers, full width), under ``TARDIS_SANITIZE=1``: the ledger printed,
    every ``--check`` assertion, K1-K4, K6 and K8 launched."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.models import init_params
    ex = _example("serve_tardis_torch")
    args = ex.parse_args([])
    cfg = get_arch("tinyllama-1.1b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), torch.float32)
    with patch.dict(os.environ, {"TARDIS_SANITIZE": "1"}):
        reset_launch_counts()
        cluster, reqs, (_, report), wts, dt = ex.serve(cfg, params, args,
                                                       "cuda")
        counts = launch_counts()
        variants = variant_counts()
    ex.print_ledger(cluster, reqs, report, dt)
    ex.check(cluster, reqs, report, args)
    assert report["sanitize_checks"] > 0 and wts > 0
    log(f"serving example on {smi}: tinyllama-1.1b full width (fp32 "
        f"weights), {len(reqs)} requests, hot-swap at logical time {wts}, "
        f"{report['sanitize_checks']} sanitizer checks; launches {counts}; "
        f"by variant {variants}")
    missing = [k for k in PAGED_KERNELS if counts[k] <= 0]
    assert not missing, f"kernels never launched by the example: {missing}"
    del cluster, params
    torch.cuda.empty_cache()


def phase3_elastic_example(smi):
    """``examples/elastic_dp_torch.py`` at its own reduced config on the
    card and on the CPU from the same weights -- every worker step's loss
    within rtol 2e-4 (``tests/test_torch_elastic.py``'s tolerance), every
    counter equal -- then at tinyllama-1.1b full width and depth in fp32
    on the card: joins, leaves, renewals, data-less renewals and max
    staleness equal to the reduced run's (they follow from the schedule
    and the lease alone), the losses finite, K6 / K10 and K8 / K11
    launched (counts set to 0 before the run, read after).  The full-width
    run again at a tenth of the example's learning rate, its losses
    printed (at 3e-3 AdamW's first steps move each weight by about the
    rate, so a matmul's output by about the rate times its fan-in)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    ex = _example("elastic_dp_torch")
    keys = ("joins", "leaves", "renewals", "data_less", "max_staleness")
    small = ex.model_config()
    p_cpu = init_params(small, torch.Generator().manual_seed(SEED),
                        torch.float32)
    p_card = _cast(p_cpu, device="cuda")      # before the CPU run steps
    cpu = ex.run(small, p_cpu, "cpu")
    reset_launch_counts()
    card = ex.run(small, p_card, "cuda")
    counts = {k: n for k, n in launch_counts().items() if n}
    a, b = (torch.tensor(x.losses, dtype=torch.float64) for x in (card, cpu))
    rel = float(((a - b).abs() / b.abs()).max())
    log(f"elastic example, its reduced config (d_model {small.d_model}, "
        f"{small.n_layers} layers, vocab {small.vocab}) on {smi} against the "
        f"CPU from the same weights: {len(card.losses)} worker steps, worst "
        f"relative loss difference {rel:.3g} (limit 2e-4); loss "
        f"{card.losses[0]:.6f} -> {card.losses[-1]:.6f} (CPU "
        f"{cpu.losses[0]:.6f} -> {cpu.losses[-1]:.6f}); launches {counts}")
    assert dataclasses.asdict(card) | {"losses": None} == \
        dataclasses.asdict(cpu) | {"losses": None}, (card, cpu)
    torch.testing.assert_close(a, b, rtol=2e-4, atol=0)
    missing = [k for k in TRAIN_KERNELS if k not in counts]
    assert not missing, f"kernels never launched (reduced): {missing}"
    want = {k: getattr(cpu, k) for k in keys}
    del p_cpu, p_card, card
    cfg = get_arch("tinyllama-1.1b")
    for lr in (3e-3, 3e-4):
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            SEED), torch.float32)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        rep = ex.run(cfg, params, "cuda", lr=lr)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: n for k, n in launch_counts().items() if n}
        got = {k: getattr(rep, k) for k in keys}
        log(f"elastic example on {smi}: tinyllama-1.1b full width and depth "
            f"(fp32), lr {lr:g}, {rep.steps} steps, {len(rep.losses)} worker "
            f"steps in {dt:.2f} s; losses by step "
            + " ".join(f"{x:.4f}" for x in rep.losses)
            + f"; {got} (the reduced run: {want}); max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
            f"{counts} ({len(rep.losses)} gradients)")
        assert got == want, f"elastic counters card {got} != cpu {want}"
        assert all(math.isfinite(x) for x in rep.losses)
        missing = [k for k in TRAIN_KERNELS if k not in counts]
        assert not missing, f"kernels never launched by the example: {missing}"
        if lr == 3e-3:
            ex.print_report(rep)
        del rep, params
        gc.collect()
        torch.cuda.empty_cache()


# ``train_ft_lm_torch --full`` on the card runs this many of its 200 steps
# (``--steps``), so that the script keeps within its time limit
TRAIN_EXAMPLE_STEPS = 60


def phase3_training_example(smi):
    """``examples/train_ft_lm_torch.py --full --steps 60`` on the card (8
    layers, d_model 768, ``TRAIN_EXAMPLE_STEPS`` steps of 8 x 256 tokens,
    int8 gradient compression, 2 microbatches, a crash at step 30, a
    checkpoint every 10 steps): one restart, the last step reached, the loss lowered; ms a step and
    tokens/s over the run's steps (replays included; the checkpoints'
    writes and the restore inside the time); K6 / K10 and K8 / K11
    launched (counts set to 0 before the run, read after)."""
    import tempfile
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    ex = _example("train_ft_lm_torch")
    cfg, steps, batch, seq = ex.model_config(full=True,
                                             steps=TRAIN_EXAMPLE_STEPS)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), torch.float32)
    reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="tardis_ckpt_") as d:
        out, stragglers, dt = ex.run(cfg, params,
                                     ex.train_config(steps, batch, seq, d),
                                     "cuda")
    counts = {k: n for k, n in launch_counts().items() if n}
    n = len(out["losses"])
    log(f"training example --full --steps {steps} on {smi}: {steps} steps "
        f"of {batch} x "
        f"{seq} tokens, {out['restarts']} restart(s), final step "
        f"{out['final_step']}, {n} steps run in {dt:.2f} s = "
        f"{dt / n * 1e3:.3f} ms a step, {n * batch * seq / dt:.1f} tokens/s; "
        f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}; "
        f"{len(stragglers)} straggler steps; launches {counts}")
    assert out["restarts"] == 1 and out["final_step"] == steps
    missing = [k for k in TRAIN_KERNELS if k not in counts]
    assert not missing, f"kernels never launched by the example: {missing}"
    assert out["losses"][-1] < out["losses"][0], "did not learn"
    del out, params
    torch.cuda.empty_cache()


# check.sh's CLI smokes on the card: (argv, sanitize, the patterns its
# grep -Eq finds in the printed report)
CLI_SMOKES = (
    ("moe", ["--arch", "kimi-k2-1t-a32b", "--replicas", "2", "--requests",
             "6", "--max-new", "2", "--max-batch", "2"], False,
     (r"pool_tokens_appended_dense +[1-9]",
      r"pool_tokens_appended_moe +[1-9]")),
    ("2-host", ["--arch", "tinyllama-1.1b", "--hosts", "2", "--replicas",
                "1", "--requests", "6", "--max-new", "2", "--prefix-len",
                "16", "--prefix-block", "4", "--decode-pages", "64",
                "--max-pages", "16", "--max-batch", "2"], True,
     (r"host1_prefix_prefill_tokens_skipped +[1-9]",
      r"host1_xhost_pages_fetched +[1-9]", r"xhost_multicasts +0",
      r"xhost_invalidation_msgs +0")),
    ("prefill/decode", ["--arch", "tinyllama-1.1b", "--roles",
                        "prefill,decode", "--replicas", "1", "--requests",
                        "6", "--max-new", "2", "--prefix-len", "16",
                        "--prefix-block", "4", "--decode-pages", "64",
                        "--max-pages", "16", "--max-batch", "2"], True,
     (r"host1_role_cold_prefills +0", r"host0_role_prefill_jobs +[1-9]",
      r"host1_prefix_prefill_tokens_skipped +[1-9]",
      r"xhost_notifies +[1-9]", r"xhost_multicasts +0")),
)


def phase3_cli_smokes(smi):
    """``scripts/check.sh``'s CLI smokes through the port's entry points:
    the one-cell dry run (``launch.dryrun.main``: an ok cell, flops_total >
    0) and the moe, 2-host and prefill/decode serves on the card
    (``launch.serve.main`` without ``--device``), each with check.sh's
    argv and its assertions on the printed report."""
    import io
    import re
    import tempfile
    from repro_torch.launch import dryrun, serve
    with tempfile.TemporaryDirectory() as d:
        out = str(Path(d) / "dry.json")
        assert dryrun.main(["--mesh", "single", "--archs", "tinyllama-1.1b",
                            "--shapes", "decode_32k", "--no-hlo", "--out",
                            out]) == 0
        recs = json.loads(Path(out).read_text())
    ok = [r for r in recs if r["status"] == "ok"]
    assert ok and any(r.get("flops_total", 0) > 0 for r in ok), recs
    log(f"dry-run smoke: {len(ok)} ok cell(s), flops_total "
        f"{ok[0]['flops_total']:.4g}")
    for name, argv, sanitize, patterns in CLI_SMOKES:
        buf = io.StringIO()
        with patch.dict(os.environ,
                        {"TARDIS_SANITIZE": "1" if sanitize else "0"}), \
                contextlib.redirect_stdout(buf):
            done, report = serve.main(argv)
        text = buf.getvalue()
        missing = [p for p in patterns if not re.search(p, text)]
        assert not missing, f"{name} serve smoke: {missing}\n{text}"
        assert all(r.done for r in done)
        log(f"{name} serve smoke on {smi}: {text.splitlines()[0]}; "
            + ", ".join(" ".join(re.search(p, text).group(0).split())
                        for p in patterns))



# The training path: ``runtime.train`` on full-width, full-depth
# tinyllama-1.1b in fp32 (as the JAX launcher initialises it), 4 steps of
# 4 x 1024 tokens, no checkpoint.  Forward: K6 once and K8 45 times a step
# (1 plain + 44 add); backward: K10 and K11 as many times.
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 1024
TRAIN_KERNELS = ("flash_prefill", "flash_backward", "rmsnorm",
                 "rmsnorm_backward")


def _train_batch(cfg, step, b, s, dev):
    from repro_torch.data import batch_to, synthetic_batch
    return batch_to(synthetic_batch(SEED, step, b, s, cfg.vocab), dev)


def phase3_train_path(smi):
    """``runtime.train`` on the card at full width and depth, the earlier
    paths' weights freed first: the launch counts set to 0 just before the
    run and read just after (K6, K10, K8, K11; per step 22 / 22 / 45 / 45,
    K8 and K11 1 plain + 44 add); ms a step, tokens/s and the peak memory;
    every parameter leaf's gradient finite and non-zero; one warm step under
    ``torch.profiler`` (idle share, device ms by kind and kernel).  Returns
    (launch counts, launches by variant)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.models import init_params, loss_fn, param_leaves
    from repro_torch.optim import adamw
    from repro_torch.runtime import TrainConfig, build_step, train
    from repro_torch.tree import leaves, value_and_grad
    from torch.profiler import ProfilerActivity, profile
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(TRAIN_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, torch.float32)
    n_par = sum(t.numel() for t in param_leaves(params))
    tc = TrainConfig(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     seed=SEED, log_every=1)
    step_s = []
    reset_launch_counts()
    out = train(cfg, params, tc, device="cuda",
                on_metrics=lambda st, m: step_s.append(m["step_s"]))
    counts = launch_counts()
    variants = variant_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = out["losses"]
    assert out["final_step"] == TRAIN_STEPS and out["restarts"] == 0
    assert all(map(math.isfinite, losses)), losses
    toks = TRAIN_BATCH * TRAIN_SEQ
    warm = step_s[1:]
    log(f"training path on {smi}: {TRAIN_ARCH} full width and depth "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, {n_par / 1e9:.3f} B "
        f"fp32 params), {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens: losses {losses}; ms a step "
        f"{[round(t * 1e3, 3) for t in step_s]} (first step cold); warm "
        f"{sum(warm) / len(warm) * 1e3:.3f} ms a step = "
        f"{toks * len(warm) / sum(warm):.1f} tokens/s; max_memory_allocated "
        f"{peak:.2f} GB")
    log(f"launches on the training path: {counts}")
    log(f"launches by variant on the training path: {variants}")
    want = {"flash_prefill": cfg.n_layers, "flash_backward": cfg.n_layers,
            "rmsnorm": 2 * cfg.n_layers + 1,
            "rmsnorm_backward": 2 * cfg.n_layers + 1}
    for k in TRAIN_KERNELS:
        assert counts[k] == TRAIN_STEPS * want[k], \
            f"{k}: {counts[k]} launches in {TRAIN_STEPS} steps, want " \
            f"{want[k]} a step"
    for k in ("rmsnorm", "rmsnorm_backward"):
        assert variants[k] == {"plain": TRAIN_STEPS,
                               "add": TRAIN_STEPS * 2 * cfg.n_layers}, \
            f"{k} by variant: {variants[k]}"
    assert variants["flash_backward"] == {
        "tf32x3": TRAIN_STEPS * cfg.n_layers}, variants["flash_backward"]
    # K6's fp32 forward on its tensor-core variant: 22 launches a step
    assert variants["flash_prefill"] == {
        "tf32x3": TRAIN_STEPS * cfg.n_layers}, variants["flash_prefill"]
    params, opt_state = out["params"], out["opt_state"]
    del out, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    # every leaf's gradient finite and non-zero
    batch = _train_batch(cfg, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, "cuda")
    loss, grads = value_and_grad(lambda p, b: loss_fn(cfg, p, b), params,
                                 batch)
    bad = [i for i, gr in enumerate(leaves(grads))
           if not bool(torch.isfinite(gr).all()) or not bool(gr.any())]
    assert not bad, f"parameter leaves with a zero or non-finite " \
        f"gradient: {bad}"
    log(f"gradients on {smi}: all {len(leaves(grads))} parameter leaves "
        f"finite and non-zero (loss {float(loss):.6f})")
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    # one warm step under the profiler
    step_fn = build_step(cfg, tc)
    opt_state = adamw.init(params)

    def one_step():
        nonlocal params, opt_state
        params, opt_state, _r, m = step_fn(params, opt_state, None, batch)
        return float(m["loss"])

    one_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step()
        wall = time.perf_counter() - t0
    busy, kinds, dev_rows = _profile_kinds(prof)
    log(f"profile: training step on {smi}: wall {wall:.3f} s under the "
        f"profiler, device busy {busy:.3f} s, idle share "
        f"{1 - busy / wall:.3f}; device ms by kind " + json.dumps(kinds))
    for e in sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  device {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    del params, opt_state, batch, step_fn, prof
    gc.collect()
    torch.cuda.empty_cache()
    return counts, variants


# Phase 4 of the training path: the card against the CPU at full width and
# 2 layers, one batch of 2 x 256 tokens.  The loss within rtol 1e-5 and
# each gradient leaf within 1e-4 of the leaf's largest magnitude: fp32 on
# both (no TF32), sums in two orders.  The parameters after 2 AdamW steps
# within 2 x the summed learning rates (plus 1e-6 of each value): AdamW's
# normalized step is at most about lr an element, so an element whose
# gradient is at rounding level on both devices may take it with either
# sign.
TRAIN_P4_LAYERS, TRAIN_P4_BATCH, TRAIN_P4_SEQ = 2, 2, 256
TRAIN_P4_LOSS = dict(rtol=1e-5, atol=0)
TRAIN_P4_GRAD_REL = 1e-4
# the crash-and-restart check: a cut width (4 layers of 256, 4 / 2 heads
# of 64, vocab 1024), compression and 2 microbatches, a crash at step 17
# of 30 with checkpoints every 10; every step's loss within rtol 1e-3 of
# an uninterrupted run's.  The error-feedback residual is not
# checkpointed: it carries over the crash, as in the JAX package, so the
# steps after the first replayed one see another residual; a replay from
# a wrong state or batch moves the loss by ~1e-2 (it falls ~0.05 a step).
CRASH_CFG = dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                 d_head=64, d_ff=512, vocab=1024)
CRASH_LOSS = dict(rtol=1e-3, atol=0)


def phase4_train_card_vs_cpu(smi):
    """The training path on the card against the CPU (the plain versions,
    by ``device="cpu"``); a crash and restart on the card against an
    uninterrupted run."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import adamw
    from repro_torch.runtime import TrainConfig, build_step, train
    from repro_torch.tree import leaves, tree_map, value_and_grad
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH),
                              n_layers=TRAIN_P4_LAYERS)
    params = init_params(cfg, torch.Generator().manual_seed(SEED + 20),
                         torch.float32)
    batch = _train_batch(cfg, 0, TRAIN_P4_BATCH, TRAIN_P4_SEQ, "cpu")
    tc = TrainConfig(steps=TRAIN_STEPS, batch=TRAIN_P4_BATCH,
                     seq=TRAIN_P4_SEQ)
    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, grads = value_and_grad(lambda pp, bb: loss_fn(cfg, pp, bb), p,
                                     b)
        step_fn, st = build_step(cfg, tc), adamw.init(p)
        lrs = []
        for _ in range(2):
            p, st, _r, m = step_fn(p, st, None, b)
            lrs.append(float(m["lr"]))
        res[dev] = (float(loss), [gr.cpu() for gr in leaves(grads)],
                    [t.cpu() for t in leaves(p)], lrs)
        log(f"phase 4 training lane on {dev}: loss {float(loss):.7f}, "
            f"2 AdamW steps in {time.perf_counter() - t0:.1f} s")
        del p, b, grads, st, step_fn
    torch.cuda.empty_cache()
    (lc, gc_, pc, lrs), (lh, gh, ph, _) = res["cuda"], res["cpu"]
    assert math.isclose(lc, lh, rel_tol=TRAIN_P4_LOSS["rtol"]), (lc, lh)
    g_worst = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
                  for a, b in zip(gc_, gh))
    assert g_worst <= TRAIN_P4_GRAD_REL, g_worst
    step_bound = 2 * sum(lrs)
    p_worst, n_moved = 0.0, 0
    for a, b in zip(pc, ph):
        d = (a - b).abs()
        assert bool((d <= step_bound + 1e-6 * b.abs()).all()), \
            float(d.max())
        p_worst = max(p_worst, float(d.max()))
        n_moved += int((d > 1e-6 * b.abs() + 1e-9).sum())
    n_el = sum(t.numel() for t in ph)
    log(f"phase 4 training lane (full width, {cfg.n_layers} layers, "
        f"{TRAIN_P4_BATCH} x {TRAIN_P4_SEQ} tokens) on {smi}: loss card "
        f"{lc:.7f} cpu {lh:.7f} (rel {abs(lc - lh) / abs(lh):.2e}); worst "
        f"gradient leaf error / its max {g_worst:.2e} (limit "
        f"{TRAIN_P4_GRAD_REL}); params after 2 AdamW steps: max |diff| "
        f"{p_worst:.3e} (limit {step_bound:.3e} = 2 x the summed lr), "
        f"{n_moved} of {n_el} elements beyond 1e-6 relative")
    del res, params, batch

    # crash and restart on the card
    ccfg = reduced(get_arch(TRAIN_ARCH), **CRASH_CFG)
    cparams = init_params(ccfg, torch.Generator().manual_seed(SEED),
                          torch.float32)
    kw = dict(steps=30, ckpt_every=10, batch=4, seq=128,
              grad_compression=True, n_micro=2)
    runs = {}
    scratch = ROOT / "build" / "ckpt"
    scratch.mkdir(parents=True, exist_ok=True)
    for fail in (17, -1):
        with tempfile.TemporaryDirectory(dir=scratch) as d:
            runs[fail] = train(ccfg, cparams, TrainConfig(
                ckpt_dir=d, fail_at_step=fail, **kw), device="cuda")
    crashed, clean = runs[17], runs[-1]
    assert crashed["restarts"] == 1 and crashed["final_step"] == 30
    assert clean["restarts"] == 0 and len(clean["losses"]) == 30
    assert len(crashed["losses"]) == 37
    assert crashed["losses"][-1] < crashed["losses"][0]
    before, after = crashed["losses"][:17], crashed["losses"][17:]
    np.testing.assert_allclose(before, clean["losses"][:17], **CRASH_LOSS)
    np.testing.assert_allclose(after, clean["losses"][10:], **CRASH_LOSS)
    same_before = sum(a == b for a, b in zip(before, clean["losses"][:17]))
    same_after = sum(a == b for a, b in zip(after, clean["losses"][10:]))
    worst = max(abs(a - b) / abs(b) for a, b in
                zip(crashed["losses"], clean["losses"][:17]
                    + clean["losses"][10:]))
    log(f"crash and restart on {smi} (layers {ccfg.n_layers}, d_model "
        f"{ccfg.d_model}, compression, n_micro 2, crash at step 17 of 30, "
        f"restored from step 10): restarts {crashed['restarts']}, final "
        f"step {crashed['final_step']}, loss {crashed['losses'][0]:.4f} -> "
        f"{crashed['losses'][-1]:.4f}; against the uninterrupted run: "
        f"{same_before} of 17 steps before the crash and {same_after} of 20 "
        f"replayed and later steps bit-identical, worst relative difference "
        f"{worst:.2e} (limit {CRASH_LOSS['rtol']}); the first replayed "
        f"step {'equals' if after[0] == clean['losses'][10] else 'differs from'}"
        f" the uninterrupted step 10 bit for bit")
    del runs, crashed, clean, cparams

    torch.cuda.empty_cache()


# Phase 4's bf16 check (``norm_check``): at every teacher-forced step the
# card's logits may lie at most NORM_FACTOR times as far (L2 over all rows)
# from an fp32 anchor as the plain bf16 path's on the CPU, plus
# NORM_FLOOR of the anchor's norm.  Both are fixed by that principle (the
# card's kernels round at most twice as far from fp32 as the plain bf16
# path does), not fitted to readings.
NORM_FACTOR = 2.0
NORM_FLOOR = 1e-3
PHASE4_STEPS = 4        # teacher-forced decode steps after the prefill
# the wrapper-level off-by-ones of ``--phase4-mutants`` and the bf16 lanes
# whose path calls each wrapper
MUTANTS = {"K6 q_offset+1": ("paged", "wave", "kimi"),
           "K4 lengths-1": ("paged", "kimi"),
           "K5 kv_len-1": ("wave",),
           "K8 weight rolled": ("paged", "wave", "kimi"),
           "K7 cum shifted": ("zamba2",),
           "K8 add drops r": ("paged", "wave", "zamba2", "kimi"),
           "K8 gate z one column off": ("zamba2",)}


def _hold_logits(label, pre_c, tok_g, tok_c, step_g, step_c, hold=True):
    """Card vs CPU logits of the requests in the first decode step of a
    serving run: ``pre_c`` their prefill logits on the CPU (R, V),
    ``tok_*`` the token each device fed them (its argmax of its prefill
    rows) and ``step_*`` that step's logits (R, V).  Held (``hold``; the
    zamba2 fp32 lane): every first token the same on both devices and
    every row within the bf16 tolerance.  Returns (the max |err| and the
    worst |err| / (atol + rtol |v|) over the rows both devices fed the
    same token, the number of rows whose first token differs, whether each
    such row sat at a tie -- the CPU's prefill logits of the two tokens
    within one bf16 rounding step of the top one).  The last is only a
    reading: the retired bf16 check exempted one such row; with the bf16
    lanes teacher-forced no held lane needs it."""
    import numpy as np
    same = tok_g == tok_c
    flips = int((~same).sum())
    ties = all(pre_c[i, tok_c[i]] - pre_c[i, tok_g[i]]
               <= 2 ** -7 * abs(pre_c[i, tok_c[i]])
               for i in np.flatnonzero(~same))
    assert not hold or flips == 0, (
        f"{label}: {flips} first tokens differ card vs cpu")
    if hold:
        np.testing.assert_allclose(step_g, step_c, **BF16,
                                   err_msg=f"{label}: first-step logits")
    if not same.any():
        return 0.0, 0.0, flips, ties
    d = np.abs(step_g[same] - step_c[same])
    lim = BF16["atol"] + BF16["rtol"] * np.abs(step_c[same])
    return float(d.max()), float((d / lim).max()), flips, ties


def _wave_logits(tg, tc):
    """The wave path's traces: the first wave's prefill rows on the CPU,
    the tokens each device fed its first decode step, that step's rows
    (the ``_hold_logits`` arguments), and every wave's prefill error."""
    import numpy as np
    pg = [e for e in tg if e["ev"] == "wave_prefill"]
    pc = [e for e in tc if e["ev"] == "wave_prefill"]
    assert [e["rids"] for e in pg] == [e["rids"] for e in pc]
    sg = next(e for e in tg if e["ev"] == "wave_step"
              and e["rids"] == pg[0]["rids"])
    sc = next(e for e in tc if e["ev"] == "wave_step"
              and e["rids"] == pc[0]["rids"])
    first_g, first_c = pg[0]["logits"][:, -1], pc[0]["logits"][:, -1]
    every = max(float(np.abs(a["logits"] - b["logits"]).max())
                for a, b in zip(pg, pc))
    return (first_c, first_g.argmax(-1), first_c.argmax(-1),
            sg["logits"][:, -1], sc["logits"][:, -1]), every


def _memo(memo, key, fn):
    """``fn()``, computed once per ``key`` where a ``memo`` dict is given
    (the CPU runs of one seed, shared by ``--phase4-mutants``' runs)."""
    if memo is None:
        return fn()
    if key not in memo:
        memo[key] = fn()
    return memo[key]


def _counters(rg, rc):
    """The integer coherence counters of two reports, and those that
    differ as {name: (card, cpu)}."""
    import numpy as np
    ints = [k for k, v in rg.items() if isinstance(v, (int, np.integer))
            and not isinstance(v, bool)]
    return ints, {k: (rg[k], rc[k]) for k in ints if rg[k] != rc[k]}


def _tf_paged(cfg, params, dev, reqs, fed=None, n_steps=PHASE4_STEPS,
              chunk=16, n_sys=64):
    """The paged lane, teacher-forced through the port's entry points over
    a pool laid out as the serving run lays it out: the shared system
    prompt's KV (``prefill``) in ``n_sys // chunk`` shared blocks, each
    request's suffix prefilled against it (``prefill_suffix``: K6 at
    q_offset ``n_sys``) into its own pages, then ``n_steps`` batched
    ``decode_step_paged`` steps (K4, K3's scatter) fed ``fed`` (R,
    n_steps) -- or, with ``fed=None``, each step's argmax.  Pool and
    caches in the weights' dtype.  Returns ([(R, V) logits of the prefill,
    then of each step], the fed tokens)."""
    import numpy as np
    import torch
    from repro_torch.kernels.tardis_lease.kernel import LANES
    from repro_torch.models import (decode_step_paged, pool_layout, prefill,
                                    prefill_suffix)
    dtype = params["embed"].dtype
    stacks = pool_layout(cfg)
    row = -(-(stacks[-1].offset + stacks[-1].token_elems) // LANES) * LANES

    def token_rows(cache, lo, hi):      # ServingCluster._cache_token_rows
        m = hi - lo
        out = torch.zeros((m, row), dtype=dtype, device=dev)
        for spec in stacks:             # each stack's segment at its offset
            kv = [cache[c][:, 0, lo:hi].permute(1, 0, 2, 3).reshape(m, -1)
                  for c in spec.cache_keys]
            out[:, spec.offset:spec.offset + spec.token_elems] = torch.cat(
                kv, 1)
        return out

    plens = np.asarray([len(r.prompt) for r in reqs], np.int32)
    n_shared = n_sys // chunk
    n_pages = -(-(plens + n_steps) // chunk)
    pool = torch.zeros(((n_shared + int((n_pages - n_shared).sum()))
                        * chunk, row), dtype=dtype, device=dev)
    system = reqs[0].prompt[:n_sys]
    pre, _ = prefill(cfg, params, {"tokens": torch.as_tensor(
        system[None], device=dev)}, n_sys, dtype=dtype)
    pool[:n_sys] = token_rows(pre, 0, n_sys)    # blocks 0 .. n_shared - 1
    page_rows = np.zeros((len(reqs), 32), np.int32)
    free = n_shared
    steps = [[]]
    for i, (r, plen) in enumerate(zip(reqs, plens)):
        assert np.array_equal(r.prompt[:n_sys], system)
        page_rows[i, :n_shared] = np.arange(n_shared)
        page_rows[i, n_shared:n_pages[i]] = np.arange(
            free, free + n_pages[i] - n_shared)
        free += n_pages[i] - n_shared
        cache_len = -(-plen // chunk) * chunk
        toks = np.pad(r.prompt[n_sys:], (0, cache_len - plen))
        cache = {c: torch.zeros((spec.n_layers, 1, cache_len) + tuple(
            pre[c].shape[3:]), dtype=dtype, device=dev)
            for spec in stacks for c in spec.cache_keys}
        for c in cache:
            cache[c][:, :, :n_sys] = pre[c]
        cache, lg = prefill_suffix(
            cfg, params, {"tokens": torch.as_tensor(toks[None], device=dev)},
            cache, n_sys, last_idx=plen - n_sys - 1)
        pos = np.arange(n_sys, plen)
        idx = page_rows[i, pos // chunk].astype(np.int64) * chunk + pos % chunk
        pool[torch.as_tensor(idx, device=dev)] = token_rows(cache, n_sys, plen)
        steps[0].append(lg[0, -1].float().cpu().numpy())
    steps[0] = np.stack(steps[0])
    fed_out = np.zeros((len(reqs), n_steps), np.int32)
    pr = torch.as_tensor(page_rows, device=dev)
    for j in range(n_steps):
        fed_out[:, j] = steps[-1].argmax(-1) if fed is None else fed[:, j]
        pool, lg = decode_step_paged(
            cfg, params, pool, pr, torch.as_tensor(plens + j, device=dev),
            torch.as_tensor(fed_out[:, j:j + 1], device=dev), chunk=chunk)
        steps.append(lg[:, -1].float().cpu().numpy())
    return steps, fed_out


def _tf_wave(cfg, params, dev, reqs, fed=None, n_steps=PHASE4_STEPS,
             cache_len=2048, wave=4):
    """The wave lane, teacher-forced through ``prefill`` (K6, K8) and
    ``decode_step`` (K5 at a 2048-slot cache) as ``DecodeReplica.serve``
    drives them: waves of ``wave`` requests right-padded to their longest
    prompt, decoding in lockstep at a device-scalar position, fed ``fed``
    (R, n_steps) -- or, with ``fed=None``, each step's argmax.  Caches in
    the weights' dtype.  Returns ([(R, V) logits of the prefill's last
    position, then of each step], the fed tokens)."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step, prefill
    dtype = params["embed"].dtype
    steps = [[] for _ in range(n_steps + 1)]
    fed_out = np.zeros((len(reqs), n_steps), np.int32)
    for w0 in range(0, len(reqs), wave):
        ws = reqs[w0:w0 + wave]
        s = max(len(r.prompt) for r in ws)
        toks = np.zeros((len(ws), s), np.int32)
        for i, r in enumerate(ws):
            toks[i, :len(r.prompt)] = r.prompt
        cache, lg = prefill(cfg, params, {"tokens": torch.as_tensor(
            toks, device=dev)}, cache_len, dtype=dtype)
        steps[0].append(lg[:, -1].float().cpu().numpy())
        cur = torch.tensor(s, dtype=torch.int32, device=dev)
        for j in range(n_steps):
            rows = slice(w0, w0 + len(ws))
            fed_out[rows, j] = (steps[j][-1].argmax(-1) if fed is None
                                else fed[rows, j])
            cache, lg = decode_step(cfg, params, cache, torch.as_tensor(
                fed_out[rows, j:j + 1], device=dev), cur)
            steps[j + 1].append(lg[:, -1].float().cpu().numpy())
            cur = cur + 1
    return [np.concatenate(s) for s in steps], fed_out


def norm_check(card, cpu, anchor, factor=NORM_FACTOR, floor=NORM_FLOOR):
    """Phase 4's bf16 check over the steps of three teacher-forced runs
    ((R, V) logits each): at every step ``e_card = |card - anchor|_2 <=
    factor * e_cpu + floor * |anchor|_2`` with ``e_cpu = |cpu - anchor|_2``.
    Returns (whether every step holds, the readings of each step)."""
    import numpy as np
    steps = []
    for c, p, a in zip(card, cpu, anchor):
        a = a.astype(np.float64)
        e_card = float(np.linalg.norm(c - a))
        e_cpu = float(np.linalg.norm(p - a))
        limit = factor * e_cpu + floor * float(np.linalg.norm(a))
        steps.append(dict(e_card=e_card, e_cpu=e_cpu, limit=limit,
                          ok=e_card <= limit))
    return all(s["ok"] for s in steps), steps


def _teacher_forced(label, lane, cfg, params_bf16, reqs, card, hold, memo,
                    key):
    """Phase 4's check of a bf16 lane (``lane``: "paged" or "wave"):
    three teacher-forced runs -- the card in bf16 with its kernels, the
    CPU in bf16 with the plain versions, and the anchor, the same weights
    widened to fp32 on the CPU, whose greedy tokens the other two are fed
    -- held to ``norm_check`` (``hold``) and printed.  Returns the
    readings."""
    import torch
    run = _tf_paged if lane == "paged" else _tf_wave
    anchor, fed = _memo(memo, key + ("anchor",), lambda: run(
        cfg, _cast(params_bf16, torch.float32), "cpu", reqs))
    cpu, _ = _memo(memo, key + ("cpu",), lambda: run(
        cfg, params_bf16, "cpu", reqs, fed))
    got, _ = run(cfg, _cast(params_bf16, device=card), card, reqs, fed)
    ok, steps = norm_check(got, cpu, anchor)
    ratio = max(s["e_card"] / max(s["e_cpu"], 1e-30) for s in steps)
    worst = max(s["e_card"] / s["limit"] for s in steps)
    log(f"{label}: teacher-forced (prefill + {len(steps) - 1} steps, "
        f"{len(reqs)} rows): e_card / e_cpu per step "
        + ", ".join(f"{s['e_card']:.4g}/{s['e_cpu']:.4g}" for s in steps)
        + f"; worst e_card / e_cpu {ratio:.3f}, worst e_card / limit "
        f"{worst:.3f} (limit {NORM_FACTOR:g} e_cpu + {NORM_FLOOR:g} "
        f"|anchor|): {'holds' if ok else 'FAILS'}")
    if hold:
        assert ok, f"{label}: the card's logits lie more than " \
            f"{NORM_FACTOR:g}x as far from the fp32 anchor as the CPU's: " \
            f"{steps}"
    return dict(new_ok=ok, new_ratio=ratio, new_worst=worst)


def _phase4_params(cfg, seed):
    """Phase 4's weights: drawn in bf16 on the CPU from ``seed``, with the
    norms' weights (ones at init) drawn too, as 1 + N(0, 0.1^2), so that a
    fault in how K8 reads its weight changes the logits."""
    import torch
    from repro_torch.models import init_params
    gen = torch.Generator(device="cpu").manual_seed(seed)
    params = init_params(cfg, gen, torch.bfloat16)

    def draw(tree):
        for k, v in (tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
            if isinstance(v, (dict, list)):
                draw(v)
            elif str(k).endswith(("norm", "norm_w")):
                tree[k] = (1 + 0.1 * torch.randn(v.shape, generator=gen)
                           ).to(v.dtype)
    draw(params)
    return params


def phase4_card_vs_cpu(smi, seed=SEED, hold=True, memo=None, card="cuda",
                       cfg=None, lane="paged"):
    """A paged lane, bf16 weights: ``lane`` "paged" -- tinyllama, full
    width at 2 layers (or ``cfg``) -- or "kimi" -- kimi-k2 at its
    attention's full width, cut as ``kimi_phase4_config`` says (or
    ``cfg``).
    A serving run on the card and one on the CPU (the plain versions, by
    the explicit device="cpu"): identical integer coherence counters
    (held), greedy agreement and the retired check's reading -- the first
    tick's worst |err| / (3e-2 + 3e-2 |cpu|) -- printed.  Then the
    teacher-forced norm check (``_teacher_forced``), held.  ``hold=False``
    only measures; ``memo`` keeps a seed's CPU runs.  Returns the
    readings, ``old_ok`` the retired check's verdict."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.runtime import Request
    if cfg is None:
        cfg = (kimi_phase4_config() if lane == "kimi" else
               dataclasses.replace(get_arch("tinyllama-1.1b"), n_layers=2))
    params = _phase4_params(cfg, seed)

    def serve(dev):
        cluster, done, report, dt = _serve(cfg, _cast(params, device=dev),
                                           dev, 256, 128, trace=True,
                                           seed=seed)
        return done, report, cluster.trace, dt

    dg, rg, tg, sg = serve(card)
    dc, rc, tc, sc = _memo(memo, (lane + " serve", seed),
                           lambda: serve("cpu"))
    ints, bad = _counters(rg, rc)
    assert not hold or not bad, f"coherence counters differ card vs cpu: {bad}"
    first_g = next(e for e in tg if e["ev"] == "tick")
    first_c = next(e for e in tc if e["ev"] == "tick")
    d = np.abs(first_g["logits"] - first_c["logits"])
    ratio = float((d / (BF16["atol"] + BF16["rtol"]
                        * np.abs(first_c["logits"]))).max())
    # each admission's prefill logits by request (printed)
    ag = {e["rid"]: e["logits"] for e in tg if e["ev"] == "admit"}
    ac = {e["rid"]: e["logits"] for e in tc if e["ev"] == "admit"}
    every = max(float(np.abs(ag[r] - ac[r]).max()) for r in ag)
    same = sum(int(a == b) for x, y in zip(dg, dc)
               for a, b in zip(x.output, y.output))
    total = sum(len(x.output) for x in dg)
    label = (f"card vs cpu ({smi}; seed {seed}; "
             + ("full width, 2 layers)" if lane == "paged" else
                f"kimi-k2: d_model {cfg.d_model}, Dh {cfg.head_dim()}, G "
                f"{cfg.n_heads // cfg.n_kv_heads}, {cfg.n_layers} layers, "
                f"vocab {cfg.vocab}, {cfg.n_experts} experts top-"
                f"{cfg.top_k})"))
    log(f"{label}: {len(ints) - len(bad)} of {len(ints)} integer counters "
        f"identical; retired check: first-tick logits max |err| "
        f"{float(d.max()):.4g} (worst {ratio:.3f} of 3e-2 + 3e-2 |v|; "
        f"printed); prefill logits max |err| {every:.4g} (printed); greedy "
        f"tokens agree {same}/{total}; card {sg:.2f} s, cpu {sc:.2f} s")
    reqs = _requests(Request, np, cfg.vocab, seed=seed)
    new = _teacher_forced(label, "paged", cfg, params, reqs, card, hold,
                          memo, (lane, seed))
    return dict(old_ratio=ratio, old_ok=not bad and ratio <= 1, **new)


def decoder_phase4_config(arch):
    """Phase 4's lane of a decoder configuration: its attention geometry
    (heads, kv heads, Dh), RoPE / M-RoPE settings and d_model kept; depth
    cut to 2, vocab to 32000, every MLP width (d_ff; arctic's experts' and
    its dense residual's) to 16 and arctic's 128 experts to 16 (top-2
    kept), so that the CPU's fp32 anchor fits beside its bf16 run."""
    cfg = decoder_config(arch, 2)
    cut = dict(vocab=32000, d_ff=16 if cfg.d_ff else 0)
    if cfg.n_experts:
        cut.update(n_experts=16, d_ff_expert=16,
                   residual_ff=16 if cfg.residual_ff else 0)
    return dataclasses.replace(cfg, **cut)


def phase4_decoder_lanes(smi, card="cuda"):
    """One teacher-forced paged lane per decoder configuration
    (``decoder_phase4_config``), bf16 weights from seed 0 (norm weights
    drawn too), the paged traffic: the card against the CPU's bf16 run
    and an fp32 anchor, held to ``norm_check`` (``_teacher_forced``)."""
    import numpy as np
    import torch
    from repro_torch.models import param_leaves
    from repro_torch.runtime import Request
    for arch, _depth in DECODERS:
        t0 = time.perf_counter()
        cfg = decoder_phase4_config(arch)
        params = _phase4_params(cfg, SEED)
        n_par = sum(t.numel() for t in param_leaves(params))
        label = (f"card vs cpu ({smi}; {arch}: d_model {cfg.d_model}, "
                 f"{cfg.n_heads} / {cfg.n_kv_heads} heads, Dh "
                 f"{cfg.head_dim()}, {cfg.n_layers} layers, vocab "
                 f"{cfg.vocab}, d_ff {cfg.d_ff}"
                 + (f", {cfg.n_experts} experts top-{cfg.top_k}, expert / "
                    f"residual d_ff {cfg.d_ff_expert} / {cfg.residual_ff}"
                    if cfg.n_experts else "")
                 + f"; {n_par / 1e9:.3f} B params, fp32 anchor "
                 f"{4 * n_par / 1e9:.2f} GB)")
        _teacher_forced(label, "paged", cfg, params,
                        _requests(Request, np, cfg.vocab), card, True, None,
                        (arch, SEED))
        del params
        gc.collect()
        if card == "cuda":
            torch.cuda.empty_cache()
        log(f"[{arch} lane: {time.perf_counter() - t0:.1f} s]")


def phase4_fleet_card_vs_cpu(smi, seed=SEED, hold=True, card="cuda",
                             cfg=None):
    """Fleet A (``FLEETS``) at full width and 2 layers (or ``cfg``), bf16
    weights, on the card and on the CPU (the plain versions, by the
    explicit device="cpu"): every integer counter of the fleet's
    ``coherence_report`` -- the directory's ``xhost_*`` ledger and each
    ``host{h}_*`` column included -- identical (held); greedy agreement
    and the retired check's ratio over each host's first decode tick
    printed.  Returns the readings."""
    import numpy as np
    from repro_torch.configs import get_arch
    if cfg is None:
        cfg = dataclasses.replace(get_arch("tinyllama-1.1b"), n_layers=2)
    params = _phase4_params(cfg, seed)

    def serve(dev):
        mh, done, report, dt = _serve_fleet(
            cfg, _cast(params, device=dev), dev, "A", 256, 128, trace=True,
            seed=seed)
        return done, report, [h.trace for h in mh.hosts], dt

    dg, rg, tg, sg = serve(card)
    dc, rc, tc, sc = serve("cpu")
    ints, bad = _counters(rg, rc)
    assert not hold or not bad, \
        f"fleet counters differ card vs cpu: {bad}"
    assert not hold or rg["xhost_migrations"] > 0
    ratio = 0.0
    for hg, hc in zip(tg, tc):
        first_g = next(e for e in hg if e["ev"] == "tick")
        first_c = next(e for e in hc if e["ev"] == "tick")
        d = np.abs(first_g["logits"] - first_c["logits"])
        ratio = max(ratio, float((d / (BF16["atol"] + BF16["rtol"]
                                       * np.abs(first_c["logits"]))).max()))
    same = sum(int(a == b) for x, y in zip(dg, dc)
               for a, b in zip(x.output, y.output))
    total = sum(len(x.output) for x in dg)
    log(f"fleet A card vs cpu ({smi}; seed {seed}; full width, "
        f"{cfg.n_layers} layers): {len(ints) - len(bad)} of {len(ints)} "
        f"integer counters identical ({rg['xhost_msgs']} cross-host "
        f"messages, {rg['xhost_migrations']} pages migrated); retired "
        f"check: first-tick logits worst {ratio:.3f} of 3e-2 + 3e-2 |v| "
        f"(printed); greedy tokens agree {same}/{total}; card {sg:.2f} s, "
        f"cpu {sc:.2f} s")
    return dict(counters_ok=not bad, old_ratio=ratio, agree=same,
                tokens=total)


def phase4_wave_card_vs_cpu(smi, seed=SEED, hold=True, memo=None,
                            card="cuda", archs=None, cfgs=None):
    """The wave path on the card and on the CPU: tinyllama at 2 layers
    with bf16 weights and zamba2 at 6 (one group) with fp32 weights, full
    width (or ``cfgs[arch]``), 2048-slot caches (bf16 in both serving
    runs, as the path makes them; K5 on the card, its plain version on the
    CPU), short prompts.  A serving run on each device: identical integer
    counters (held) and the first step's logits (``_hold_logits``): held
    on the zamba2 fp32 lane, printed on the tinyllama bf16 lane, whose
    check is the teacher-forced norm check (``_teacher_forced``); zamba2
    also runs that check in bf16 (the readings it returns are that lane's
    beside the fp32 lane's retired ratio).  zamba2
    runs in fp32 (weights drawn in bf16, then widened) because its bf16
    arithmetic is chaotic: the same weights run in bf16 on the card land
    far from the fp32 logits (printed), so two bf16 runs that round a few
    values differently land ~0.1 apart.  ``hold=False`` only measures;
    ``memo`` keeps a seed's CPU runs.  Returns {arch: readings}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.runtime import Request
    short = dict(lo=24, hi=48, max_new=8, seed=seed)
    out = {}
    for (arch, _depth, kw), n_layers, dtype in zip(
            WAVE_PATHS, (2, 6), (torch.bfloat16, torch.float32)):
        if archs is not None and arch not in archs:
            continue
        cfg = (cfgs or {}).get(arch) or dataclasses.replace(
            get_arch(arch), n_layers=n_layers)
        params_bf16 = _phase4_params(cfg, seed)
        params = _cast(params_bf16, dtype)   # fp32: the same weights

        def serve(dev, cfg=cfg, params=params, kw=kw):
            cluster, done, report, dt = _serve_waves(
                cfg, _cast(params, device=dev), dev, 2048, short, trace=True,
                **kw)
            return done, report, cluster.trace, dt

        dg, rg, tg, sg = serve(card)
        dc, rc, tc, sc = _memo(memo, ("wave serve", arch, seed),
                               lambda serve=serve: serve("cpu"))
        ints, bad = _counters(rg, rc)
        assert not hold or not bad, (
            f"{arch}: coherence counters differ card vs cpu: {bad}")
        first_c = next(e for e in tc if e["ev"] == "wave_step")
        held, every = _wave_logits(tg, tc)
        fp32 = dtype == torch.float32
        err, ratio, flips, ties = _hold_logits(f"{arch} waves", *held,
                                               hold=hold and fp32)
        same = sum(int(a == b) for x, y in zip(dg, dc)
                   for a, b in zip(x.output, y.output))
        total = sum(len(x.output) for x in dg)
        label = (f"wave card vs cpu ({smi}; seed {seed}; {arch} full width, "
                 f"{n_layers} layers, {str(dtype)[6:]} weights, 2048-slot "
                 f"caches)")
        log(f"{label}: {len(ints) - len(bad)} of {len(ints)} integer "
            f"counters identical; first-step logits max |err| {err:.4g} "
            f"(worst {ratio:.3f} of 3e-2 + 3e-2 |v|; "
            f"{'held' if fp32 else 'printed: the retired check'}; {flips} "
            f"first tokens differ{' at a tie' if flips and ties else ''}); "
            f"prefill logits max |err| {every:.4g} (printed); greedy tokens "
            f"agree {same}/{total}; card {sg:.2f} s, cpu {sc:.2f} s")
        res = dict(old_ratio=ratio, old_ok=not bad and ratio <= 1 and (
            flips == 0 or (flips == 1 and ties)))
        if fp32:
            if hold:
                # how far bf16 arithmetic alone moves this model: the same
                # weights in bf16 on the card against the fp32 run on the
                # CPU
                trace = _serve_waves(cfg, _cast(params_bf16, device=card),
                                     card, 2048, short, trace=True,
                                     **kw)[0].trace
                lb = next(e for e in trace
                          if e["ev"] == "wave_step")["logits"]
                log(f"  {arch} with the same weights in bf16 on the card: "
                    f"first-step logits max |err| "
                    f"{np.abs(lb - first_c['logits']).max():.4g} against "
                    f"the fp32 run on the cpu (max |logit| "
                    f"{np.abs(first_c['logits']).max():.4g})")
            # its bf16 lane, teacher-forced: the prefill's K7 on the
            # tensor-core variant (bf16 conv views), K5, K6, K8
            reqs = _wave_requests(Request, np, cfg.vocab, **short)
            res.update(_teacher_forced(
                label.replace("float32 weights", "bfloat16 weights"), "wave",
                cfg, params_bf16, reqs, card, hold, memo,
                ("wave", arch, seed)))
        else:
            reqs = _wave_requests(Request, np, cfg.vocab, **short)
            res.update(_teacher_forced(label, "wave", cfg, params_bf16, reqs,
                                       card, hold, memo, ("wave", seed)))
        out[arch] = res
    return out


def _cast(tree, dtype=None, device=None):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype, device) for v in tree]
    return tree.to(**{k: v for k, v in (("dtype", dtype), ("device", device))
                      if v is not None})


def phase4_seed_sweep(smi, seeds, card="cuda"):
    """Phase 4's readings, measured and not held, for weights and requests
    drawn from each seed (``--phase4-seeds``): the retired max ratio and
    the teacher-forced norm check of each bf16 lane, and the zamba2 fp32
    lane's ratio; one JSON line per seed."""
    for seed in seeds:
        paged = phase4_card_vs_cpu(smi, seed, hold=False, card=card)
        kimi = phase4_card_vs_cpu(smi, seed, hold=False, card=card,
                                  lane="kimi")
        waves = phase4_wave_card_vs_cpu(smi, seed, hold=False, card=card)
        print(json.dumps({"seed": seed, "paged": paged, "kimi": kimi, **{
            f"{k}_wave": v for k, v in waves.items()}}), flush=True)


@contextlib.contextmanager
def inject(name):
    """One wrapper-level off-by-one of ``MUTANTS``, on every device, for
    the ``with`` body: the ops module's reference to the kernel wrapper
    is swapped for one that shifts one argument (no kernel source is
    edited) -- K6 called with q_offset + 1, K4 with lengths - 1, K5 with
    kv_len - 1, K8 with its weight rolled by one column, K7 with the
    within-chunk cumulative decay shifted one position later (cum'_i =
    cum_{i-1}, cum'_0 = cum_0), K8's add variant with r = 0 (h = x: the
    sublayer's output dropped), K8's gate variant reading z one column
    further along its projection row."""
    import torch
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import ops as nops
    from repro_torch.kernels.ssd_scan import ops as sops

    def k6(fn):
        return lambda q, k, v, **kw: fn(q, k, v, **{
            **kw, "q_offset": kw.get("q_offset", 0) + 1})

    def k4(fn):
        return lambda *a, **kw: fn(*a[:5], a[5] - 1, *a[6:], **kw)

    def k5(fn):
        return lambda q, kc, vc, kv_len, **kw: fn(
            q, kc, vc, torch.as_tensor(kv_len) - 1, **kw)

    def k8(fn):
        return lambda x, w, **kw: fn(x, torch.roll(w, 1), **kw)

    def k7(fn):
        return lambda x, dt, cum, B, C, **kw: fn(x, dt, torch.cat(
            [cum[:, :, :1], cum[:, :, :-1]], 2), B, C, **kw)

    def k8_operand(key, change):
        def wrap(fn):
            def call(x, w, **kw):
                if kw.get(key) is not None:
                    kw = {**kw, key: change(kw[key])}
                return fn(x, w, **kw)
            return call
        return wrap

    def one_column_on(z):
        return torch.as_strided(z, z.shape, z.stride(),
                                z.storage_offset() + 1)

    mod, attr, wrap = {"K6 q_offset+1": (fops, "flash_prefill", k6),
                       "K4 lengths-1": (dops, "paged_decode", k4),
                       "K5 kv_len-1": (dops, "dense_decode", k5),
                       "K8 weight rolled": (nops, "rmsnorm_2d", k8),
                       "K7 cum shifted": (sops, "ssd_chunk", k7),
                       "K8 add drops r": (nops, "rmsnorm_2d", k8_operand(
                           "residual", torch.zeros_like)),
                       "K8 gate z one column off": (
                           nops, "rmsnorm_2d", k8_operand(
                               "gate", one_column_on))}[name]
    orig = getattr(mod, attr)
    setattr(mod, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def phase4_mutants(smi, seeds, card="cuda", cfgs=None):
    """``--phase4-mutants``: each bf16 lane of each seed clean, then under
    each of ``MUTANTS`` that its path calls, with both checks' readings
    printed (one JSON line per run); the CPU runs are made once a seed,
    outside any injection.  Returns the injections the retired check
    fails on some seed and the new check on none (the new check must
    catch every fault the old one caught)."""
    cfgs = cfgs or {}

    def lanes(seed, memo, which):
        out = {}
        for lane in ("paged", "kimi"):
            if lane in which:
                out[lane] = phase4_card_vs_cpu(
                    smi, seed, hold=False, memo=memo, card=card,
                    cfg=cfgs.get(lane), lane=lane)
        for lane, arch in (("wave", "tinyllama-1.1b"),
                           ("zamba2", "zamba2-2.7b")):
            if lane in which:
                out[lane] = phase4_wave_card_vs_cpu(
                    smi, seed, hold=False, memo=memo, card=card,
                    archs=(arch,), cfgs={arch: cfgs.get(lane)})[arch]
        return out

    fails = {}
    for seed in seeds:
        memo = {}
        print(json.dumps({"seed": seed, "mutant": None,
                          **lanes(seed, memo, ("paged", "wave", "zamba2",
                                               "kimi"))}), flush=True)
        for name, which in MUTANTS.items():
            with inject(name):
                res = lanes(seed, memo, which)
            print(json.dumps({"seed": seed, "mutant": name, **res}),
                  flush=True)
            for lane, r in res.items():
                f = fails.setdefault((name, lane), ([], []))
                if not r["old_ok"]:
                    f[0].append(seed)
                if not r["new_ok"]:
                    f[1].append(seed)
    missed = []
    for (name, lane), (old, new) in fails.items():
        log(f"mutant {name}, {lane} lane: the retired check fails seeds "
            f"{old}, the new check seeds {new}")
        if old and not new:
            missed.append((name, lane))
    return missed


# ---------------------------------------------------------------------------
# whisper-large-v3 (the encdec family) and the protocol model checker
# ---------------------------------------------------------------------------

WHISPER = "whisper-large-v3"
WHISPER_HEADS, WHISPER_DH = 20, 64     # 20 query heads over 20 KV heads
# serving: 4 clips of 1500 frames (30 s after the stride-2 conv stem), a
# 4-token decoder prompt, 64 new tokens each (the prefill's and 63 decode
# steps'), caches of 448 slots (whisper's text context), bf16 weights
WS_CLIPS, WS_FRAMES, WS_PROMPT, WS_NEW, WS_CACHE = 4, 1500, 4, 64, 448
# ... served at full width and this many of its 32 encoder and 32
# decoder layers, so that the script keeps within its time limit
WS_LAYERS = 16
# training: 2 clips of 1500 frames, 448 target tokens, 3 steps, fp32
WT_CLIPS, WT_FRAMES, WT_TOKENS, WT_STEPS = 2, 1500, 448, 3
WHISPER_KERNELS = ("flash_prefill", "rmsnorm")
WHISPER_TRAIN_KERNELS = ("flash_prefill", "flash_backward", "rmsnorm",
                         "rmsnorm_backward")
# K6 at whisper's attention (G = 1, Dh 64, non-causal): (name, path, dtype,
# B, Sq, Skv) -- the encoder's self-attention, the prefill's and a decode
# step's cross-attention (bf16 serving), and training's encoder and
# cross-attention (fp32, the LSE written); K10 at training's two shapes
WHISPER_K6_ROWS = (
    ("flash_prefill.whisper_encoder", "whisper", "bf16", WS_CLIPS,
     WS_FRAMES, WS_FRAMES),
    ("flash_prefill.whisper_cross_prefill", "whisper", "bf16", WS_CLIPS,
     WS_PROMPT, WS_FRAMES),
    ("flash_prefill.whisper_cross_decode", "whisper", "bf16", WS_CLIPS, 1,
     WS_FRAMES),
    ("flash_prefill.whisper_train_encoder", "whisper_train", "fp32",
     WT_CLIPS, WT_FRAMES, WT_FRAMES),
    ("flash_prefill.whisper_train_cross", "whisper_train", "fp32", WT_CLIPS,
     WT_TOKENS, WT_FRAMES))
WHISPER_K10_ROWS = (
    ("flash_backward.whisper_encoder", WT_CLIPS, WT_FRAMES, WT_FRAMES),
    ("flash_backward.whisper_cross", WT_CLIPS, WT_TOKENS, WT_FRAMES))


def phase2_whisper_attention(rows):
    """K6 and K10 against their plain versions at whisper's attention
    shapes (20 / 20 heads, Dh 64, non-causal; 1500 keys, not a multiple of
    the kernels' 64-key tile): K6 in bf16 on "wgmma" (serving) and fp32
    on "tf32x3" with its LSE (training), K10 in fp32 and bf16 (two calls
    bit-identical); each row's time beside SDPA's for the same call
    (forward, or eager backward) and its bound."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_backward_ref, flash_attention_lse_ref,
        flash_attention_ref)
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    launch_ms = rows[0]["launch_ms"]
    h, dh = WHISPER_HEADS, WHISPER_DH
    src = "src/repro_torch/kernels/flash_attention/csrc/"
    replaces = "src/repro/kernels/flash_attention/kernel.py:64"

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def add(row):
        row.update(route="cuda", launch_ms=launch_ms)
        rows.append(row)
        _log_row(row)

    def plain(q, k, v):
        return torch.cat([flash_attention_ref(q[i:i + 1], k[i:i + 1],
                                              v[i:i + 1], causal=False)
                          for i in range(q.shape[0])])

    for name, path, tag, b, sq, skv in WHISPER_K6_ROWS:
        fp32 = tag == "fp32"
        dt = torch.float32 if fp32 else torch.bfloat16
        q, k, v = (randn(b, n, h, dh).to(dt) for n in (sq, skv, skv))
        got, variant = variant_of(FK.flash_prefill, lambda: FK.flash_prefill(
            q, k, v, causal=False, return_lse=fp32))
        assert variant == ("tf32x3" if fp32 else "wgmma"), \
            f"K6 {name} took the {variant} variant"
        want = plain(q, k, v)
        if fp32:
            got, lse = got
            torch.testing.assert_close(lse, flash_attention_lse_ref(
                q, k, causal=False), **FP32)
        torch.testing.assert_close(got.float(), want.float(),
                                   **(FP32 if fp32 else BF16))
        if not fp32:       # P rounded to bf16 for P.V, as in phase 2's K6
            torch.testing.assert_close(
                got.float(), want.float(), rtol=2 ** -7,
                atol=2 ** -9 * float(v.abs().max()) + 1e-5)
        err = max_err(got.float(), want.float())
        del got, want
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        nops = 4 * b * h * dh * sq * skv
        el = 4 if fp32 else 2
        nbytes = el * (2 * b * sq * h * dh + 2 * b * skv * h * dh) \
            + (4 * b * h * sq if fp32 else 0)
        big = sq * skv > 1 << 20
        t = timings(lambda: FK.flash_prefill(q, k, v, causal=False,
                                             return_lse=fp32),
                    lambda: plain(q, k, v),
                    lambda: F.scaled_dot_product_attention(qt, kt, vt),
                    iters=5 if big else 20, plain_iters=2 if big else 20)
        add(dict(
            name=name, wrapper="flash_prefill", path=path, variant=variant,
            source=src + ("flash_prefill_tf32.cu" if fp32 else
                          "flash_prefill.cu"), replaces=replaces,
            max_abs_err=err,
            shape=f"B={b} Sq={sq} Skv={skv} H={h} Hkv={h} dh={dh} "
            f"non-causal {tag}" + (", LSE written; bound: three TF32 "
                                   "products" if fp32 else ""), **t,
            **dict(zip(("bound_ms", "bound_by"), bound(
                nbytes, 3 * nops, TF32_TC_FLOPS) if fp32 else
                bound(nbytes, nops, BF16_TC_FLOPS)))))
        log(f"  {name}: K6 {t['ms'] * 1e3:.2f} us, SDPA "
            f"{t['library_ms'] * 1e3:.2f} us ({t['ms'] / t['library_ms']:.2f}"
            f"x of it)")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    for name, b, sq, skv in WHISPER_K10_ROWS:
        q32, k32, v32, do32 = (randn(b, n, h, dh)
                               for n in (sq, skv, skv, sq))
        errs = {}
        for tag, dt, tol in (("fp32", torch.float32, FP32),
                             ("bf16", torch.bfloat16, BF16)):
            q, k, v, do = (t.to(dt) for t in (q32, k32, v32, do32))
            o, lse = FK.flash_prefill(q, k, v, causal=False, return_lse=True)
            got, variant = variant_of(FK.flash_backward, lambda: (
                FK.flash_backward(q, k, v, o, do, lse=lse, causal=False)))
            assert variant == ("tf32x3" if tag == "fp32" else "bf16")
            again = FK.flash_backward(q, k, v, o, do, lse=lse, causal=False)
            want = flash_attention_backward_ref(q, k, v, o, do, causal=False)
            for a, a2, w in zip(got, again, want):
                assert torch.equal(a, a2), f"K10 {name} {tag}: two calls"
                torch.testing.assert_close(a.float(), w.float(), **tol)
            errs[tag] = max(max_err(a.float(), w.float())
                            for a, w in zip(got, want))
            del got, again, want
        q, k, v, do = q32, k32, v32, do32
        o, lse = FK.flash_prefill(q, k, v, causal=False, return_lse=True)
        parts = kernel_times(lambda: FK.flash_backward(
            q, k, v, o, do, lse=lse, causal=False))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        nops = 10 * b * h * dh * sq * skv
        nbytes = 4 * (4 * b * sq * h * dh + 4 * b * skv * h * dh
                      + b * h * sq)
        t = timings(lambda: FK.flash_backward(q, k, v, o, do, lse=lse,
                                              causal=False),
                    lambda: flash_attention_backward_ref(q, k, v, o, do,
                                                         causal=False),
                    iters=5, plain_iters=2)
        t["library_ms"] = median_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 5, 3)
        add(dict(
            name=name, wrapper="flash_backward", path="whisper_train",
            variant="tf32x3", source=src + "flash_backward.cu",
            replaces=replaces, max_abs_err=errs["fp32"],
            shape=f"B={b} Sq={sq} Skv={skv} H={h} Hkv={h} dh={dh} "
            f"non-causal fp32 (bf16 max |err| {errs['bf16']:.3g}); kernels "
            f"(us, profiler): " + json.dumps(
                {kk: round(x, 2) for kk, x in parts.items()})
            + "; library: SDPA's eager backward; bound: three TF32 "
            "products", **t,
            **dict(zip(("bound_ms", "bound_by"),
                       bound(nbytes, 3 * nops, TF32_TC_FLOPS)))))
        log(f"  {name}: K10 {t['ms'] * 1e3:.2f} us, SDPA's eager backward "
            f"{t['library_ms'] * 1e3:.2f} us ({t['ms'] / t['library_ms']:.2f}"
            f"x of it)")
        del q32, k32, v32, do32, q, k, v, do, o, lse, qt, kt, vt, out
        torch.cuda.empty_cache()


def _whisper_batch(cfg, b, s_enc, s_dec, dev, seed=SEED, step=0):
    """Frames (the stub frontend's output: normal, from the seed with
    numpy) and decoder tokens / labels (``synthetic_batch``'s stream)."""
    import numpy as np
    from repro_torch.data import batch_to, synthetic_batch
    rng = np.random.default_rng([seed, step])
    batch = synthetic_batch(seed, step, b, s_dec, cfg.vocab)
    batch["frames"] = rng.standard_normal((b, s_enc, cfg.d_model),
                                          dtype=np.float32)
    return batch_to(batch, dev)


def _whisper_generate(cfg, params, batch, n_new, cache_len, windows=None):
    """Prefill, then greedy ``decode_step``s to ``n_new`` tokens a clip
    (the first from the prefill's logits); the tokens stay on the device
    until the end.  With ``windows`` (a dict), the launch counts of the
    prefill and of the first decode step are taken there, each set to 0
    just before and read just after.  Returns (tokens (B, n_new), the
    last logits, seconds)."""
    import torch
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.models import decode_step, prefill
    dev = batch["tokens"].device
    s = batch["tokens"].shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if windows is not None:
        reset_launch_counts()
    cache, logits = prefill(cfg, params, batch, cache_len)
    if windows is not None:
        windows["prefill"] = (launch_counts(), variant_counts())
    toks = [logits[:, -1].argmax(-1).to(torch.int32)]
    for i in range(n_new - 1):
        if windows is not None and i == 0:
            reset_launch_counts()
        cache, logits = decode_step(
            cfg, params, cache, toks[-1][:, None],
            torch.tensor(s + i, dtype=torch.int32, device=dev))
        if windows is not None and i == 0:
            windows["step"] = (launch_counts(), variant_counts())
        toks.append(logits[:, -1].argmax(-1).to(torch.int32))
    out = torch.stack(toks, 1)
    torch.cuda.synchronize()
    return out, logits, time.perf_counter() - t0


def _profile_kinds(prof):
    """(device busy s, device ms by kind) of a ``torch.profiler`` run."""
    from torch.autograd import DeviceType
    dev_rows = profile_rows(prof, DeviceType.CUDA)
    busy = sum(e.self_device_time_total for e in dev_rows) / 1e6
    kinds = {}
    for e in dev_rows:
        kind = ("K10" if "flash_bwd" in e.key else
                "K12" if "ssd_bwd" in e.key else
                "K7" if "ssd_chunk" in e.key else
                "K6" if "flash_prefill" in e.key else
                "K11" if "rmsnorm_bwd" in e.key else
                "K8" if "rmsnorm_rows" in e.key else
                "matmul" if any(k in e.key.lower() for k in
                                ("gemm", "xmma", "nvjet", "cutlass"))
                else "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    return busy, {k: round(v, 3) for k, v in kinds.items()}, dev_rows


def _whisper_norms(cfg, prefill):
    """K8's launches by variant in a prefill (2 a encoder layer, 3 a
    decoder layer, the final norm; the first of each stack plain, the
    rest with the residual add fused) or a decode step."""
    n = 3 * cfg.n_layers + 1 + (2 * cfg.n_enc_layers if prefill else 0)
    plain = 2 if prefill else 1
    return {"plain": plain, "add": n - plain}


def phase3_whisper_serve(smi, card="cuda"):
    """Serving whisper-large-v3 at full width and ``WS_LAYERS`` encoder and
    decoder layers on the card (random bf16 weights from seed 0): 4 clips
    of 1500 frames through ``prefill`` and greedy ``decode_step``s to 64
    tokens each.  The launch counts set to 0 before the first run and
    read after (K6 and K8); the per-prefill and per-step counts held (K6:
    3 a layer a prefill -- encoder, decoder and cross-attention -- and 1
    a layer a step, the cross-attention, all on
    "wgmma"; the decoder's self-attention over its 448-slot cache takes the
    plain dense path, as in JAX); tokens/s of the first and a warm run;
    a warm run under ``torch.profiler``.  Returns (counts, variants)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.models import init_params, param_leaves
    from torch.profiler import ProfilerActivity, profile
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_arch(WHISPER), n_layers=WS_LAYERS,
                              n_enc_layers=WS_LAYERS)
    params = init_params(cfg, torch.Generator(device=card).manual_seed(
        SEED), torch.bfloat16)
    n_par = sum(t.numel() for t in param_leaves(params))
    batch = _whisper_batch(cfg, WS_CLIPS, WS_FRAMES, WS_PROMPT, card)
    del batch["labels"]
    n_tok = WS_CLIPS * WS_NEW
    reset_launch_counts()
    toks, logits, first = _whisper_generate(cfg, params, batch, WS_NEW,
                                            WS_CACHE)
    counts, variants = launch_counts(), variant_counts()
    assert toks.shape == (WS_CLIPS, WS_NEW)
    assert bool(((toks >= 0) & (toks < cfg.vocab)).all())
    assert bool(torch.isfinite(logits).all())
    _t, _l, warm = _whisper_generate(cfg, params, batch, WS_NEW, WS_CACHE)
    windows = {}
    _t2, _l2, _s = _whisper_generate(cfg, params, batch, 2, WS_CACHE,
                                     windows)
    assert torch.equal(_t2, toks[:, :2]) and torch.equal(_t, toks)
    log(f"whisper serving on {smi}: {WHISPER} full width "
        f"({cfg.n_enc_layers} + {cfg.n_layers} of its 32 + 32 layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads, vocab "
        f"{cfg.vocab}, {n_par / 1e9:.3f} B bf16 params), {WS_CLIPS} clips "
        f"of {WS_FRAMES} frames, a {WS_PROMPT}-token prompt, {WS_NEW} new "
        f"tokens each, cache {WS_CACHE}: first run {first:.3f} s = "
        f"{n_tok / first:.1f} tokens/s, warm {warm:.3f} s = "
        f"{n_tok / warm:.1f} tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"launches on the whisper serving run: "
        f"{ {k: counts[k] for k in WHISPER_KERNELS} }, by variant "
        f"{ {k: variants[k] for k in WHISPER_KERNELS} }")
    steps = WS_NEW - 1
    want_k6 = 3 * cfg.n_layers
    assert variants["flash_prefill"] == {
        "wgmma": want_k6 + steps * cfg.n_layers}, variants["flash_prefill"]
    for key, want_k6_w, pre in (("prefill", want_k6, True),
                                ("step", cfg.n_layers, False)):
        c, v = windows[key]
        log(f"  a {key}: K6 {v['flash_prefill']}, K8 {v['rmsnorm']}")
        assert v["flash_prefill"] == {"wgmma": want_k6_w}, (key, v)
        assert v["rmsnorm"] == _whisper_norms(cfg, pre), (key, v)
        assert c["flash_prefill"] == want_k6_w
    for k in WHISPER_KERNELS:
        assert counts[k] > 0, f"{k} never launched on the whisper path"
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _t, _l, wall = _whisper_generate(cfg, params, batch, WS_NEW,
                                         WS_CACHE)
    busy, kinds, dev_rows = _profile_kinds(prof)
    log(f"profile: whisper serving on {smi}: wall {wall:.3f} s under the "
        f"profiler, device busy {busy:.3f} s, idle share "
        f"{1 - busy / wall:.3f}; device ms by kind " + json.dumps(kinds))
    for e in sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  device {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    del params, batch, prof
    gc.collect()
    torch.cuda.empty_cache()
    return counts, variants


def phase3_whisper_train(smi, card="cuda"):
    """Training whisper-large-v3 at full width and depth on the card in fp32
    weights: ``runtime.build_step`` (loss, gradients, AdamW), 3 steps of 2
    clips of 1500 frames and 448 target tokens.  The launch counts set to
    0 before the steps and read after: a step runs K6 and K10 96 times
    each (all on "tf32x3") and K8 and K11 161 times each (2 plain + 159
    add); ms a warm step, training tokens/s (decoder tokens), the peak
    memory, every parameter finite; one warm step under the profiler.
    Returns (counts, variants)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.models import init_params, param_leaves
    from repro_torch.optim import adamw
    from repro_torch.runtime import TrainConfig, build_step
    from torch.profiler import ProfilerActivity, profile
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(WHISPER)
    params = init_params(cfg, torch.Generator(device=card).manual_seed(
        SEED), torch.float32)
    n_par = sum(t.numel() for t in param_leaves(params))
    step_fn = build_step(cfg, TrainConfig(steps=WT_STEPS, seed=SEED))
    opt_state = adamw.init(params)
    batches = [_whisper_batch(cfg, WT_CLIPS, WT_FRAMES, WT_TOKENS, card,
                              step=s) for s in range(WT_STEPS + 1)]
    losses, step_s = [], []
    reset_launch_counts()
    for s in range(WT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, _r, m = step_fn(params, opt_state, None,
                                           batches[s])
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    counts, variants = launch_counts(), variant_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert all(map(math.isfinite, losses)), losses
    assert all(bool(torch.isfinite(t).all()) for t in param_leaves(params))
    warm = step_s[1:]
    toks = WT_CLIPS * WT_TOKENS
    log(f"whisper training on {smi}: {WHISPER} full width and depth "
        f"({n_par / 1e9:.3f} B fp32 params), {WT_STEPS} steps of "
        f"{WT_CLIPS} clips x {WT_FRAMES} frames and {WT_TOKENS} tokens: "
        f"losses {losses}; ms a step {[round(t * 1e3, 3) for t in step_s]} "
        f"(first cold); warm {sum(warm) / len(warm) * 1e3:.3f} ms a step = "
        f"{toks * len(warm) / sum(warm):.1f} decoder tokens/s; "
        f"max_memory_allocated {peak:.2f} GB")
    log(f"launches on the whisper training path: "
        f"{ {k: counts[k] for k in WHISPER_TRAIN_KERNELS} }, by variant "
        f"{ {k: variants[k] for k in WHISPER_TRAIN_KERNELS} }")
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    norms = _whisper_norms(cfg, True)
    for k in ("flash_prefill", "flash_backward"):
        assert variants[k] == {"tf32x3": WT_STEPS * n_attn}, (k, variants[k])
    for k in ("rmsnorm", "rmsnorm_backward"):
        assert variants[k] == {v: WT_STEPS * n for v, n in norms.items()}, \
            (k, variants[k])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, _r, m = step_fn(params, opt_state, None,
                                           batches[WT_STEPS])
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
    busy, kinds, dev_rows = _profile_kinds(prof)
    log(f"profile: whisper training step on {smi}: loss {loss:.4f}, wall "
        f"{wall:.3f} s under the profiler, device busy {busy:.3f} s, idle "
        f"share {1 - busy / wall:.3f}; device ms by kind "
        + json.dumps(kinds))
    for e in sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  device {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    del params, opt_state, batches, step_fn, prof
    gc.collect()
    torch.cuda.empty_cache()
    return counts, variants


# phase 4's whisper lanes: full width, 2 + 2 layers; fp32: 1 clip of 1500
# frames and 64 tokens, the loss, every gradient and the parameters after
# one AdamW step held as the tinyllama training lane holds them; bf16: 2
# clips, a 4-token prompt, the prefill and 4 teacher-forced decode steps
# under ``norm_check``
WP4_LAYERS, WP4_TOKENS, WP4_STEPS = 2, 64, 4


def phase4_whisper_card_vs_cpu(smi, card="cuda"):
    """whisper at full width and 2 + 2 layers, the card against the CPU
    (the plain versions, by ``device="cpu"``): fp32 loss, gradients and one
    AdamW step; the bf16 serving path teacher-forced against an fp32
    anchor."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import decode_step, init_params, loss_fn, prefill
    from repro_torch.optim import adamw
    from repro_torch.runtime import TrainConfig, build_step
    from repro_torch.tree import leaves, tree_map, value_and_grad
    cfg = dataclasses.replace(get_arch(WHISPER), n_layers=WP4_LAYERS,
                              n_enc_layers=WP4_LAYERS)
    params = init_params(cfg, torch.Generator().manual_seed(SEED + 30),
                         torch.float32)
    batch = _whisper_batch(cfg, 1, WT_FRAMES, WP4_TOKENS, "cpu", SEED + 30)
    res = {}
    for dev in (card, "cpu"):
        t0 = time.perf_counter()
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, grads = value_and_grad(lambda pp, bb: loss_fn(cfg, pp, bb), p,
                                     b)
        p, _st, _r, m = build_step(cfg, TrainConfig(steps=4))(
            p, adamw.init(p), None, b)
        res[dev] = (float(loss), [gr.cpu() for gr in leaves(grads)],
                    [t.cpu() for t in leaves(p)], float(m["lr"]))
        log(f"phase 4 whisper fp32 lane on {dev}: loss {float(loss):.7f}, "
            f"gradients and one AdamW step in "
            f"{time.perf_counter() - t0:.1f} s")
        del p, b, grads
    torch.cuda.empty_cache()
    (lc, gc_, pc, lr), (lh, gh, ph, _) = res[card], res["cpu"]
    assert math.isclose(lc, lh, rel_tol=TRAIN_P4_LOSS["rtol"]), (lc, lh)
    g_worst = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
                  for a, b in zip(gc_, gh))
    assert g_worst <= TRAIN_P4_GRAD_REL, g_worst
    p_worst = 0.0
    for a, b in zip(pc, ph):
        d = (a - b).abs()
        assert bool((d <= 2 * lr + 1e-6 * b.abs()).all()), float(d.max())
        p_worst = max(p_worst, float(d.max()))
    log(f"phase 4 whisper fp32 lane (full width, {cfg.n_enc_layers} + "
        f"{cfg.n_layers} layers, 1 x {WT_FRAMES} frames, {WP4_TOKENS} "
        f"tokens) on {smi}: loss card {lc:.7f} cpu {lh:.7f} (rel "
        f"{abs(lc - lh) / abs(lh):.2e}); worst gradient leaf error / its "
        f"max {g_worst:.2e} (limit {TRAIN_P4_GRAD_REL}); params after one "
        f"AdamW step: max |diff| {p_worst:.3e} (limit {2 * lr:.3e})")
    del res, params, batch

    # bf16, teacher-forced against the fp32 anchor
    pb = _phase4_params(cfg, SEED + 31)
    batch = _whisper_batch(cfg, 2, WT_FRAMES, WS_PROMPT, "cpu", SEED + 31)
    del batch["labels"]

    def run(params, dev, fed=None):
        """The prefill and WP4_STEPS decode steps, fed ``fed`` (else the
        run's own greedy tokens); returns ((R, V) logits a step, the
        tokens it fed)."""
        b = {k: v.to(dev) for k, v in batch.items()}
        cache, logits = prefill(cfg, params, b, WS_CACHE)
        out, toks = [logits[:, -1].float().cpu().numpy()], []
        for i in range(WP4_STEPS):
            tok = (out[-1].argmax(-1) if fed is None else fed[i])
            toks.append(tok)
            cache, logits = decode_step(
                cfg, params, cache,
                torch.from_numpy(tok.astype(np.int32)[:, None]).to(dev),
                torch.tensor(WS_PROMPT + i, dtype=torch.int32, device=dev))
            out.append(logits[:, -1].float().cpu().numpy())
        return out, toks

    with torch.no_grad():
        anchor, fed = run(_cast(pb, torch.float32), "cpu")
        cpu, _ = run(pb, "cpu", fed)
        got, _ = run(_cast(pb, device=card), card, fed)
    ok, steps = norm_check(got, cpu, anchor)
    worst = max(s["e_card"] / s["limit"] for s in steps)
    log(f"phase 4 whisper bf16 lane on {smi}: teacher-forced (prefill + "
        f"{WP4_STEPS} steps, 2 clips): e_card / e_cpu per step "
        + ", ".join(f"{s['e_card']:.4g}/{s['e_cpu']:.4g}" for s in steps)
        + f"; worst e_card / limit {worst:.3f}: "
        f"{'holds' if ok else 'FAILS'}")
    assert ok, f"whisper bf16 lane: {steps}"
    torch.cuda.empty_cache()


# the model checker's lanes on the card: the 2-core / 1-block config
MC_LANES = (("sc", {}), ("no-pw-opt", dict(pw_opt=False)),
            ("tso", dict(consistency="tso")))


def phase3_model_check(smi, card="cuda"):
    """The protocol model checker with its bridge replaying every distinct
    manager-table operation on the card (``Bridge(backend="device")``:
    each read one K1 launch, each write one K2 launch) and, in the same
    process, on the numpy mirror: each lane closes with zero violations
    and the two give the same states, transitions, rule counts and bridge
    counts.  Returns the K1 / K2 launches of the card's replays."""
    from repro_torch.analysis import Bridge, Config, TardisModel, explore
    total = {"lease_pass": 0, "write_advance": 0}
    for lane, kw in MC_LANES:
        cfg = Config(n_cores=2, n_blocks=1, lease=2, ts_bits=2, **kw)
        out = {}
        for backend in ("numpy", "device"):
            bridge = Bridge(cfg.lease, backend=backend,
                            device=card if backend == "device" else None)
            t0 = time.perf_counter()
            r = explore(TardisModel(cfg), bridge=bridge)
            out[backend] = (r, bridge.launches, time.perf_counter() - t0)
            assert r.closed and not r.violations, \
                f"model check {lane} ({backend}): {r.violations[:3]}"
        (rn, _ln, wn), (rd, ld, wd) = out["numpy"], out["device"]
        key = ("n_states", "n_transitions", "max_depth", "rule_counts",
               "bridge_counts")
        assert [getattr(rd, k) for k in key] == [getattr(rn, k) for k in key]
        assert ld == {"lease_pass": rd.bridge_counts["engine.read"],
                      "write_advance": rd.bridge_counts["engine.write"]}, ld
        for k in total:
            total[k] += ld[k]
        log(f"model check {lane} on {smi}: {rd.n_states} states, "
            f"{rd.n_transitions} transitions, depth {rd.max_depth}, closed, "
            f"0 violations, counts equal to the numpy lane's; bridge "
            f"{rd.bridge_counts}; K1 {ld['lease_pass']} / K2 "
            f"{ld['write_advance']} launches; wall {wd:.2f} s (numpy "
            f"{wn:.2f} s)")
    return total



# ---------------------------------------------------------------------------
# The ssm and hybrid families' training on the card (K12, K11's gate)
# ---------------------------------------------------------------------------

# zamba2-2.7b trains at full width and depth, fp32 weights: 2 x 1024 tokens
# a step (peak 55.86 GB allocated at that size: nothing cut), 4 steps (the
# first cold); mamba2-130m at its published size, 8 x 1024 tokens, 3 steps
SSM_TRAIN = {"zamba2-2.7b": dict(steps=4, batch=2, seq=1024),
             "mamba2-130m": dict(steps=3, batch=8, seq=1024)}
SSM_TRAIN_KERNELS = ("ssd_chunk", "ssd_chunk_backward", "rmsnorm",
                     "rmsnorm_backward", "flash_prefill", "flash_backward")
# K12 and K11's gate at each family's training shape: (name, path, b, s,
# heads, P, N) and (name, path, rows, D, in_proj width)
K12_ROWS = (("ssd_chunk_backward.zamba2", "zamba2_train", 2, 1024, 80, 64,
             64),
            ("ssd_chunk_backward.mamba2", "mamba2_train", 8, 1024, 24, 64,
             128))
K11_GATE_ROWS = (("rmsnorm_backward.zamba2_gated", "zamba2_train", 2 * 1024,
                  5120, 10448),
                 ("rmsnorm_backward.mamba2_gated", "mamba2_train", 8 * 1024,
                  1536, 3352))


def _ssd_train_inputs(g, b, s, h, p, n, chunk=256):
    """K7's / K12's operands as the training step lays them out: x, B and
    C fp32 column views of one conv output (B, C shared by the heads), dt
    softplus-ed, cum its within-chunk cumulative decay; dy, dS."""
    import torch
    F = torch.nn.functional
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    nc = -(-s // chunk)
    conv = randn(b, s, h * p + 2 * n)
    xs = conv[..., :h * p].reshape(b, s, h, p)
    bs, cs = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    dt = F.softplus(randn(b, s, h))
    A = -torch.exp(0.5 * randn(h))
    cum = torch.cumsum((F.pad(dt, (0, 0, 0, nc * chunk - s)) * A).reshape(
        b, nc, chunk, h), dim=2)
    return xs, dt, cum, bs, cs, randn(b, nc, chunk, h, p), \
        randn(b, nc, h, p, n), chunk


def phase2_ssm_backward_kernels(rows):
    """K12 (the SSD chunk backward) and K11's gate variant against their
    plain versions on the card at zamba2's and mamba2's training shapes,
    fp32 within 2e-4 of each output's largest value, two calls
    bit-identical; each row's device time (graph replay), eager call,
    plain version, bound and launches (on its family's training path).
    K7's fp32 forward (its tf32x3 variant) gets a row at each training
    shape, within 2e-4 of its plain version, two calls bit-identical.
    Beside K12 and K7 the parent's kernels -- their SIMT variants, still
    in the library -- are timed on the same inputs and read against the
    same bound.  Returns those two kernels' summary lines (device us,
    share of the bound, the parent's kernels, plain us, error) for the end
    of the log."""
    import torch
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.rmsnorm.ref import gated_rmsnorm_backward_ref
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_backward_ref,
                                                  ssd_chunk_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    launch_ms = rows[0]["launch_ms"]

    def add(row):
        row.update(route="cuda", launch_ms=launch_ms)
        rows.append(row)
        _log_row(row)

    def held(name, got, again, want):
        for i, (a, a2, w) in enumerate(zip(got, again, want)):
            assert torch.equal(a, a2), f"{name} output {i}: two calls differ"
            scale = max(float(w.float().abs().max()), 1.0)
            err = max_err(a.float(), w.float())
            assert err <= FP32["atol"] * scale, (name, i, err, scale)
        return max(max_err(a.float(), w.float()) for a, w in zip(got, want))

    summary = []

    def read(what, ms, bound_ms, by, plain_ms, err, parent_ms):
        """One summary line: device us, share of the bound, the parent's."""
        line = (f"{what}: {ms * 1e3:.2f} us, {bound_ms / ms:.1%} of its "
                f"bound {bound_ms * 1e3:.3f} us ({by}); the parent's SIMT "
                f"kernels {parent_ms * 1e3:.2f} us ({bound_ms / parent_ms:.1%} "
                f"of the same bound); plain {plain_ms * 1e3:.2f} us; max "
                f"|err| {err:.3e}")
        log(line)
        summary.append(line)

    for name, path, b, s, h, p, n in K12_ROWS:
        xs, dt, cum, bs, cs, dy, dS, chunk = _ssd_train_inputs(g, b, s, h, p,
                                                               n)
        nc, q = cum.shape[1], chunk
        tri = q * (q + 1) // 2
        args = (xs, dt, cum, bs, cs, dy, dS)
        got, variant = variant_of(
            SK.ssd_chunk_backward,
            lambda: SK.ssd_chunk_backward(*args, chunk=chunk))
        assert variant == "tf32x3", f"K12 took {variant}"
        want = ssd_chunk_backward_ref(*args, chunk=chunk)
        err = held(name, got, SK.ssd_chunk_backward(*args, chunk=chunk),
                   want)
        # the parent's kernels (the SIMT variant) on the same inputs
        held(name + " (simt)", SK._backward_launch(*args, chunk),
             SK._backward_launch(*args, chunk), want)
        del got, want
        # operations (multiply-adds as 2), the least work of the closed
        # form where one group serves every head: once a chunk over the
        # lower triangle C.B^T and, after the heads' dcb are summed, dC =
        # (sum dcb) B and dB's (sum dcb)^T C (n each); per (chunk, head)
        # over the triangle dM and M^T dy (p each), and the state terms
        # B dS^T and xdt dS (q p n each) -- at fp32 accuracy as three TF32
        # products at 495 TFLOP/s (K6's and K10's yardstick), the fp32
        # SIMT bound at 67 beside it; bytes: x, B, C, dt, cum, dy and dS
        # read once, dx, ddt, dcum, dB, dC written once
        nops = (2 * b * nc * tri * 3 * n
                + 2 * b * nc * h * (tri * 2 * p + 2 * q * p * n))
        nbytes = 4 * (2 * b * s * h * p + 4 * b * s * n + 2 * b * s * h
                      + 2 * b * nc * q * h + b * nc * q * h * p
                      + b * nc * h * p * n)
        simt_b = bound(nbytes, nops)[0]
        bound_ms, bound_by = bound(nbytes, 3 * nops, TF32_TC_FLOPS)
        t = timings(lambda: SK.ssd_chunk_backward(*args, chunk=chunk),
                    lambda: ssd_chunk_backward_ref(*args, chunk=chunk),
                    iters=5, plain_iters=2)
        parent_ms = graph_ms(lambda: SK._backward_launch(*args, chunk), 5)
        add(dict(
            name=name, wrapper="ssd_chunk_backward", path=path,
            variant="tf32x3", source="src/repro_torch/kernels/ssd_scan/"
            "csrc/ssd_chunk_backward_tf32.cu",
            replaces="src/repro/kernels/ssd_scan/kernel.py:42 (its "
            "gradient: JAX differentiates ops.py's jnp path)",
            max_abs_err=err,
            shape=f"b={b} s={s} nc={nc} Q={q} heads={h} P={p} N={n} fp32, "
            f"B/C shared by the heads (bound: three TF32 products, fp32 "
            f"SIMT {simt_b * 1e3:.3f} us; the parent's SIMT kernels "
            f"{parent_ms * 1e3:.2f} us)", **t,
            bound_ms=bound_ms, bound_by=bound_by))
        read(f"K12 {path} (tf32x3)", t["ms"], bound_ms, bound_by,
             t["plain_ms"], err, parent_ms)

        # K7's fp32 forward (tf32x3) at the same shape
        call = lambda: SK.ssd_chunk(xs, dt, cum, bs, cs, chunk=chunk)
        (y, st), variant = variant_of(SK.ssd_chunk, call)
        assert variant == "tf32x3", f"K7 fp32 took {variant}"
        y2, st2 = call()
        assert torch.equal(y, y2) and torch.equal(st, st2), \
            "K7 tf32x3: two calls differ"
        wy, wst = ssd_chunk_ref(xs, dt, cum, bs, cs, chunk=chunk)
        torch.testing.assert_close(y, wy, **FP32)
        torch.testing.assert_close(st, wst, **FP32)
        ferr = max(max_err(y, wy), max_err(st, wst))
        py, pst = SK._forward_launch(xs, dt, cum, bs, cs, chunk, "simt")
        torch.testing.assert_close(py, wy, **FP32)
        torch.testing.assert_close(pst, wst, **FP32)
        del y, st, y2, st2, wy, wst, py, pst
        # products C.B (once a chunk: the heads share it), M.xdt and
        # B^T(e xdt) as three TF32 products each; the decay mask and e xdt
        # (elementwise) at fp32's rate
        fprod = (2 * b * nc * tri * n + 2 * b * nc * h * tri * p
                 + 2 * b * nc * h * q * n * p)
        fother = b * nc * h * tri + 2 * b * nc * h * q * p
        fops = fprod + fother
        fbytes = 4 * (b * s * h * p + 2 * b * s * n + b * s * h
                      + b * nc * q * h + b * nc * q * h * p
                      + b * nc * h * p * n)
        fsimt_b = bound(fbytes, fops)[0]
        fbound_ms, fbound_by = bound(
            fbytes, 3 * fprod + fother * TF32_TC_FLOPS / FP32_FLOPS,
            TF32_TC_FLOPS)
        ft = timings(call, lambda: ssd_chunk_ref(xs, dt, cum, bs, cs,
                                                 chunk=chunk),
                     iters=5, plain_iters=2)
        fparent_ms = graph_ms(lambda: SK._forward_launch(
            xs, dt, cum, bs, cs, chunk, "simt"), 5)
        add(dict(
            name="ssd_chunk.train" + ("" if path == "zamba2_train"
                                      else "_mamba2"),
            wrapper="ssd_chunk", path=path,
            source="src/repro_torch/kernels/ssd_scan/csrc/ssd_chunk_tf32.cu",
            replaces="src/repro/kernels/ssd_scan/kernel.py:42",
            max_abs_err=ferr, variant="tf32x3",
            shape=f"b={b} s={s} nc={nc} Q={q} heads={h} P={p} N={n} "
            f"fp32 (the training forward; bound: three TF32 products, "
            f"fp32 SIMT {fsimt_b * 1e3:.3f} us; the parent's SIMT kernel "
            f"{fparent_ms * 1e3:.2f} us)", **ft,
            bound_ms=fbound_ms, bound_by=fbound_by))
        read(f"K7 fp32 {path} (tf32x3)", ft["ms"], fbound_ms, fbound_by,
             ft["plain_ms"], ferr, fparent_ms)
        del xs, dt, cum, bs, cs, dy, dS, args, call
        torch.cuda.empty_cache()

    for name, path, r, d, width in K11_GATE_ROWS:
        y = torch.randn(r, d, generator=g, device=dev)
        proj = torch.randn(r, width, generator=g, device=dev)
        z = proj[:, d:2 * d]                    # in_proj's gate columns
        w = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
        dout = torch.randn(r, d, generator=g, device=dev)
        err = held(name, RK.rmsnorm_backward_gate(y, z, w, dout),
                   RK.rmsnorm_backward_gate(y, z, w, dout),
                   gated_rmsnorm_backward_ref(y, z, w, dout))
        split = k11_kernel_times(lambda: RK.rmsnorm_backward_gate(y, z, w,
                                                                  dout))
        # bytes: y, z and the output's gradient read, dy, dz written, w and
        # dw; ~25 operations an element (silu and its derivative)
        nbytes = 4 * (5 * r * d + 2 * d)
        add(dict(
            name=name, wrapper="rmsnorm_backward", path=path,
            variant="gate", source="src/repro_torch/kernels/rmsnorm/csrc/"
            "rmsnorm_backward.cu", replaces="src/repro/kernels/rmsnorm/"
            "kernel.py:24 (its gate composition's gradient)",
            max_abs_err=err,
            shape=f"rows={r} D={d} fp32, z a column view of {width}-wide "
            f"rows; kernels (torch.profiler): rows "
            f"{split['rows'] * 1e3:.2f} us, dw sum {split['dw'] * 1e3:.2f} us",
            **timings(lambda: RK.rmsnorm_backward_gate(y, z, w, dout),
                      lambda: gated_rmsnorm_backward_ref(y, z, w, dout)),
            **dict(zip(("bound_ms", "bound_by"),
                       bound(nbytes, 25 * r * d)))))
        del y, proj, z, w, dout
        torch.cuda.empty_cache()

    return summary

def _ssm_launches_per_step(cfg):
    """{wrapper: launches a training step} of an ssm / hybrid config, and
    {wrapper: {variant: launches}}: one K7 / K12 and one gated norm a
    Mamba2 layer; the hybrid's shared attention block (a K6 / K10 each,
    two add norms) after every ``attn_every`` layers; the final norm an add
    (a sublayer's output is pending)."""
    n_attn = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    norms = cfg.n_layers + 2 * n_attn + 1
    want = {"ssd_chunk": cfg.n_layers, "ssd_chunk_backward": cfg.n_layers,
            "rmsnorm": norms, "rmsnorm_backward": norms,
            "flash_prefill": n_attn, "flash_backward": n_attn}
    by_variant = {"rmsnorm": {"gate": cfg.n_layers, "add": norms - cfg.n_layers},
                  "rmsnorm_backward": {"gate": cfg.n_layers,
                                       "add": norms - cfg.n_layers},
                  "ssd_chunk": {"tf32x3": cfg.n_layers},
                  "ssd_chunk_backward": {"tf32x3": cfg.n_layers}}
    if n_attn:
        by_variant["flash_prefill"] = {"tf32x3": n_attn}
        by_variant["flash_backward"] = {"tf32x3": n_attn}
    return want, by_variant


def phase3_ssm_train_path(smi, arch):
    """``runtime.train`` of ``arch`` (zamba2-2.7b or mamba2-130m) on the
    card at full width and depth, fp32 weights: the launch counts set to
    0 just before the run and read just after, held per step (K7 / K12
    and K8 / K11's gate a Mamba2 layer, their add norms, K6 / K10 for the
    shared attention); ms a warm step, tokens/s, peak memory; every
    parameter's gradient finite and non-zero after the run (zamba2);
    one warm step under ``torch.profiler`` (idle share, device ms by kind).
    Returns (launch counts, launches by variant, a summary line: warm ms a
    step, tokens/s)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import adamw
    from repro_torch.runtime import TrainConfig, build_step, train
    from repro_torch.tree import leaves, value_and_grad
    from torch.profiler import ProfilerActivity, profile
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(arch)
    kw = SSM_TRAIN[arch]
    n_par = cfg.param_count()
    tc = TrainConfig(seed=SEED, log_every=1, **kw)
    step_s = []
    reset_launch_counts()
    out = train(cfg, init_params(cfg, torch.Generator(
        device="cuda").manual_seed(SEED), torch.float32), tc,
        device="cuda", on_metrics=lambda st, m: step_s.append(m["step_s"]))
    counts, variants = launch_counts(), variant_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    reserved = torch.cuda.max_memory_reserved() / 1e9
    losses = out["losses"]
    assert out["final_step"] == kw["steps"] and out["restarts"] == 0
    assert all(map(math.isfinite, losses)), losses
    toks = kw["batch"] * kw["seq"]
    warm = step_s[1:]
    log(f"training path ({arch}) on {smi}: full width and depth "
        f"({cfg.n_layers} Mamba2 layers, d_model {cfg.d_model}, "
        f"{n_par / 1e9:.3f} B fp32 params), {kw['steps']} steps of "
        f"{kw['batch']} x {kw['seq']} tokens: losses {losses}; ms a step "
        f"{[round(t * 1e3, 3) for t in step_s]} (first step cold); warm "
        f"{sum(warm) / len(warm) * 1e3:.3f} ms a step = "
        f"{toks * len(warm) / sum(warm):.1f} tokens/s; max_memory_allocated "
        f"{peak:.2f} GB, max_memory_reserved {reserved:.2f} GB")
    log(f"launches on the {arch} training path: {counts}")
    log(f"launches by variant on the {arch} training path: {variants}")
    line = (f"training path ({arch}) on {smi}: warm "
            f"{sum(warm) / len(warm) * 1e3:.3f} ms a step, "
            f"{toks * len(warm) / sum(warm):.1f} tokens/s (steps "
            f"{[round(t * 1e3, 3) for t in warm]} ms)")
    want, by_variant = _ssm_launches_per_step(cfg)
    for k in SSM_TRAIN_KERNELS:
        assert counts[k] == kw["steps"] * want[k], \
            f"{arch} {k}: {counts[k]} launches in {kw['steps']} steps, " \
            f"want {want[k]} a step"
    for k, per in by_variant.items():
        assert variants[k] == {v: kw["steps"] * c for v, c in per.items()}, \
            f"{arch} {k} by variant: {variants[k]}"
    params, opt_state = out["params"], out["opt_state"]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    batch = _train_batch(cfg, kw["steps"], kw["batch"], kw["seq"], "cuda")
    if arch == "zamba2-2.7b":
        del opt_state
        gc.collect()
        torch.cuda.empty_cache()
        loss, grads = value_and_grad(lambda p, b: loss_fn(cfg, p, b),
                                     params, batch)
        bad = [i for i, gr in enumerate(leaves(grads))
               if not bool(torch.isfinite(gr).all()) or not bool(gr.any())]
        assert not bad, f"{arch}: parameter leaves with a zero or " \
            f"non-finite gradient: {bad}"
        log(f"gradients ({arch}) on {smi}: all {len(leaves(grads))} "
            f"parameter leaves finite and non-zero (loss {float(loss):.6f})")
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        opt_state = adamw.init(params)
    step_fn = build_step(cfg, tc)

    def one_step():
        nonlocal params, opt_state
        params, opt_state, _r, m = step_fn(params, opt_state, None, batch)
        return float(m["loss"])

    one_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step()
        wall = time.perf_counter() - t0
    busy, kinds, dev_rows = _profile_kinds(prof)
    log(f"profile: {arch} training step on {smi}: wall {wall:.3f} s under "
        f"the profiler, device busy {busy:.3f} s, idle share "
        f"{1 - busy / wall:.3f}; device ms by kind " + json.dumps(kinds))
    for e in sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  device {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    del params, opt_state, batch, step_fn, prof
    gc.collect()
    torch.cuda.empty_cache()
    return counts, variants, line


# Phase 4 of the zamba2 training lane: the card against the CPU at full
# width and 6 layers (one group: 6 Mamba2 layers and the shared attention
# block), one batch of 2 x 256 tokens, with the tinyllama lane's
# tolerances (TRAIN_P4_*): the loss within rtol 1e-5, each gradient leaf
# within 1e-4 of its largest magnitude, the parameters after 2 AdamW steps
# within 2 x the summed learning rates (plus 1e-6 of each value)
SSM_P4_LAYERS, SSM_P4_BATCH, SSM_P4_SEQ = 6, 2, 256


def phase4_ssm_train_card_vs_cpu(smi):
    """zamba2's training on the card (K7 / K12, K8 / K11's gate, K6 / K10)
    against the CPU (the plain versions), then the train CLI's ssm and
    hybrid runs on the card.  Returns the 2-step training state on the
    CPU (params, opt_state) for the checkpoint phase."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as train_cli
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import adamw
    from repro_torch.runtime import TrainConfig, build_step
    from repro_torch.tree import leaves, tree_map, value_and_grad
    cfg = dataclasses.replace(get_arch("zamba2-2.7b"), n_layers=SSM_P4_LAYERS)
    params = init_params(cfg, torch.Generator().manual_seed(SEED + 50),
                         torch.float32)
    batch = _train_batch(cfg, 0, SSM_P4_BATCH, SSM_P4_SEQ, "cpu")
    tc = TrainConfig(steps=4, batch=SSM_P4_BATCH, seq=SSM_P4_SEQ)
    res, state = {}, None
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, grads = value_and_grad(lambda pp, bb: loss_fn(cfg, pp, bb), p,
                                     b)
        step_fn, st = build_step(cfg, tc), adamw.init(p)
        lrs = []
        for _ in range(2):
            p, st, _r, m = step_fn(p, st, None, b)
            lrs.append(float(m["lr"]))
        res[dev] = (float(loss), [gr.cpu() for gr in leaves(grads)],
                    [t.cpu() for t in leaves(p)], lrs)
        if dev == "cpu":
            state = (p, st)
        log(f"phase 4 zamba2 training lane on {dev}: loss "
            f"{float(loss):.7f}, gradients and 2 AdamW steps in "
            f"{time.perf_counter() - t0:.1f} s")
        del b, grads, step_fn
        if dev == "cuda":
            del p, st
    torch.cuda.empty_cache()
    (lc, gc_, pc, lrs), (lh, gh, ph, _) = res["cuda"], res["cpu"]
    assert math.isclose(lc, lh, rel_tol=TRAIN_P4_LOSS["rtol"]), (lc, lh)
    g_worst = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
                  for a, b in zip(gc_, gh))
    assert g_worst <= TRAIN_P4_GRAD_REL, g_worst
    step_bound = 2 * sum(lrs)
    p_worst = 0.0
    for a, b in zip(pc, ph):
        d = (a - b).abs()
        assert bool((d <= step_bound + 1e-6 * b.abs()).all()), \
            float(d.max())
        p_worst = max(p_worst, float(d.max()))
    log(f"phase 4 zamba2 training lane (full width, {cfg.n_layers} layers, "
        f"{SSM_P4_BATCH} x {SSM_P4_SEQ} tokens) on {smi}: loss card "
        f"{lc:.7f} cpu {lh:.7f} (rel {abs(lc - lh) / abs(lh):.2e}); worst "
        f"gradient leaf error / its max {g_worst:.2e} (limit "
        f"{TRAIN_P4_GRAD_REL}); params after 2 AdamW steps: max |diff| "
        f"{p_worst:.3e} (limit {step_bound:.3e} = 2 x the summed lr)")
    del res, params, batch
    # the train CLI (reduced configs) on the card, both families
    for arch in ("zamba2-2.7b", "mamba2-130m"):
        out = train_cli.main(["--arch", arch, "--steps", "3", "--batch", "2",
                              "--seq", "64"])
        assert out["final_step"] == 3 and all(map(math.isfinite,
                                                  out["losses"]))
        log(f"python -m repro_torch.launch.train --arch {arch} on the card: "
            f"losses {out['losses']}")
    torch.cuda.empty_cache()
    return state


def phase3_collectives_and_checkpoint(smi, state):
    """On a one-rank NCCL group: each device collective of
    ``dist.collectives`` on the card equals its numpy mirror; then the
    zamba2 training state of phase 4 (full width, 6 layers, after 2 AdamW
    steps), placed on the card as DTensors by ``dist.sharding`` on a 1 x 1
    mesh, round-trips through ``save_sharded`` / ``restore_sharded`` bit
    for bit (restored as DTensors and as plain tensors), with each
    direction's GB/s (warm page cache)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import ckpt
    from repro_torch.dist import collectives as C
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import leaves, tree_map
    scratch = ROOT / "build" / "ckpt"
    scratch.mkdir(parents=True, exist_ok=True)
    rdv = tempfile.mkdtemp(dir=scratch)
    dist.init_process_group("nccl", init_method=f"file://{rdv}/rdv", rank=0,
                            world_size=1)
    try:
        rng = np.random.default_rng(SEED)
        x = rng.integers(-1000, 1000, (8, 5)).astype(np.int64)
        xt = torch.from_numpy(x).cuda()
        for name, fn, mirror in (("psum", C.psum, C.np_psum),
                                 ("all_gather", C.all_gather,
                                  C.np_all_gather),
                                 ("reduce_scatter", C.reduce_scatter,
                                  C.np_reduce_scatter),
                                 ("all_to_all", C.all_to_all,
                                  C.np_all_to_all)):
            got = fn(xt).cpu().numpy()
            assert np.array_equal(got, mirror([x])[0]), name
        log(f"collectives on a one-rank NCCL group on {smi}: psum, "
            f"all_gather, reduce_scatter, all_to_all equal their numpy "
            f"mirrors (int64 (8, 5))")
        mesh = make_host_mesh(data=1, model=1)
        params, opt = state
        tree = {"params": params, "opt": {"m": opt["m"], "v": opt["v"]}}
        sh = {"params": shd.param_shardings(mesh, params),
              "opt": {"m": shd.param_shardings(mesh, params),
                      "v": shd.param_shardings(mesh, params)}}
        placed = tree_map(lambda t, ns: shd.shard(t.cuda(), ns), tree, sh)
        nbytes = sum(t.numel() * t.element_size() for t in leaves(tree))
        d = tempfile.mkdtemp(dir=scratch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_sharded(d, 2, placed, wts=2)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, man = ckpt.restore_sharded(d, placed)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        same = all(torch.equal(a.to_local().cpu(), b)
                   for a, b in zip(leaves(out), leaves(tree)))
        plain, _m = ckpt.restore_sharded(d, tree)
        same_plain = all(torch.equal(a, b)
                         for a, b in zip(leaves(plain), leaves(tree)))
        assert same and same_plain and man["wts"] == 2
        log(f"sharded checkpoint of the zamba2 training state (full width, "
            f"{SSM_P4_LAYERS} layers: params and both moments, "
            f"{nbytes / 1e9:.3f} GB, {man['n_leaves']} leaves, "
            f"{sum(len(e['pieces']) for e in man['leaves'])} pieces) on "
            f"{smi}: save_sharded {t_save:.2f} s = {nbytes / t_save / 1e9:.2f} "
            f"GB/s, restore_sharded (DTensors on the card) {t_restore:.2f} s "
            f"= {nbytes / t_restore / 1e9:.2f} GB/s (warm page cache); bit "
            f"for bit as DTensors and as plain tensors")
        del placed, out, plain
        shutil.rmtree(d, ignore_errors=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--phase4-seeds"]:
        phase4_seed_sweep(phase1_card_and_build(),
                          [int(x) for x in sys.argv[2].split(",")])
        return 0
    if sys.argv[1:2] == ["--phase4-mutants"]:
        missed = phase4_mutants(phase1_card_and_build(),
                                [int(x) for x in sys.argv[2].split(",")])
        assert not missed, f"the new check misses injections that the " \
            f"retired check caught: {missed}"
        return 0
    t0 = time.perf_counter()

    def stamp(phase):
        log(f"[{time.perf_counter() - t0:7.1f} s] {phase} done")

    smi = phase1_card_and_build()
    rows = []
    phase2_kernels(rows)
    phase2_dense_decode(rows)
    phase2_prefill_kernels(rows)
    phase2_backward_kernels(rows)
    summary = phase2_ssm_backward_kernels(rows)
    phase2_whisper_attention(rows)
    t_l2, t_smem = phase2_coherence_sim(rows)
    stamp("phase 2")
    sim_counts = phase3_simulator_path(smi, rows, t_l2, t_smem)
    stamp("phase 3 (simulator path)")
    phase3_model_check(smi)
    stamp("phase 3 (model checker on the card)")
    counts, variants, _tps = phase3_main_path(smi)
    stamp("phase 3 (paged path)")
    phase3_multi_host(smi)
    stamp("phase 3 (multi-host fleets)")
    wave_counts = phase3_wave_paths(smi)
    stamp("phase 3 (wave paths)")
    kimi_counts = phase3_kimi_path(smi)
    stamp("phase 3 (kimi-k2 paged path)")
    decoder_counts = phase3_decoder_paths(smi)
    stamp("phase 3 (the decoder configurations' paged paths)")
    phase3_serving_example(smi)
    stamp("phase 3 (serving example)")
    phase3_elastic_example(smi)
    stamp("phase 3 (elastic example)")
    phase3_training_example(smi)
    stamp("phase 3 (training example --full)")
    phase3_cli_smokes(smi)
    stamp("phase 3 (CLI smokes)")
    train_counts = phase3_train_path(smi)
    stamp("phase 3 (training path)")
    ssm_train_counts = {}
    for arch in SSM_TRAIN:
        counts_a, variants_a, line = phase3_ssm_train_path(smi, arch)
        ssm_train_counts[arch.split("-")[0] + "_train"] = (counts_a,
                                                          variants_a)
        summary.append(line)
        stamp(f"phase 3 (training path, {arch})")
    whisper_counts = phase3_whisper_serve(smi)
    stamp("phase 3 (whisper serving)")
    whisper_train_counts = phase3_whisper_train(smi)
    stamp("phase 3 (whisper training)")
    phase4_card_vs_cpu(smi)
    stamp("phase 4 (paged path)")
    phase4_fleet_card_vs_cpu(smi)
    stamp("phase 4 (fleet A lane)")
    phase4_card_vs_cpu(smi, lane="kimi")
    stamp("phase 4 (kimi-k2 paged lane)")
    phase4_decoder_lanes(smi)
    stamp("phase 4 (the decoder configurations' lanes)")
    phase4_wave_card_vs_cpu(smi)
    stamp("phase 4 (wave paths)")
    phase4_train_card_vs_cpu(smi)
    stamp("phase 4 (training path)")
    state = phase4_ssm_train_card_vs_cpu(smi)
    stamp("phase 4 (zamba2 training lane, train CLI)")
    phase3_collectives_and_checkpoint(smi, state)
    del state
    stamp("collectives and sharded checkpoint")
    phase4_whisper_card_vs_cpu(smi)
    stamp("phase 4 (whisper lanes)")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "call_ms", "launch_ms", "shape", "variant",
            "unfused_ms", "floor_ms")
    # each kernel's launches on the path its row names (K1-K4: the paged
    # main path; K4 and K6 at the decoder configurations' shapes: their
    # paged paths; K10 and K11: the training path; K12 and K11's gate: the
    # zamba2 / mamba2 training paths); K8's, K10's and K11's rows count
    # their variant's
    path_counts = {"paged": (counts, variants), KIMI: kimi_counts,
                   **decoder_counts,
                   "simulator": sim_counts, "train": train_counts,
                   "whisper": whisper_counts,
                   "whisper_train": whisper_train_counts,
                   **ssm_train_counts, **wave_counts}
    for r in rows:
        c, v = path_counts.get(r.get("path", "paged"), ({}, {}))
        wrapper = r.get("wrapper", r["name"])
        r["launches"] = (v.get(wrapper, {}).get(r["variant"], 0)
                         if wrapper in ("rmsnorm", "rmsnorm_backward",
                                        "flash_backward", "sim_run")
                         else c.get(wrapper, 0))
        r.setdefault("variant", None)
        r.setdefault("unfused_ms", None)
        r.setdefault("floor_ms", None)
    for line in summary:
        log(f"summary: {line}")
    log(f"chip_smoke done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
