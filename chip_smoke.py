#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit; build every CUDA kernel from
     ``src/repro_torch/kernels/*/csrc/*.cu`` with nvcc for sm_90a;
  2. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes (tinyllama-1.1b full width: token row 11264,
     chunk 16, B = 8, P = 32, 4608 blocks): K1-K3 bit for bit (K1 and K2
     one device kernel a call, by torch.profiler; K2 also with no block
     and every block masked), K4 -- also at kimi-k2's attention (Hkv 8,
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
     of the final state bit for bit, over the litmus, fft at 16 cores
     (both protocols), the tiny-cache geometry, ts_bits=4, the E-state,
     Ackwise k = 4 and speculation off: ms and us a simulated step of K9
     and of the plain loop, bound by its steps times one dependent L2
     round trip (the same source's pointer-chase probe);
  3. the simulator path: every golden run (``tests/data/
     torch_sim_golden.json``: fig4's 48 runs at 64 cores and scale 1.0,
     fig8's 6 at 256 cores) through ``repro_torch.core.simulate`` on the
     card, each one K9 launch and one host sync, bit-identical to its
     entry and SC-clean; wall ms, steps and us a step each, fig4's and
     fig8's averages as ``benchmarks/paper_figs.py`` computes them; then
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
     tables and home pages sit on the card) at the same width and depth,
     every host on the paged path's pool and the same weight tensors: fleet
     A (2 mixed hosts, 2 shards; requests 0-3 on host 0, then 4-7 on host
     1) and fleet B (prefill, decode, decode; 4 shards; routed), each with
     the launch counts set to 0 before and read after (K1-K4, K6, K8 must
     launch), zero multicasts and invalidation messages, at most one
     message pair per remote shard a wave, host 1's prefix from migrated
     pages (A) and no cold prefill on a decode pod (B), every migrated
     page bit-identical to its home row, the device syncs a directory
     wave costs (``torch.cuda.set_sync_debug_mode``), then each warm and
     then profiled (the card's activity only);
     then the fixed-wave dense-cache path, twice at full width and depth:
     tinyllama-1.1b with prefix_reuse=False and zamba2-2.7b (hybrid, its
     default metadata-only prefix leases), each with 4 replicas, 4096-slot
     dense caches and 8 requests of 2048-3072 random prompt tokens and 16
     new tokens -- launch counts set to 0 before each run and read after
     (K5 must launch on both), one decode step as on the paged path (K8:
     tinyllama 1 plain + 44 add, zamba2 54 gate + 19 add), then each again
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
bf16 products at 989 TFLOP/s; fp32 inputs on its SIMT variant, timed
beside its fp32 bound), K8 (RMSNorm) in each of its variants (plain; add:
the residual add fused in, h equal to the eager add bit for bit; gate:
Mamba2's rmsnorm(y * silu(z))) at the prefill rows (4 x 3072) of
tinyllama's norms and zamba2's, and at decode's rows, every (row, w)
dtype mix, the plain one against ``F.rms_norm`` and the fused ones beside
the eager chain they replace (``unfused_ms``).  K6's bound takes the
bf16 tensor-core peak (989 TFLOP/s).  Phase 3 asserts that K6 and K8
launch on the paged path and both wave paths and K7 on zamba2's, and
K1-K4, K6 and K8 on the kimi-k2 paged path.

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
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
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
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))}


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
    # K6's bf16 variant must issue wgmma (HGMMA in the library's SASS),
    # K4's and K7's tensor-core variants mma.sync (HMMA)
    n_hgmma = sum(sass_counts(lib, "HGMMA").values())
    log(f"cuobjdump -sass {lib.name}: {n_hgmma} HGMMA instructions")
    assert n_hgmma, "no HGMMA in the kernel library: K6 issues no wgmma"
    hmma = sass_counts(lib, "HMMA")
    for kernel in ("paged_decode_mma", "ssd_chunk_mma"):
        found = {f: n for f, n in hmma.items() if kernel in f}
        log(f"  HMMA in {kernel}: {len(found)} instances, "
            f"{sorted(found.values())} instructions")
        assert found and all(found.values()), f"no HMMA in {kernel}"
    return smi


def sass_counts(lib, opcode):
    """{kernel function: instructions of ``opcode``} in the library's SASS
    (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn and any(t.startswith(opcode + ".") or t == opcode
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
    # --- K2 write_advance, its kernels a call counted before any CUDA graph
    # is captured: after one the profiler showed none for it ------------
    mask = masks[0]
    for m in (mask, torch.zeros_like(mask), torch.ones_like(mask)):
        got = K.write_advance(wts, rts, m, 500)
        want = R.write_advance_ref(wts, rts, m, 500)
        for x, y in zip(got, want):
            assert torch.equal(x, y), "K2 write_advance differs from plain"
    per_call = device_kernels(lambda: K.write_advance(wts, rts, mask, 500))
    log(f"K2 write_advance: device kernels in one call: {per_call}")
    assert list(per_call.values()) == [1] and "write_advance" in next(
        iter(per_call)), f"K2 runs {per_call} a call, not one kernel"
    # one launch per call: no fill of the outputs before the kernel
    per_call = device_kernels(lambda: K.lease_pass(wts, rts, req, masks, pts,
                                                   64))
    log(f"K1 lease_pass: device kernels in one call: {per_call}")
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
    for idx, lo in ((sidx, 0), (dup, 0), (dup, 2560)):
        w = token_row - lo
        r = tok[:, :w].contiguous()
        a = view.clone()
        c = view.clone()
        K.scatter_rows(a, idx, r, col_lo=lo)
        R.scatter_rows_ref(c, idx, r, lo)
        assert torch.equal(a.view(torch.int16), c.view(torch.int16)), \
            f"K3 scatter (col_lo={lo}) differs from plain"
    del a, c
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
    # ... and at the moe configs' attention shapes over pools of 2 layers:
    # kimi-k2 (Dh 112, G 8; its moe stack's segment at offset 1792 of the
    # token row, after the leading dense stack's) and arctic (Dh 128, G 7)
    for name, path, arch in (("paged_decode.kimi", "kimi-k2-1t-a32b",
                              "kimi-k2-1t-a32b"),
                             ("paged_decode.arctic", "arctic-480b",
                              "arctic-480b")):
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
    for r in rows:
        r["route"] = "cuda"
        r["launch_ms"] = launch_ms
        _log_row(r)
    log(f"  (one PyTorch launch of a 1-element add: {launch_ms * 1e3:.2f} us)")
    del pool, view


def k4_row(rows, g, name, path, view, b, hkv, grp_q, dh, p_max, chunk,
           k_off, v_off):
    """K4 against its plain version over the pool rows ``view`` at one
    attention shape -- bf16 on its tensor-core variant within 3e-2 and one
    bf16 rounding step, fp32 on its SIMT variant within 2e-4 -- then its
    row: device time beside gather + SDPA (a yardstick the port never
    calls) and its bound."""
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
    for tag, qd, tol in (("bf16", torch.bfloat16, BF16),
                         ("fp32", torch.float32, FP32)):
        pv = view if qd == torch.bfloat16 else view.float()
        args = (q.to(qd), ck.to(qd), cv.to(qd), pv, page_rows, lengths)
        got, variant = variant_of(DK.paged_decode, lambda: DK.paged_decode(
            *args, chunk=chunk, k_off=k_off, v_off=v_off))
        # bf16: the tensor-core variant; fp32: the SIMT variant
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
        f"fp32: SIMT)")
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
        + (f"; {r['variant']} variant]" if r.get("variant") else "]"))


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
    path's suffix prefill (16 queries at q_offset 64 in an 80-slot cache);
    K7 at zamba2's scan (b 4, 12 chunks of 256, 80 heads, state 64, head
    dim 64), over the conv output's column views as the model passes them;
    K8 at the prefill rows of tinyllama's norms and zamba2's gated norm and
    at one decode step's rows.  The plain versions of K6 run one request
    at a time (one request's fp32 scores alone are 1.2 GB)."""
    import torch
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
            # suffix and a cold 64-token prompt
            ("flash_prefill.kimi_suffix", "kimi-k2-1t-a32b", 1, 16, 80, 64,
             8, 112, 64, 80, (("bf16", b16, BF16), ("fp32", f32, FP32))),
            ("flash_prefill.kimi_cold", "kimi-k2-1t-a32b", 1, 64, 64, 64, 8,
             112, 0, 64, (("bf16", b16, BF16), ("fp32", f32, FP32)))):
        q32, k32, v32 = randn(b, sq, h, dh), randn(b, skv, hkv, dh), \
            randn(b, skv, hkv, dh)
        kw = dict(causal=True, q_offset=q_off, kv_len=kv_len)

        def plain(q, k, v, kw=kw, b=b):
            return torch.cat([flash_attention_ref(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], **kw) for i in range(b)])

        errs = {}
        for tag, dt, tol in checks:
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            got = FK.flash_prefill(q, k, v, **kw)
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
            # the fp32 pair runs the SIMT variant: its time and fp32 bound
            q, k, v = q32, k32, v32
            ms = graph_ms(lambda: FK.flash_prefill(q, k, v, **kw), 5)
            log(f"  {name} fp32: {ms * 1e3:.2f} us, bound "
                f"{bound(0, nops)[0] * 1e3:.3f} us (operations at 67 "
                f"TFLOP/s fp32)")
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
            f"H={h} Hkv={hkv} dh={dh} bf16",
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
                                     ("fp32", f32, "simt")):
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
            # the fp32 pair runs the SIMT variant: its time and fp32 bound
            ms = graph_ms(lambda: SK.ssd_chunk(xs, dt, cum, bs, cs,
                                               chunk=chunk), 5)
            log(f"  ssd_chunk fp32 (SIMT variant): {ms * 1e3:.2f} us, bound "
                f"{bound(0, nops)[0] * 1e3:.3f} us (operations at 67 TFLOP/s "
                f"fp32)")
        del conv, xs, bs, cs
    log(f"K7 ssd_chunk max |err|: {errs} (bf16: tensor-core variant; fp32: "
        f"SIMT)")
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
    avgs = prof.key_averages()
    dev_rows = [e for e in avgs if e.device_type == DeviceType.CUDA]
    host_rows = [e for e in avgs if e.device_type == DeviceType.CPU]
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
    # every K4 launch of the bf16 path on the tensor-core variant
    assert variants["paged_decode"] == {"mma": counts["paged_decode"]}, \
        f"K4 launches by variant: {variants['paged_decode']}"
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


def l2_round_trip_ms(hops=20000, reps=5):
    """One dependent L2 round trip on this card: K9's source's probe
    follows a random cycle over 4 MB (L2-resident, past L1) through
    ``ld.global.cg``; median of ``reps`` runs of ``hops`` loads."""
    import torch
    from repro_torch.kernels.coherence_sim.kernel import l2_chase
    n = 1 << 20
    g = torch.Generator().manual_seed(SEED)
    perm = torch.randperm(n, generator=g)
    nxt = torch.empty(n, dtype=torch.int64)
    nxt[perm] = perm.roll(-1)
    nxt = nxt.to(torch.int32).cuda()
    nxt.sum()                                   # bring it into L2
    l2_chase(nxt, hops)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        l2_chase(nxt, hops)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / hops)
    return sorted(times)[len(times) // 2]


def phase2_coherence_sim(rows):
    """K9 against its plain loop on the card, every tensor of the final
    state bit for bit: the litmus (both protocols), fft at 16 cores and
    scale 0.1 (both), the tiny-cache geometry, ts_bits=4, the E-state,
    Ackwise (k = 4) and speculation off.  ms and us a simulated step of
    each (K9: CUDA events around its one launch; the plain loop: the
    host's clock, synchronised); the row's numbers are the fft / Tardis
    run's, its bound that run's steps times one L2 round trip."""
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
    log(f"  one dependent L2 round trip (K9's probe): {t_l2 * 1e6:.1f} ns")
    row = None
    for label, tr, proto, geom_kw, cfg_kw in cases:
        geom, state = _sim_case_state(tr, proto, geom_kw, **cfg_kw)
        got, want = state(), state()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        CK.sim_run(got, geom, proto)
        b.record()
        torch.cuda.synchronize()
        k9_ms = a.elapsed_time(b)
        t0 = time.perf_counter()
        sim_run_ref(want, geom, proto)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        fa, fb = _flat(got), _flat(want)
        err = max(max_err(fa[k], fb[k]) for k in fa)
        bad = [k for k in fa if not torch.equal(fa[k], fb[k])]
        steps = int(got["steps"])
        log(f"  K9 {label}: {steps} steps; K9 {k9_ms:.3f} ms = "
            f"{k9_ms / steps * 1e3:.3f} us/step, plain {plain_ms:.1f} ms = "
            f"{plain_ms / steps * 1e3:.1f} us/step; "
            + ("bit-identical" if not bad else f"DIFFERS in {bad}"))
        assert not bad, f"K9 ({label}) differs from its plain loop: {bad}"
        if label == "fft16/tardis":
            fresh = [state() for _ in range(5)]
            torch.cuda.synchronize()
            times, calls = [], []
            for st in fresh:
                a.record()
                t0 = time.perf_counter()
                CK.sim_run(st, geom, proto)
                b.record()
                torch.cuda.synchronize()
                calls.append((time.perf_counter() - t0) * 1e3)
                times.append(a.elapsed_time(b))
            row = dict(name="sim_run", route="cuda", path="simulator",
                       source="src/repro_torch/kernels/coherence_sim/csrc/"
                       "sim_run.cu",
                       replaces="src/repro/core/simulator.py:570 "
                       "(lax.while_loop; no Pallas kernel)",
                       max_abs_err=err, ms=sorted(times)[2],
                       call_ms=sorted(calls)[2], plain_ms=plain_ms,
                       bound_ms=steps * t_l2, bound_by="serial steps",
                       library_ms=None, launch_ms=None,
                       shape=f"fft, 16 cores, scale 0.1, Tardis: {steps} "
                       f"steps; us/step K9 {sorted(times)[2] / steps * 1e3:.3f}"
                       f", plain {plain_ms / steps * 1e3:.1f}, L2 round trip "
                       f"{t_l2 * 1e6:.1f} ns")
        del got, want
    rows.append(row)
    _log_row(row)


def phase3_simulator_path(smi):
    """Every golden run (fig4: 12 benchmarks x {MSI, Ackwise k=4, Tardis,
    Tardis without speculation} at 64 cores and scale 1.0; fig8: fmm, fft
    and lu_c at 256 cores and scale 0.08 under MSI and Tardis) through
    ``repro_torch.core.simulate`` on the card, each on its stored trace
    (``tests/data/torch_sim_traces.npz``: the reference's inputs, which
    this machine's numpy need not regenerate -- the generators it does
    reproduce are printed): each exactly one K9 launch and one host sync
    (``torch.cuda.set_sync_debug_mode``), bit-identical to its golden
    entry (stats, cycles, ops, aborted, pts, the log's sha256s, steps)
    and SC-clean (``check_sc``); wall ms, steps and us a step each; then
    fig4's and fig8's averages as ``benchmarks/paper_figs.py`` computes
    them.  Returns the launch counts of the runs."""
    import warnings

    import numpy as np
    import torch
    from repro_torch.core import SimConfig, Trace, make_trace, simulate
    from repro_torch.core.check import check_sc
    from repro_torch.kernels import launch_counts, reset_launch_counts
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
        got = result_entry(res)
        bad = [k for k in ("stats", "cycles", "ops", "aborted", "pts",
                           "log_n", "log_sha256") if got[k] != entry[k]]
        if res.steps != entry["steps"]:
            bad.append("steps")
        check_sc(res.log, entry["n_cores"])
        walls.append((wall, res.steps))
        log(f"  {entry['key']:36s} {wall:9.2f} ms wall, {res.steps:6d} "
            f"steps, {wall / res.steps * 1e3:6.3f} us/step, {launches} "
            f"launch, {syncs} sync, SC clean, "
            + ("bit-identical to golden" if not bad else f"DIFFERS: {bad}"))
        assert launches == 1 and syncs == 1, (entry["key"], launches, syncs)
        assert not bad, f"{entry['key']} differs from its golden entry: {bad}"
        res_by_key[entry["key"]] = res
    counts = launch_counts()
    wall = sum(w for w, _ in walls)
    steps = sum(n for _, n in walls)
    log(f"simulator path on {smi}: {len(walls)} runs, {steps} steps in "
        f"{wall:.1f} ms wall = {wall / steps * 1e3:.3f} us/step; K9 "
        f"launches {counts['sim_run']}")
    # one run's breakdown: K9's device time (CUDA events around the one
    # launch) against simulate's wall time for the same run
    from repro_torch.kernels.coherence_sim.kernel import sim_run
    entry = next(e for e in golden["runs"] if e["key"] == "fig4/fft/tardis")
    geom, state = _sim_case_state(traces[trace_key(entry)], "tardis")
    st = state()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    sim_run(st, geom, "tardis")
    b.record()
    torch.cuda.synchronize()
    k9_ms = a.elapsed_time(b)
    run_ms = next(w for (w, _), e in zip(walls, golden["runs"])
                  if e is entry)
    log(f"  fig4/fft/tardis: K9 {k9_ms:.2f} ms on the card of simulate's "
        f"{run_ms:.2f} ms wall ({k9_ms / run_ms:.3f}; the rest: state "
        f"set-up, launch, one read-back)")

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
    return counts


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
    """Fleets A and B at full width and depth (tinyllama-1.1b, bf16
    weights from seed 0, every host sharing the same weight tensors), the
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
    cfg = get_arch("tinyllama-1.1b")
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
            f"({cfg.n_layers} layers), {len(done)} requests served, "
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


# The fixed-wave dense-cache path: (arch, ServingCluster kwargs)
WAVE_PATHS = (("tinyllama-1.1b", dict(prefix_reuse=False)),
              ("zamba2-2.7b", {}))


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
    """The fixed-wave path at full width and depth, once per configuration
    with the launch counts set to 0 just before and read just after, one
    decode step's launches (``_hold_step``), then warm and profiled.
    Returns {arch: (launch counts, launches by variant)}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.models import init_params, param_leaves
    out = {}
    for arch, kw in WAVE_PATHS:
        cfg = get_arch(arch)
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
        # every K7 launch of the bf16 path on the tensor-core variant
        assert variants["ssd_chunk"] == ({"mma": counts["ssd_chunk"]}
                                         if counts["ssd_chunk"] else {}), \
            f"K7 launches by variant: {variants['ssd_chunk']}"
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
    """The paged path serving kimi-k2 at full width (``kimi_config``), the
    weights of the earlier paths freed first: the launch counts set to 0
    just before the run and read just after (K1-K4, K6, K8; every K4
    launch on the tensor-core variant at Dh 112), the card's peak memory,
    one decode step's launches, then warm and profiled.  Returns (launch
    counts, launches by variant)."""
    import numpy as np
    import torch
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.models import init_params, param_leaves
    cfg = kimi_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, torch.bfloat16)
    torch.cuda.synchronize()
    leaves = param_leaves(params)
    n_par = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"kimi-k2 weights on {smi}: {n_par / 1e9:.3f} B params, "
        f"{n_bytes / 1e9:.2f} GB, drawn in {time.perf_counter() - t0:.1f} s; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    reset_launch_counts()
    cluster, done, report, dt = _serve(cfg, params, "cuda", 4096, 512)
    counts = launch_counts()
    variants = variant_counts()
    n_tok = sum(len(r.output) for r in done)
    assert all(r.done and len(r.output) == r.max_new for r in done)
    assert all(0 <= int(t) < cfg.vocab for r in done for t in r.output)
    assert bool(torch.isfinite(cluster.prefix_engine._kv_pool).all())
    assert report["prefix_prefill_tokens_skipped"] > 0, "no prefix hit"
    assert report["kv_pool_stacks"] == "dense,moe", report["kv_pool_stacks"]
    assert (report["pool_tokens_appended_dense"]
            == report["pool_tokens_appended_moe"]
            == report["kv_tokens_appended"] > 0)
    log(f"kimi-k2 paged path on {smi}: full width ({cfg.n_layers} layers: "
        f"{cfg.first_dense_layers} dense + "
        f"{cfg.n_layers - cfg.first_dense_layers} moe, d_model "
        f"{cfg.d_model}, Dh {cfg.head_dim()}, {cfg.n_experts} experts "
        f"top-{cfg.top_k}), {len(done)} requests served, {n_tok} tokens in "
        f"{dt:.2f} s = {n_tok / dt:.1f} tokens/s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"coherence_report (kimi-k2) on {smi}: " + json.dumps(
        {k: (int(v) if isinstance(v, (int, np.integer)) else v)
         for k, v in report.items()}))
    log(f"launches on the kimi-k2 paged path: {counts}")
    log(f"launches by variant on the kimi-k2 paged path: {variants}")
    missing = [k for k in PAGED_KERNELS if counts[k] <= 0]
    assert not missing, f"kernels never launched on the kimi path: {missing}"
    assert variants["paged_decode"] == {"mma": counts["paged_decode"]}, \
        f"K4 launches by variant (kimi): {variants['paged_decode']}"
    del cluster
    torch.cuda.empty_cache()
    _hold_step("paged path, kimi-k2-1t-a32b", cfg, params, "paged")
    profile_path("kimi-k2 paged path", lambda: _serve(
        cfg, params, "cuda", 4096, 512), smi)
    del params, leaves
    torch.cuda.empty_cache()
    return counts, variants


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
    for (arch, kw), n_layers, dtype in zip(
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
    phase2_coherence_sim(rows)
    stamp("phase 2")
    sim_counts = phase3_simulator_path(smi)
    stamp("phase 3 (simulator path)")
    counts, variants, _tps = phase3_main_path(smi)
    stamp("phase 3 (paged path)")
    phase3_multi_host(smi)
    stamp("phase 3 (multi-host fleets)")
    wave_counts = phase3_wave_paths(smi)
    stamp("phase 3 (wave paths)")
    kimi_counts = phase3_kimi_path(smi)
    stamp("phase 3 (kimi-k2 paged path)")
    phase4_card_vs_cpu(smi)
    stamp("phase 4 (paged path)")
    phase4_fleet_card_vs_cpu(smi)
    stamp("phase 4 (fleet A lane)")
    phase4_card_vs_cpu(smi, lane="kimi")
    stamp("phase 4 (kimi-k2 paged lane)")
    phase4_wave_card_vs_cpu(smi)
    stamp("phase 4 (wave paths)")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "call_ms", "launch_ms", "shape", "variant",
            "unfused_ms")
    # each kernel's launches on the path its row names (K1-K4: the paged
    # main path); K8's rows count their variant's
    # (arctic's K4 row: no path serves arctic on the card, 0 launches)
    path_counts = {"paged": (counts, variants), KIMI: kimi_counts,
                   "simulator": (sim_counts, {}), **wave_counts}
    for r in rows:
        c, v = path_counts.get(r.get("path", "paged"), ({}, {}))
        wrapper = r.get("wrapper", r["name"])
        r["launches"] = (v.get(wrapper, {}).get(r["variant"], 0)
                         if wrapper == "rmsnorm" else c.get(wrapper, 0))
        r.setdefault("variant", None)
        r.setdefault("unfused_ms", None)
    log(f"chip_smoke done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
