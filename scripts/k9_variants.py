#!/usr/bin/env python3
"""K9's design choices, timed against each other on one NVIDIA card.

    python3 scripts/k9_variants.py [VARIANT ...]

Each variant is ``src/repro_torch/kernels/coherence_sim/csrc/sim_run.cu``
with one edit (below), built with the build's flags into its own library
under ``build/k9_variants/``.  Every golden run (``tests/data/
torch_sim_golden.json``: fig4's 48 at 64 cores, fig8's 6 at 256) is run by
each variant twice, the order reversed the second time, on a fresh
``init_state``; K9 alone is timed (CUDA events, the card kept busy while
the host prepares the launch), and every variant's final state must equal
the first variant's, tensor for tensor.  Prints ms and µs a simulated step
per variant (all runs, fig4, fig8) as one JSON line each.

  base        the source as it is
  early       the LLC set's wave (and, under the directory, its sharer
              rows and mem_ver[addr]) issued before the L1 lookup,
              whatever it finds
  packed      the scheduler's argmin as one reduction of (clock << 8 |
              core) where the smallest clock is in [0, 2^23), else two
  lane_branch an L1 way's loads made by lanes 0 .. W1-1 behind a branch
              (the others hold an invalid way) instead of by every lane
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)

SRC = ROOT / "src/repro_torch/kernels/coherence_sim/csrc/sim_run.cu"


def _swap(s, old, new):
    if s.count(old) != 1:
        raise SystemExit(f"k9_variants: anchor not found once: {old[:60]!r}")
    return s.replace(old, new)


def early(s):
    s = _swap(s, """  // the requester's reads, issued with the L1 lookup
  const int sc_addr""", """  const int rL = llc_set_of(S, addr) * S.w2;
  const LlcWay mine = load_llc_way(S, lane, 0, rL);
  const int mem_ver_addr = S.mem_ver[addr];
  const int sc_addr""")
    s = _swap(s, """    const bool v1_excl = !hit1 && line_st == EXCLUSIVE;
    const int rL = llc_set_of(S, addr) * S.w2;
    const int rV = v1_excl ? llc_set_of(S, line_tag) * S.w2 : -1;
    const LlcWay mine = load_llc_way(S, lane, 0, rL);
    const LlcWay vway = load_llc_way(S, lane, S.w2, rV);
    const int mem_ver_addr = S.mem_ver[addr];""", """    const bool v1_excl = !hit1 && line_st == EXCLUSIVE;
    const int rV = v1_excl ? llc_set_of(S, line_tag) * S.w2 : -1;
    const LlcWay vway = load_llc_way(S, lane, S.w2, rV);""")
    s = _swap(s, """  // the store counter, issued with the L1 lookup
  const int sc_addr""", """  const int rL = llc_set_of(S, addr) * S.w2;
  const LlcWay mine = load_llc_way(S, lane, 0, rL);
  SharerRows raw;
  load_sharer_rows(S, lane, rL, raw);
  const int mem_ver_addr = S.mem_ver[addr];
  const int sc_addr""")
    return _swap(s, """    const int rL = llc_set_of(S, addr) * S.w2;
    const int rV = v1_valid ? llc_set_of(S, line_tag) * S.w2 : -1;
    const LlcWay mine = load_llc_way(S, lane, 0, rL);
    SharerRows raw;
    load_sharer_rows(S, lane, rL, raw);
    const LlcWay vway = load_llc_way(S, lane, S.w2, rV);
    const int mem_ver_addr = S.mem_ver[addr];""", """    const int rV = v1_valid ? llc_set_of(S, line_tag) * S.w2 : -1;
    const LlcWay vway = load_llc_way(S, lane, S.w2, rV);""")


def packed(s):
    return _swap(s, """    const int min_v = __reduce_min_sync(kFull, best_v);
    const int i = __reduce_min_sync(kFull, best_v == min_v ? best_c
                                                           : kIntMax);""",
                 """    const int packed = best_v < 0 ? kIntMin
                     : best_v < (1 << 23) ? (best_v << 8) | best_c : kIntMax;
    const int min_p = __reduce_min_sync(kFull, packed);
    int i;
    if (min_p != kIntMin && min_p != kIntMax) {
      i = min_p & 0xff;
    } else {
      const int min_v = __reduce_min_sync(kFull, best_v);
      i = __reduce_min_sync(kFull, best_v == min_v ? best_c : kIntMax);
    }""")


def lane_branch(s):
    return _swap(s, """  const int e = r + min(lane, S.w1 - 1);
  return {S.l1_tag[e], S.l1_st[e], S.l1_wts[e], S.l1_rts[e], S.l1_ver[e],
          S.l1_lru[e], S.l1_dirty[e]};""", """  Line l{-1, INVALID, 0, 0, 0, kIntMax, 0};
  if (lane < S.w1) {
    const int e = r + lane;
    l = {S.l1_tag[e], S.l1_st[e], S.l1_wts[e], S.l1_rts[e], S.l1_ver[e],
         S.l1_lru[e], S.l1_dirty[e]};
  }
  return l;""")


VARIANTS = {"base": lambda s: s, "early": early, "packed": packed,
            "lane_branch": lane_branch}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k9_variants: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import Geometry, SimConfig, Trace
    from repro_torch.core.simulator import init_state
    from repro_torch.kernels import _build as b
    from repro_torch.kernels.coherence_sim import kernel as CK
    sys.path.insert(0, str(ROOT / "scripts"))
    from sim_golden import load_traces, trace_key
    names = sys.argv[1:] or list(VARIANTS)
    out_dir = ROOT / "build" / "k9_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    procs = []
    for name in names:
        cu = out_dir / f"sim_run_{name}.cu"
        cu.write_text(VARIANTS[name](src))
        so = cu.with_suffix(".so")
        procs.append((name, so, subprocess.Popen(
            [b._nvcc(), *b.NVCC_FLAGS, f"-I{b.INCLUDE}", "-shared", "-o",
             str(so), str(cu)])))
    libs = {}
    for name, so, p in procs:
        if p.wait():
            raise SystemExit(f"k9_variants: {name} did not build")
        libs[name] = ctypes.CDLL(str(so))
        libs[name].tardis_sim_run.argtypes = b.SIGNATURES["tardis_sim_run"]
    golden = json.loads(chip_smoke.SIM_GOLDEN.read_text())
    traces = load_traces(Trace)
    ms = {n: {"fig4": 0.0, "fig8": 0.0} for n in libs}
    steps = {"fig4": 0, "fig8": 0}
    for entry in golden["runs"]:
        tr = traces[trace_key(entry)]
        cfg = SimConfig(max_steps=golden["max_steps"], **entry["config"])
        geom = dataclasses.replace(
            Geometry(n_cores=tr.n_cores), n_cores=tr.n_cores,
            trace_len=tr.length, n_addr=max(Geometry().n_addr,
                                            int(tr.n_addr)),
            log_size=int(min(cfg.max_steps, tr.total_ops() * 8 + 4096)))
        directory = entry["proto"] == "directory"
        variant = CK.pick_variant(geom)
        first = None
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                st = init_state(geom, tr, cfg.as_tensors("cuda"),
                                directory=directory, device="cuda")
                _dev, tensors = CK._tensors(st, geom, directory)
                ptrs = (ctypes.c_void_p * len(tensors))(
                    *[CK.ptr(t).value or 0 for _k, t in tensors])
                ints = [geom.n_cores, geom.l1_sets, geom.l1_ways,
                        geom.llc_sets, geom.llc_ways, geom.n_addr,
                        geom.trace_len, geom.log_size, geom.grid]
                cints = (ctypes.c_int * len(ints))(*ints)
                torch.cuda.synchronize()
                torch.cuda._sleep(chip_smoke.K9_SLEEP_CYCLES)
                a = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                a.record()
                err = libs[name].tardis_sim_run(
                    ptrs, len(tensors), cints, len(ints), int(directory),
                    int(variant == "smem"), CK.smem_bytes(geom, variant),
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                e.record()
                torch.cuda.synchronize()
                if err:
                    raise SystemExit(f"k9_variants: {name} launch error {err}")
                ms[name][entry["fig"]] += a.elapsed_time(e) / 2
                flat = chip_smoke._flat(st)
                if first is None:
                    first = flat
                    steps[entry["fig"]] += int(st["steps"])
                elif any(not torch.equal(flat[k], first[k]) for k in flat):
                    raise SystemExit(f"k9_variants: {name} differs on "
                                     f"{entry['key']}")
    total = steps["fig4"] + steps["fig8"]
    for name in libs:
        t = ms[name]
        print(json.dumps({
            "variant": name, "card": torch.cuda.get_device_name(0),
            "ms": t["fig4"] + t["fig8"],
            "us_per_step": (t["fig4"] + t["fig8"]) / total * 1e3,
            "fig4_us_per_step": t["fig4"] / steps["fig4"] * 1e3,
            "fig8_us_per_step": t["fig8"] / steps["fig8"] * 1e3}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
