#!/usr/bin/env python3
"""Where K9's simulated step spends its cycles, on one NVIDIA card.

    python3 scripts/k9_phase_profile.py

Builds an instrumented copy of ``src/repro_torch/kernels/coherence_sim/
csrc/sim_run.cu`` into ``build/k9_profile/`` -- lane 0 reads ``clock64()``
at each phase boundary of the loop and of the Tardis transaction and adds
the cycles since the last boundary into a shared-memory counter -- and runs
it on fft at 16 cores (scale 0.1, both protocols) and on fig4/fft and
fig8/fft from the stored golden traces, in each K9 variant that takes the
state.  Prints, a run a line, the cycles a step of each phase (a directory
transaction counts as one phase, "transaction") and the loop's cycles and
ns a step by ``%globaltimer``; then the SASS opcode histogram of each
``sim_run_kernel`` of the library (``cuobjdump -sass``).  Each boundary
costs lane 0 a branch, a clock read and a shared-memory add (~100 cycles
a boundary, ~1,800 a step on an H100): compare phases, not the total, with
the kernel's uninstrumented time.  The copy is made by inserting the probes
at anchor lines of the source; the script fails on an anchor it does not
find.
"""
from __future__ import annotations

import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)

SRC = ROOT / "src/repro_torch/kernels/coherence_sim/csrc/sim_run.cu"
HEADER = """
__shared__ long long s_prof[32];
__shared__ long long s_last;
__device__ long long g_prof[32];
#define PROF(k) do { if (threadIdx.x == 0) { long long _n = clock64(); \\
  s_prof[k] += _n - s_last; s_last = _n; } } while (0)
"""
# (phase ending at the probe, anchor, where the probe goes)
PROBES = (
    ("scheduler",
     "    const bool none_runnable = !__any_sync(kFull, run != 0);\n",
     "after"),
    ("op", "    const int addr = min(max(op.addr, 0), S.n_addr - 1);\n",
     "after"),
    ("requester reads",
     "  const int old_maxts_llc = S.maxts_llc[bank], "
     "bts_llc = S.bts_llc[bank];\n", "after"),
    ("L1 lookup", "  const bool needs_llc = !l1_ok;\n  const bool renewal",
     "line"),
    ("LLC wave, picks",
     "    const int L_st = L.st, L_tag = L.tag, owner = L.owner;\n",
     "after"),
    ("owner lookup", "    int mts_bank = S.mts[bank];\n", "before"),
    ("sync", "    int mts_bank = S.mts[bank];\n    __syncwarp();", "line2"),
    ("LLC writes", "    // ---- L1 victim write-back ----\n", "before"),
    ("L1 victim",
     "    // ---- latency & traffic ----\n    const int hop_c = C.hop;\n"
     "    const int d_ib = hop(S, i, bank);\n    const int d_bo = owned ?",
     "before"),
    ("latency, traffic", "  // ---- requester L1 + timestamps", "before"),
    ("requester sync", "  __syncwarp();\n  const bool pw", "line"),
    ("requester writes", "  // ---- timestamp-compression accounting ----\n",
     "before"),
    ("timestamps", "  bump(stats[ST_RENEW], renewal);\n", "before"),
    ("transaction",
     "    // ---- spin backoff, self-increment, clock / idx advance ----\n",
     "before"),
    ("end of step", "    // ---- the trace read ahead", "before"),
    ("read ahead",
     "    // ---- barrier: all arrived (or done) -> release ----\n", "before"),
    ("barrier", "    bump(stats[ST_OPS_DONE], advance && is_mem);\n",
     "before"),
    ("stats, log", "      ++log_n;\n    }\n", "after"),
)


def instrumented() -> str:
    s = SRC.read_text()
    s = s.replace("constexpr unsigned kFull",
                  HEADER + "constexpr unsigned kFull", 1)
    for k, (_name, anchor, where) in enumerate(PROBES):
        if anchor not in s:
            raise SystemExit(f"k9_phase_profile: anchor not found: {anchor!r}")
        i = s.index(anchor)
        if where == "after":
            i += len(anchor)
        elif where in ("line", "line2"):
            for _ in range(1 if where == "line" else 2):
                i = s.index("\n", i) + 1
        s = s[:i] + f"PROF({k});\n" + s[i:]
    start = ("  if (threadIdx.x == 0) { for (int k = 0; k < 32; ++k) "
             "s_prof[k] = 0; s_last = clock64(); }\n"
             "  long long _t0 = clock64(); unsigned long long _g0;\n"
             "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(_g0));\n")
    anchor = "  int pend_c = -1;"
    if anchor not in s:
        raise SystemExit("k9_phase_profile: anchor not found: pend_c")
    s = s.replace(anchor, start + anchor, 1)
    stop = ("  if (threadIdx.x == 0) { unsigned long long _g1;\n"
            "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(_g1));\n"
            "    for (int k = 0; k < 30; ++k) g_prof[k] = s_prof[k];\n"
            "    g_prof[30] = clock64() - _t0; g_prof[31] = _g1 - _g0; }\n")
    anchor = "  // ---- the state back to its tensors ----\n"
    if anchor not in s:
        raise SystemExit("k9_phase_profile: anchor not found: copy-out")
    s = s.replace(anchor, stop + anchor, 1)
    return s + """
extern "C" int tardis_prof_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
"""


def sass_histograms(lib):
    cuobjdump = Path(_build()._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    fn, hist = None, {}
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            hist[fn] = collections.Counter()
        elif fn and "sim_run_kernel" in fn:
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]+)", line)
            if m:
                hist[fn][m.group(2).split(".")[0]] += 1
    return {f: h for f, h in hist.items() if h}


def _build():
    from repro_torch.kernels import _build as b
    return b


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k9_phase_profile: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import Trace, make_trace
    from repro_torch.kernels.coherence_sim import kernel as CK
    sys.path.insert(0, str(ROOT / "scripts"))
    from sim_golden import load_traces, trace_key
    b = _build()
    out_dir = ROOT / "build" / "k9_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "sim_run_profiled.cu"
    src.write_text(instrumented())
    so = out_dir / "libk9_profile.so"
    subprocess.run([b._nvcc(), *b.NVCC_FLAGS, f"-I{b.INCLUDE}", "-shared",
                    "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.tardis_sim_run.argtypes = b.SIGNATURES["tardis_sim_run"]
    lib.tardis_prof_read.argtypes = [ctypes.c_void_p]
    golden = json.loads(chip_smoke.SIM_GOLDEN.read_text())
    traces = load_traces(Trace)
    fft16 = make_trace("fft", 16, scale=0.1)
    runs = {"fft16/tardis": (fft16, "tardis"),
            "fft16/directory": (fft16, "directory")}
    for key in ("fig4/fft/tardis", "fig4/fft/directory", "fig8/fft/tardis"):
        entry = next(e for e in golden["runs"] if e["key"] == key)
        runs[key] = (traces[trace_key(entry)], entry["proto"])
    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    for label, (tr, proto) in runs.items():
        geom, state = chip_smoke._sim_case_state(tr, proto)
        for variant in CK.VARIANTS:
            if CK.smem_bytes(geom, variant) > CK.SMEM_LIMIT:
                continue
            st = state()
            directory = proto == "directory"
            _dev, tensors = CK._tensors(st, geom, directory)
            ptrs = (ctypes.c_void_p * len(tensors))(
                *[CK.ptr(t).value or 0 for _k, t in tensors])
            ints = [geom.n_cores, geom.l1_sets, geom.l1_ways, geom.llc_sets,
                    geom.llc_ways, geom.n_addr, geom.trace_len,
                    geom.log_size, geom.grid]
            cints = (ctypes.c_int * len(ints))(*ints)
            torch.cuda.synchronize()
            err = lib.tardis_sim_run(
                ptrs, len(tensors), cints, len(ints), int(directory),
                int(variant == "smem"), CK.smem_bytes(geom, variant),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            torch.cuda.synchronize()
            assert err == 0, err
            prof = (ctypes.c_longlong * 32)()
            assert lib.tardis_prof_read(prof) == 0
            steps = int(st["steps"])
            phases = {name: round(prof[k] / steps)
                      for k, (name, _a, _w) in enumerate(PROBES)
                      if prof[k]}
            print(json.dumps({
                "run": label, "variant": variant, "steps": steps,
                "llc_requests": int(st["stats"]["n_llc_req"]),
                "cycles_a_step": round(prof[30] / steps),
                "ns_a_step": round(prof[31] / steps, 1),
                "phase_cycles_a_step": phases}), flush=True)
    for fn, h in sass_histograms(b.build()).items():
        print(json.dumps({"function": fn, "instructions": sum(h.values()),
                          "opcodes": dict(h.most_common(24))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
