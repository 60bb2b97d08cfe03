#!/usr/bin/env python3
"""K2 (the writer jump-ahead) in its launch forms, timed in turns on one
NVIDIA card.

    python3 scripts/k2_variants.py [--parent DIR] [--check]

Each variant is a copy of ``write_advance.cu`` with one design choice
edited (text replacements, checked to apply once), built with the port's
nvcc flags into ``build/variants/`` and loaded with ctypes:
  * ``design``: the committed kernel -- one CTA of 1024 threads holding up
    to 8 entries each in registers, or a thread-block cluster of up to 8
    CTAs -- timed on one CTA and on clusters of 5 (one entry a thread at
    the serving table, as K1 spreads it) and 8 CTAs;
  * ``plain_launch``: one CTA launched with ``<<<>>>``, no cluster
    attribute;
  * ``threads_512`` / ``threads_256``: one CTA of fewer threads holding 16
    / 32 entries each.
``--parent DIR`` adds the two-launch kernel of another checkout (its
``write_advance.cu``, the plain C interface it had).  Every form is first
held against the plain version bit for bit and its device kernels a call
counted (``torch.profiler``, before any CUDA graph is captured: the
profiler can miss kernels after one), then timed (CUDA-graph replay, median
of 7 x 20 calls) in two rounds, the second in the reverse order, at the
serving table (4608 blocks, a mask of one block in 8) and at 70000 blocks
(past the cluster's registers).  ``--check`` only checks that the edits
apply.  Prints one JSON line per table size.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

K2_SRC = "src/repro_torch/kernels/tardis_lease/csrc/write_advance.cu"
LAUNCH = ("  return launch_cluster(write_advance_kernel, 1, n_ctas, kWarps, "
          "0,")
PLAIN = """  if (n_ctas == 1) {
    write_advance_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)wts, (const int*)rts, (const int*)mask, n, pts,
        (int*)new_wts, (int*)new_rts, (int*)ts);
    return (int)cudaGetLastError();
  }
""" + LAUNCH


def edit(src, *pairs):
    for old, new in pairs:
        if src.count(old) != 1:
            raise ValueError(f"edit does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def variants(parent):
    """{name: (source, the CTA counts it is timed on; 0: the parent's
    entry point, which took none)}."""
    k2 = (ROOT / K2_SRC).read_text()

    def threads(t, per):
        return edit(k2, ("constexpr int kThreads = 1024;",
                         f"constexpr int kThreads = {t};"),
                    ("constexpr int kPer = 8;",
                     f"constexpr int kPer = {per};"))

    out = {"design": (k2, (1, 5, 8)),
           "plain_launch": (edit(k2, (LAUNCH, PLAIN)), (1,)),
           "threads_512": (threads(512, 16), (1,)),
           "threads_256": (threads(256, 32), (1,))}
    if parent:
        out["parent"] = ((Path(parent) / K2_SRC).read_text(), (0,))
    return out


def build(srcs):
    """Compile every variant (one nvcc each, all in flight) -> {name: fn}."""
    bdir = ROOT / "build" / "variants"
    bdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, _ctas) in srcs.items():
        cu = bdir / f"K2_{name}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        procs[name] = so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.INCLUDE}",
             "-shared", str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).tardis_write_advance
        fn.argtypes = ([vp] * 3 + [i32] * (2 if name == "parent" else 3)
                       + [vp] * 4)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    srcs = variants(args.parent)
    if args.check:
        print(json.dumps({k: list(c) for k, (_s, c) in srcs.items()}))
        return 0
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.tardis_lease import ref as R
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device available", file=sys.stderr)
        return 2
    fns = build(srcs)
    dev = "cuda"

    def p(t):
        return ctypes.c_void_p(t.data_ptr())

    def form(fn, ctas, wts, rts, mask, n):
        def call():
            out = (torch.empty_like(wts), torch.empty_like(rts),
                   torch.empty((), dtype=torch.int32, device=dev))
            head = (p(wts), p(rts), p(mask), 500, n) + (
                (ctas,) if ctas else ())
            err = fn(*head, *(p(t) for t in out),
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"K2 launch failed ({err})")
            return out
        return call

    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    cases = {}
    for n in (4608, 70000):
        g = torch.Generator(device=dev).manual_seed(cs.SEED)
        wts = torch.randint(0, 1000, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        rts = wts + torch.randint(0, 200, (n,), generator=g, device=dev,
                                  dtype=torch.int32)
        mask = (torch.randint(0, 8, (n,), generator=g, device=dev) == 0).to(
            torch.int32)
        want = R.write_advance_ref(wts, rts, mask, 500)
        calls = {}
        for name, (_src, ctas_list) in srcs.items():
            for ctas in ctas_list:
                key = f"{name}_ctas_{ctas}" if name == "design" else name
                calls[key] = form(fns[name], ctas, wts, rts, mask, n)
        for name, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"K2 {name} differs from plain at {n}")
        cases[n] = calls
    kernels = {n: {name: sum(cs.device_kernels(call).values())
                   for name, call in calls.items()}
               for n, calls in cases.items()}
    for n, calls in cases.items():
        times = {}
        names = list(calls)
        for order in (names, names[::-1]):
            for name in order:
                times.setdefault(name, []).append(
                    round(cs.graph_ms(calls[name]) * 1e3, 3))
        print(json.dumps({"kernel": "K2", "N": n, "us": times,
                          "device_kernels": kernels[n]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
