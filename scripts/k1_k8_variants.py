#!/usr/bin/env python3
"""Design variants of K1 (lease pass) and K8 (RMSNorm), timed in turns on
one NVIDIA card.

    python3 scripts/k1_k8_variants.py [--parent DIR] [--check]

Each variant is a copy of the kernel source with one design choice
edited (text replacements, checked to apply once), built with the port's
nvcc flags into ``build/variants/`` and loaded with ctypes.  Every
variant is first held against the plain version (K8 within one bf16
rounding step, K1 bit for bit), then timed (CUDA-graph replay, median of
7 x 20 calls) in two rounds, the second in the reverse order.  K8 at the
phase-2 shapes of ``chip_smoke.py`` (bf16 rows and weights), K1 at the
serving table (4608 blocks, 4 groups, static lease).  ``--parent DIR``
adds the kernels of another checkout (its ``rmsnorm.cu`` plain variant;
its ``lease_pass.cu`` with the two fills its wrapper ran before it).
``--check`` only checks that the edits apply (no card needed).  Prints one
JSON line per kernel and shape.
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

KDIR = ROOT / "src/repro_torch/kernels"
K8_SRC = "rmsnorm/csrc/rmsnorm.cu"
K1_SRC = "tardis_lease/csrc/lease_pass.cu"


def edit(src, *pairs):
    for old, new in pairs:
        if src.count(old) != 1:
            raise ValueError(f"edit does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def variants(parent):
    """{kernel: {variant: source}}."""
    k8 = (KDIR / K8_SRC).read_text()
    k1 = (KDIR / K1_SRC).read_text()
    few = ("if (rows <= kFewRows && chunks <= kMaxThreads)",
           "if (rows <= kFewRows && chunks <= 2 * kMaxThreads)")
    out = {
        "K8": {
            "design": k8,
            # the prefill rows with w requested before the reduction too
            "early_w_everywhere": edit(k8, (
                "return launch_rows<TX, TW, MODE, 4, false>(",
                "return launch_rows<TX, TW, MODE, 4, true>(")),
            # the decode rows with w loaded after the reduction
            "late_w_few_rows": edit(k8, *[
                (f"return launch_rows<TX, TW, MODE, {c}, true>(",
                 f"return launch_rows<TX, TW, MODE, {c}, false>(")
                for c in (1, 2, 4)]),
            # the decode rows at 4 chunks a thread (as the prefill rows)
            "four_chunks_few_rows": edit(k8, *[
                (f, f.replace("rows <= kFewRows", "false")) for f in few]),
        },
        "K1": {
            "design": k1,
            # each group's mask word requested in the group loop
            "group_batch_1": edit(k1, ("constexpr int kGroupBatch = 4;",
                                       "constexpr int kGroupBatch = 1;")),
            "threads_512": edit(k1, ("constexpr int kThreads = 1024;",
                                     "constexpr int kThreads = 512;")),
            "threads_256": edit(k1, ("constexpr int kThreads = 1024;",
                                     "constexpr int kThreads = 256;")),
            # one CTA that loops over the table (a cluster of one)
            "one_cta": edit(k1, (
                "  const int ctas = rounds < 1 ? 1 : rounds > kTardisMaxSplit"
                " ? kTardisMaxSplit\n"
                "                                                           "
                "   : rounds;",
                "  const int ctas = rounds < 0 ? rounds : 1;")),
        },
    }
    if parent:
        pk = Path(parent) / "src/repro_torch/kernels"
        out["K8"]["parent"] = (pk / K8_SRC).read_text()
        out["K1"]["parent"] = (pk / K1_SRC).read_text()
    return out


def build(srcs):
    """Compile every variant (one nvcc each, all in flight) -> {key: lib}."""
    bdir = ROOT / "build" / "variants"
    bdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel, vs in srcs.items():
        for name, src in vs.items():
            cu = bdir / f"{kernel}_{name}.cu"
            cu.write_text(src)
            so = cu.with_suffix(".so")
            procs[kernel, name] = so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.INCLUDE}",
                 "-shared", str(cu), "-o", str(so)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    srcs = variants(args.parent)
    if args.check:
        print(json.dumps({k: list(v) for k, v in srcs.items()}))
        return 0
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.rmsnorm import ref as RR
    from repro_torch.kernels.tardis_lease import ref as R
    if not torch.cuda.is_available():
        print("k1_k8_variants: no CUDA device available", file=sys.stderr)
        return 2
    libs = build(srcs)
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    parent_k8 = [vp] * 3 + [i32] * 2 + [i64] * 2 + [f32, i32, i32, i32, vp]
    for (kernel, name), lib in libs.items():
        if kernel == "K8":
            lib.tardis_rmsnorm.argtypes = (
                parent_k8 if name == "parent"
                else _build.SIGNATURES["tardis_rmsnorm"])
        else:
            lib.tardis_lease_pass.argtypes = _build.SIGNATURES[
                "tardis_lease_pass"]
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    b16 = torch.bfloat16

    def p(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def time_in_turns(calls):
        times = {}
        names = list(calls)
        for order in (names, names[::-1]):
            for name in order:
                times.setdefault(name, []).append(
                    round(cs.graph_ms(calls[name]) * 1e3, 2))
        return times

    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    # --- K8 at the phase-2 shapes ------------------------------------------
    modes = {"plain": 0, "add": 1, "gate": 2}
    for _name, _path, mode, r, d in cs.K8_ROWS:
        x = torch.randn((r, d), generator=g, device=dev)
        other = None
        if mode != "gate":
            x = x.to(b16)
        if mode == "add":
            other = torch.randn((r, d), generator=g, device=dev).to(b16)
        if mode == "gate":
            other = torch.randn((r, 2 * d + 208), generator=g,
                                device=dev).to(b16)[:, d:2 * d]
        w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(b16)
        out = torch.empty((r, d), dtype=b16, device=dev)
        h = torch.empty_like(out)
        want = (RR.rmsnorm_ref(x, w) if mode == "plain" else
                RR.add_rmsnorm_ref(x, other, w)[1] if mode == "add" else
                RR.gated_rmsnorm_ref(x, other, w))
        calls = {}
        for name in srcs["K8"]:
            lib = libs["K8", name].tardis_rmsnorm
            if name == "parent":
                if mode != "plain":
                    continue
                calls[name] = (lambda lib=lib, x=x, w=w, out=out, r=r, d=d:
                               lib(p(x), p(w), p(out), r, d, x.stride(0), d,
                                   1e-5, 1, 1, 1, stream()))
            else:
                calls[name] = (
                    lambda lib=lib, x=x, o=other, w=w, out=out, h=h, r=r,
                    d=d, m=modes[mode]: lib(
                        m, p(x), x.stride(0), p(o),
                        0 if o is None else o.stride(0), p(w), p(out), d,
                        p(h), d, r, d, 1e-5, 1, 1, 1, stream()))
        for name, call in calls.items():
            out.zero_()
            if call() != 0:
                raise RuntimeError(f"K8 {name}: launch failed")
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), want.float(),
                                       rtol=2 ** -7, atol=1e-5)
        print(json.dumps({"kernel": "K8", "mode": mode, "rows": r, "D": d,
                          "us": time_in_turns(calls)}), flush=True)
    # --- K1 at the serving table ---------------------------------------------
    n, grp = 4608, 4

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    wts = randint(0, 1000, (n,))
    rts = wts + randint(0, 200, (n,))
    req = torch.where(randint(0, 2, (n,)) == 1, wts, wts - 1)
    masks = (randint(0, 8, (grp, n)) == 0).to(torch.int32)
    pts = randint(0, 1200, (grp,))
    want = R.lease_pass_ref(wts, rts, req, masks, pts, 64)

    def k1(name):
        lib = libs["K1", name].tardis_lease_pass

        def call():
            new_rts, flags = torch.empty_like(wts), torch.empty_like(masks)
            if name == "parent":    # the fills its wrapper ran first
                write_ts = torch.zeros((), dtype=torch.int32, device=dev)
                new_pts = torch.clamp_min(pts, 0)
            else:
                write_ts = torch.empty((), dtype=torch.int32, device=dev)
                new_pts = torch.empty_like(pts)
            if lib(p(wts), p(rts), p(req), p(masks), p(pts), p(None), 64, n,
                   grp, p(new_rts), p(flags), p(write_ts), p(new_pts),
                   stream()) != 0:
                raise RuntimeError(f"K1 {name}: launch failed")
            return new_rts, flags, write_ts, new_pts
        return call

    calls = {name: k1(name) for name in srcs["K1"]}
    for name, call in calls.items():
        got = call()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K1 {name} differs from the plain version")
    print(json.dumps({"kernel": "K1", "N": n, "G": grp,
                      "us": time_in_turns(calls)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
