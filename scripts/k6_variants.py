#!/usr/bin/env python3
"""K6's tf32x3 design choices, timed against each other on one NVIDIA card.

    python3 scripts/k6_variants.py [VARIANT ...]

Each variant is ``src/repro_torch/kernels/flash_attention/csrc/
flash_prefill_tf32.cu`` with one edit (below), compiled for Dh 64 only
with the build's flags into its own library under ``build/k6_variants/``
and called through its ``tardis_flash_prefill_tf32`` entry.  At the
training shape (B 4, S 1024, 32 / 4 heads, Dh 64, fp32, causal, the LSE
written) every variant's output and LSE must be within fp32's 2e-4 of
the plain version; then each is timed (a CUDA graph of 5 calls replayed,
CUDA events, median of 7: ``chip_smoke.graph_ms``) in turns, the order
reversed the second time.  Prints one JSON line per variant: its µs a
call (both turns) and its max |err|.

  base      the source as it is (64 rows a CTA: 4 warps of 16; the
            products of 4 accumulators issued in turns; registers capped
            for 3 CTAs an SM)
  g2        the products of 2 accumulators in turns (kGroup = 2)
  g8        ... of 8 (kGroup = 8)
  rows128   8 warps, 128 rows a CTA (each K/V tile serves twice the rows),
            registers not capped (one such CTA an SM)
  bn32      K/V tiles of 32 positions (fewer registers for S)
  occ1      no register cap (the first grouped form: 249 registers,
            2 CTAs an SM)
  occ4      registers capped for 4 CTAs an SM (128)
  bn32_occ4 both

Each line also gives ptxas's registers and spill bytes of the variant's
fp32 kernel.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)

SRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_prefill_tf32.cu"


def _swap(s, old, new):
    if s.count(old) != 1:
        raise SystemExit(f"k6_variants: anchor not found once: {old[:60]!r}")
    return s.replace(old, new)


def dh64_only(s):
    """Only the Dh-64 instances (a quicker build), the entry point C."""
    for d in (32, 80, 96, 112):
        s = _swap(s, f"  if (a.dh <= {d}) return launch<TKV, {d}>(a, s);\n",
                  "")
    s = _swap(s, "  return launch<TKV, 128>(a, s);",
              "  return launch<TKV, 64>(a, s);")
    return _swap(s, "int tardis_flash_prefill_tf32(",
                 'extern "C" int tardis_flash_prefill_tf32(')


def _occ(n):
    return lambda s: _swap(s, "  return DH <= 64 ? 3 : 1;",
                           f"  return DH <= 64 ? {n} : 1;")


def _bn32(s):
    return _swap(s, "  return DH <= 80 ? 64 : 32;", "  return 32;")


VARIANTS = {
    "base": lambda s: s,
    "g2": lambda s: _swap(s, "constexpr int kGroup = 4;",
                          "constexpr int kGroup = 2;"),
    "g8": lambda s: _swap(s, "constexpr int kGroup = 4;",
                          "constexpr int kGroup = 8;"),
    "rows128": lambda s: _occ(1)(_swap(s, "constexpr int kWarps = 4;",
                                       "constexpr int kWarps = 8;")),
    "bn32": _bn32,
    "occ1": _occ(1),
    "occ4": _occ(4),
    "bn32_occ4": lambda s: _occ(4)(_bn32(s)),
}


def _ptxas(text):
    """(registers, spill store + load bytes) of the fp32 kernel."""
    import re
    fn, out = None, (None, None)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn and "IfLi64" in fn:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and "IfLi64" in fn:
            out = (int(m.group(1)), spill)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build as b
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_lse_ref, flash_attention_ref)
    names = sys.argv[1:] or list(VARIANTS)
    out_dir = ROOT / "build" / "k6_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    procs = []
    for name in names:
        cu = out_dir / f"flash_prefill_tf32_{name}.cu"
        cu.write_text(dh64_only(VARIANTS[name](src)))
        so = cu.with_suffix(".so")
        procs.append((name, so, subprocess.Popen(
            [b._nvcc(), *b.NVCC_FLAGS, f"-I{b.INCLUDE}", "-Xptxas", "-v",
             "-shared", "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    libs, regs = {}, {}
    for name, so, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"k6_variants: {name} did not build:\n{log}")
        regs[name] = _ptxas(log)
        fn = ctypes.CDLL(str(so)).tardis_flash_prefill_tf32
        fn.argtypes = [vp] * 5 + [i32] * 5 + [i64] * 6 + [i32] * 3 + [
            f32, i32, vp]
        fn.restype = i32
        libs[name] = fn
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    bsz, s, h, hkv, dh = 4, 1024, 32, 4, 64
    q, k, v = (torch.randn(sh, generator=g, device="cuda") for sh in
               ((bsz, s, h, dh), (bsz, s, hkv, dh), (bsz, s, hkv, dh)))
    out = torch.empty_like(q)
    lse = torch.empty((bsz, h, s), device="cuda")
    want = flash_attention_ref(q, k, v)
    lse_want = flash_attention_lse_ref(q, k)

    def call(fn):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), bsz, s, hkv, h // hkv, dh, *q.stride()[:3],
                 *k.stride()[:3], 0, s, 1, dh ** -0.5, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"k6_variants: launch error {err}")

    errs, us = {}, {n: [] for n in libs}
    for name, fn in libs.items():
        call(fn)
        torch.testing.assert_close(out, want, **chip_smoke.FP32)
        torch.testing.assert_close(lse, lse_want, **chip_smoke.FP32)
        errs[name] = chip_smoke.max_err(out, want)
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            us[name].append(chip_smoke.graph_ms(
                lambda fn=libs[name]: call(fn), 5) * 1e3)
    for name in libs:
        print(json.dumps({"variant": name,
                          "card": torch.cuda.get_device_name(0),
                          "us": us[name], "max_abs_err": errs[name],
                          "registers": regs[name][0],
                          "spill_bytes": regs[name][1]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
