#!/usr/bin/env python3
"""Time the port's K4 (paged decode) and K7 (SSD intra-chunk scan) at
``chip_smoke.py``'s shapes, and K7's tensor-core variant against edited
copies of its source, on one NVIDIA card.

    python3 scripts/k4_k7_variants.py                 # K4, K7 as built
    python3 scripts/k4_k7_variants.py --ablations     # + ablation builds
    python3 scripts/k4_k7_variants.py --schedules     # + scheduling builds
    python3 scripts/k4_k7_variants.py --check         # edits only, no card

The first part checks both kernels' variants against their plain
versions (K4: B 8, P 32, 4 KV x 8 heads, Dh 64 over the 4608-block pool;
K7: b 4, 12 chunks of 256, 80 heads, N = P = 64 over the conv output's
views) and times them by CUDA-graph replay (``chip_smoke.graph_ms``),
and prints the HMMA count of each tensor-core kernel in the library's
SASS.  ``--ablations`` / ``--schedules`` compile edited copies of
``ssd_chunk.cu`` (each edit named below; ablations compute wrong values
and are timed only) into ``build/variants/``, load each with ctypes and
time it in two rounds beside the unedited source; ``--ablations`` also
sweeps the heads a CTA takes.  Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.kernels import _build  # noqa: E402

SSD_SRC = _build._PKG / "ssd_scan" / "csrc" / "ssd_chunk.cu"
_V_BLOCK = re.compile(r"            float v\[4\];\n.*?"
                      r"            unsigned lo\[3\], hi\[3\];\n", re.S)
_NO_DECAY = ("re", _V_BLOCK, "            float v[4] = {cb[nb][0], cb[nb][1], "
             "cb[nb][2], cb[nb][3]};\n            unsigned lo[3], hi[3];\n")

# ablations: one piece of the tensor-core variant's work removed each
ABLATIONS = {
    "no_decay": [_NO_DECAY],            # M' = cb: no exp, dt or mask
    "no_elementwise": [_NO_DECAY, (     # ... and no three-part split
        "s", "            split3(v[0], v[1], lo);\n"
        "            split3(v[2], v[3], hi);\n",
        "            lo[0] = lo[1] = lo[2] = pack_bf16(v[0], v[1]);\n"
        "            hi[0] = hi[1] = hi[2] = pack_bf16(v[2], v[3]);\n")],
    "one_part": [(                      # M'.x with one part, not three
        "s", "for (int part = 0; part < 3; ++part) {\n"
        "                mma_bf16_16(acc[nd], ma[part], vf[0], vf[1]);",
        "for (int part = 0; part < 1; ++part) {\n"
        "                mma_bf16_16(acc[nd], ma[part], vf[0], vf[1]);")],
    "no_stores": [                      # y_intra and S never written
        ("s", "          if (col < p) {\n"
         "            *reinterpret_cast<float2*>(y0 + col)",
         "          if (col < p && hh < 0) {\n"
         "            *reinterpret_cast<float2*>(y0 + col)"),
        ("s", "          if (col >= n) continue;",
         "          if (col >= n || hh >= 0) continue;")],
    "x_once": [(                        # x staged for the first head only
        "s", "    stage(xs, kXPitch, x + bi * xsb + hh * xsh, xst, p, pk);\n",
        "    if (hh == h0) stage(xs, kXPitch, x + bi * xsb + hh * xsh, xst, "
        "p, pk);\n")],
    "y_only": [(                        # no chunk states
        "s", "    for (int u = warp; u < n_units; u += kMmaWarps) {",
        "    for (int u = warp; u < 0 * n_units; u += kMmaWarps) {")],
    "states_only": [(                   # no y_intra
        "s", "    for (int u = warp; u < (ns + 1) / 2; u += kMmaWarps) {",
        "    for (int u = warp; u < 0 * ns; u += kMmaWarps) {")],
}
_U2 = ("s", "        for (int kj = 0; kj <= st; ++kj) {",
       "#pragma unroll 2\n        for (int kj = 0; kj <= st; ++kj) {")
_CB2 = [("s", "          float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, "
         "{0.f, 0.f, 0.f, 0.f}};\n",
         "          float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, "
         "{0.f, 0.f, 0.f, 0.f}};\n          float cc[2][4] = "
         "{{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};\n"),
        ("s", "              mma_bf16_16(cb[0], ca[kn], bf[0], bf[1]);\n"
         "              mma_bf16_16(cb[1], ca[kn], bf[2], bf[3]);\n"
         "            }\n",
         "              if (kn & 1) {\n"
         "                mma_bf16_16(cc[0], ca[kn], bf[0], bf[1]);\n"
         "                mma_bf16_16(cc[1], ca[kn], bf[2], bf[3]);\n"
         "              } else {\n"
         "                mma_bf16_16(cb[0], ca[kn], bf[0], bf[1]);\n"
         "                mma_bf16_16(cb[1], ca[kn], bf[2], bf[3]);\n"
         "              }\n            }\n#pragma unroll\n"
         "          for (int e = 0; e < 8; ++e) cb[e / 4][e % 4] += "
         "cc[e / 4][e % 4];\n")]
_SU2 = ("s", "      for (int kj = 0; kj < ns; ++kj) {\n"
        "        const int j0 = kj * 16;\n        // B_j * w_j",
        "#pragma unroll 2\n      for (int kj = 0; kj < ns; ++kj) {\n"
        "        const int j0 = kj * 16;\n        // B_j * w_j")
# scheduling variants: the same values, another instruction schedule
SCHEDULES = {
    "unroll_y": [_U2],                  # the y strip's j loop unrolled by 2
    "two_cb_chains": _CB2,              # C.B^T in two accumulator chains
    "unroll_states": [_SU2],            # the states' j loop unrolled by 2
    "all_three": [_U2, *_CB2, _SU2],
    "one_cta_per_sm": [(                # registers up to 255
        "s", "__launch_bounds__(kMmaWarps * 32, NMAX <= 64 ? 2 : 1)",
        "__launch_bounds__(kMmaWarps * 32, 1)")],
}


def apply(src: str, edits) -> str:
    """``src`` with each edit applied exactly once (else AssertionError)."""
    for kind, a, b in edits:
        if kind == "s":
            assert src.count(a) == 1, f"edit does not apply once: {a!r}"
            src = src.replace(a, b)
        else:
            src, n = a.subn(b.replace("\\", "\\\\"), src)
            assert n == 1, f"edit does not apply once: {a.pattern!r}"
    return src


def build_variants(variants, out_dir: Path):
    """Compile the unedited source and each variant, all at once; return
    {name: loaded library}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = SSD_SRC.read_text()
    procs = {}
    for name, edits in {"source": [], **variants}.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(apply(src, edits))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.INCLUDE}",
             "-shared", "-o", str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        fn = lib.tardis_ssd_chunk
        fn.argtypes = _build.SIGNATURES["tardis_ssd_chunk"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ablations = "--ablations" in sys.argv
    schedules = "--schedules" in sys.argv
    variants = {**(ABLATIONS if ablations else {}),
                **(SCHEDULES if schedules else {})}
    if "--check" in sys.argv:
        src = SSD_SRC.read_text()
        for name, edits in {**ABLATIONS, **SCHEDULES}.items():
            apply(src, edits)
        print(f"every edit applies once: {sorted({**ABLATIONS, **SCHEDULES})}")
        return 0
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_ref
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
    if not torch.cuda.is_available():
        print("k4_k7_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    F = torch.nn.functional
    dev = torch.device("cuda")
    for fn, n in cs.sass_counts(_build.build(), "HMMA").items():
        if "paged_decode_mma" in fn or "ssd_chunk_mma" in fn:
            print(f"HMMA {n:3d} {fn[:110]}")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    # K7 at zamba2's prefill shape
    b, s, h, p, n, chunk = 4, 3072, 80, 64, 64, 256
    nc = s // chunk
    conv32 = torch.randn((b, s, h * p + 2 * n), generator=g, device=dev)
    dt = F.softplus(torch.randn((b, s, h), generator=g, device=dev))
    A = -torch.exp(0.5 * torch.randn((h,), generator=g, device=dev))
    cum = torch.cumsum((dt * A).reshape(b, nc, chunk, h), dim=2)
    for dtype in (torch.bfloat16, torch.float32):
        conv = conv32.to(dtype)
        xs = conv[..., :h * p].reshape(b, s, h, p)
        bs, cs_ = conv[..., h * p:h * p + n], conv[..., h * p + n:]
        (y, st), variant = cs.variant_of(SK.ssd_chunk, lambda: SK.ssd_chunk(
            xs, dt, cum, bs, cs_, chunk=chunk))
        wy, wst = ssd_chunk_ref(xs, dt, cum, bs, cs_, chunk=chunk)
        ok = (torch.allclose(y, wy, **cs.FP32)
              and torch.allclose(st, wst, **cs.FP32))
        ms = cs.graph_ms(lambda: SK.ssd_chunk(xs, dt, cum, bs, cs_,
                                              chunk=chunk), 5)
        print(f"K7 {str(dtype)[6:]} ({variant} variant): max |err| "
              f"{cs.max_err(y, wy):.3g} / {cs.max_err(st, wst):.3g}, within "
              f"2e-4: {ok}; {ms * 1e3:.2f} us", flush=True)
        del y, st, wy, wst
    # K4 at the paged path's shape
    n_blocks, pchunk, token_row, n_layers = 4608, 16, 11264, 22
    pool = torch.randn((n_blocks * pchunk, token_row), generator=g,
                       device=dev).to(torch.bfloat16)
    hkv, grp_q, dh, p_max, bb = 4, 8, 64, 32, 8
    k_off, v_off = (n_layers - 1) * hkv * dh, (2 * n_layers - 1) * hkv * dh
    page_rows = torch.randint(0, n_blocks, (bb, p_max), generator=g,
                              device=dev, dtype=torch.int32)
    lengths = torch.randint(60, 100, (bb,), generator=g, device=dev,
                            dtype=torch.int32)
    q = torch.randn((bb, hkv, grp_q, dh), generator=g, device=dev)
    ck = torch.randn((bb, hkv, dh), generator=g, device=dev)
    cv = torch.randn((bb, hkv, dh), generator=g, device=dev)
    for dtype, tol in ((torch.bfloat16, cs.BF16_ULP), (torch.float32,
                                                       cs.FP32)):
        pv = pool if dtype == torch.bfloat16 else pool.float()
        args = (q.to(dtype), ck.to(dtype), cv.to(dtype), pv, page_rows,
                lengths)
        kw = dict(chunk=pchunk, k_off=k_off, v_off=v_off)
        got, variant = cs.variant_of(DK.paged_decode,
                                     lambda: DK.paged_decode(*args, **kw))
        want = paged_decode_attention_ref(
            args[0].reshape(bb, 1, hkv * grp_q, dh),
            args[1].reshape(bb, 1, hkv, dh), args[2].reshape(bb, 1, hkv, dh),
            pv, page_rows, lengths, hkv=hkv, **kw).reshape(got.shape)
        ok = torch.allclose(got.float(), want.float(), **tol)
        ms = cs.graph_ms(lambda: DK.paged_decode(*args, **kw))
        print(f"K4 {str(dtype)[6:]} ({variant} variant): max |err| "
              f"{cs.max_err(got.float(), want.float()):.3g}, within its "
              f"tolerance: {ok}; {ms * 1e3:.2f} us", flush=True)
    del pool

    if not variants:
        return 0
    libs = build_variants(variants, ROOT / "build" / "variants")
    conv = conv32.to(torch.bfloat16)
    xs = conv[..., :h * p].reshape(b, s, h, p)
    bs, cs_ = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    y = torch.empty((b, nc, chunk, h, p), device=dev)
    S = torch.empty((b, nc, h, p, n), device=dev)
    P = _build.ptr

    def call(lib, hpc):
        err = lib.tardis_ssd_chunk(
            P(xs), *xs.stride()[:3], P(dt), *dt.stride()[:2], P(cum), P(bs),
            P(cs_), bs.stride(0), bs.stride(1), 0, b, s, nc, chunk, h, p, n,
            1, 1, 1, hpc, P(y), P(S),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        assert err == 0, f"launch failed: {err}"

    hpc = SK.ssd_heads_per_cta(b * nc, h, SK.sm_count(dev), 2)
    for rnd in range(2):
        for name, vlib in libs.items():
            ms = cs.graph_ms(lambda: call(vlib, hpc), 5)
            print(f"round {rnd} {name:16s} ({hpc} heads a CTA): "
                  f"{ms * 1e3:8.2f} us", flush=True)
    if ablations:
        for k in range(1, SK.MMA_MAX_HEADS + 1):
            ms = cs.graph_ms(lambda: call(libs["source"], k), 5)
            print(f"source, {k} heads a CTA: {ms * 1e3:8.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
