"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` under ``repro_torch/kernels`` has a plain C interface
(pointers as ``void*``, the stream last, ``cudaGetLastError()`` returned),
so no PyTorch header is compiled; device helpers shared by several
kernels live in ``include/*.cuh``.  At first use the sources are compiled
for ``sm_90a`` -- one ``nvcc -c`` per source, all started together -- and
linked into ONE shared library under ``build/kernels/<hash>/`` at the repo
root (listed in ``.gitignore``); the hash covers the sources, the shared
headers and the flags, so an edited source or header rebuilds and an
unchanged tree loads at once.  Nothing is built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List

_PKG = Path(__file__).resolve().parent
BUILD_ROOT = _PKG.parents[2] / "build" / "kernels"
INCLUDE = _PKG / "include"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"] + ARCH_FLAGS
LIB_NAME = "libtardis_kernels.so"


def sources() -> List[Path]:
    """Every kernel source of the port, in a stable order."""
    return sorted(_PKG.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def headers() -> List[Path]:
    """The device headers the sources include, in a stable order."""
    return sorted(INCLUDE.glob("*.cuh"))


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + headers():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile (if needed) and return the shared library's path."""
    srcs = sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    procs = []
    for s in srcs:           # one nvcc per source, all in flight together
        obj = tmp / (s.stem + ".o")
        procs.append((s, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, f"-I{INCLUDE}", *extra, "-c", str(s), "-o",
             str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for s, _obj, p in procs:
        out, _ = p.communicate()
        if verbose and out:
            print(f"[nvcc {s.name}]\n{out}", flush=True)
        if p.returncode:
            errors.append(f"{s}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    part = tmp / LIB_NAME
    subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(part),
                    *[str(obj) for _s, obj, _p in procs]], check=True)
    os.replace(part, lib)    # atomic: a concurrent build sees all or none
    shutil.rmtree(tmp, ignore_errors=True)
    if verbose:
        print(f"[nvcc] built {lib} from {len(srcs)} sources in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return lib


_VP, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)

# C signatures of every entry point (all return cudaError_t as int)
SIGNATURES = {
    "tardis_lease_pass": [_VP] * 6 + [_I32, _I32, _I32] + [_VP] * 5,
    "tardis_write_advance": [_VP] * 3 + [_I32] * 3 + [_VP] * 4,
    "tardis_gather_rows": [_VP, _VP, _I32, _I64, _I64, _I64, _VP, _VP],
    "tardis_scatter_rows": [_VP, _VP, _I32, _I64, _I64, _I64, _VP, _VP],
    "tardis_empty": [_VP],
    "tardis_paged_decode": ([_VP] * 6 + [_I32] * 6 + [_I64, _I32, _I32, _F32]
                            + [_I32] * 4 + [_VP, _VP]),
    "tardis_dense_decode": ([_VP] * 4 + [_I32] * 6 + [_I64] * 3
                            + [_F32, _I32, _I32, _I32, _VP]),
    "tardis_flash_prefill": ([_VP] * 5 + [_I32] * 5 + [_I64] * 6
                             + [_I32] * 3 + [_F32, _I32, _I32, _I32, _VP]),
    "tardis_ssd_chunk": ([_VP] + [_I64] * 3 + [_VP] + [_I64] * 2
                         + [_VP] * 3 + [_I64] * 3 + [_I32] * 9
                         + [_VP] * 3),
    "tardis_ssd_chunk_backward": ([_VP] + [_I64] * 3 + [_VP] + [_I64] * 2
                                  + [_VP] * 3 + [_I64] * 3 + [_VP] * 2
                                  + [_I32] * 10 + [_VP] * 10),
    "tardis_ssd_chunk_backward_tf32": ([_VP] + [_I64] * 3 + [_VP]
                                       + [_I64] * 2 + [_VP] * 3
                                       + [_I64] * 3 + [_VP] * 2 + [_I32] * 11
                                       + [_VP] * 10),
    "tardis_rmsnorm": ([_I32, _VP, _I64, _VP, _I64, _VP, _VP, _I64, _VP,
                        _I64, _I32, _I32, _F32, _I32, _I32, _I32, _VP]),
    "tardis_flash_backward": ([_VP] * 11 + [_I32] * 6 + [_I64] * 6
                              + [_I32] * 3 + [_F32, _I32, _I32]),
    "tardis_rmsnorm_backward": ([_VP, _I64, _VP, _I64, _VP, _I64, _VP, _VP,
                                 _I64, _VP, _VP, _I32, _I32, _I32, _F32,
                                 _I32, _I32, _I32]),
    "tardis_rmsnorm_backward_gate": ([_VP, _I64] * 3 + [_VP, _VP, _I64, _VP,
                                      _I64, _VP, _VP, _I32, _I32, _I32,
                                      _F32, _I32, _I32, _I32]),
    "tardis_sim_run": [_VP, _I32, _VP, _I32, _I32, _I32, _I32, _VP],
    "tardis_l2_chase": [_VP, _I32, _VP, _VP],
    "tardis_smem_chase": [_VP, _I32, _I32, _VP, _VP],
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call a C entry point on PyTorch's current stream; raise when the
    launch was refused (the C side returns ``cudaGetLastError()``)."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({torch.cuda.get_device_name()})")


@functools.lru_cache(maxsize=None)
def sm_count(dev) -> int:
    """The card's streaming multiprocessors (the wrappers size their grids
    by it)."""
    import torch
    return torch.cuda.get_device_properties(dev).multi_processor_count


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer as a ctypes argument (None -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
