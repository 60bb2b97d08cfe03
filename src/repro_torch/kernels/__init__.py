"""Hand-written Hopper kernels for the port, each beside its plain version.

Each subpackage is ``kernel.py`` (the ctypes wrapper with its launch count),
``ops.py`` (the public contracts of the JAX package's ``ops.py``) and
``ref.py`` (the plain PyTorch version); CUDA sources live in ``csrc/`` and
build at first use (:mod:`._build`).  A wrapper given a CPU tensor runs
the plain version; given a CUDA tensor it launches its kernel or raises.
K6, K7 and K8 (plain, add, gate) are differentiable through their
``ops`` (``torch.autograd.Function``s whose backward launches K10, K12 and
K11); every other wrapper is forward-only and raises under autograd
(:mod:`._guard`).
"""
from __future__ import annotations

from typing import Callable, Dict


def wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper of the port by name; each carries an integer
    ``launches`` that counts the launches of its kernel (and nothing
    else); a wrapper with several kernels or variants (K4, K6, K7, K8,
    K9, K10, K11) also counts them by variant in ``variants``."""
    from .coherence_sim import kernel as cs
    from .decode_attention import kernel as da
    from .flash_attention import kernel as fa
    from .rmsnorm import kernel as rn
    from .ssd_scan import kernel as ss
    from .tardis_lease import kernel as tl
    return {"lease_pass": tl.lease_pass,
            "write_advance": tl.write_advance,
            "row_copy.gather": tl.gather_rows,
            "row_copy.scatter": tl.scatter_rows,
            "paged_decode": da.paged_decode,
            "dense_decode": da.dense_decode,
            "flash_prefill": fa.flash_prefill,
            "flash_backward": fa.flash_backward,
            "ssd_chunk": ss.ssd_chunk,
            "ssd_chunk_backward": ss.ssd_chunk_backward,
            "rmsnorm": rn.rmsnorm_2d,
            "rmsnorm_backward": rn.rmsnorm_backward,
            "sim_run": cs.sim_run}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def variant_counts() -> Dict[str, Dict[str, int]]:
    return {name: dict(fn.variants) for name, fn in wrappers().items()
            if hasattr(fn, "variants")}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "variants"):
            fn.variants.clear()
