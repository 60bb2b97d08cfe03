"""Production mesh construction (the port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.DeviceMesh`` over the ranks of the
default process group, which the caller starts first: on a cluster,
``torch.distributed.init_process_group`` with the NCCL backend and one
rank a card; in the dry run, a fake process group of 256 / 512 ranks
(``launch.dryrun``); in tests, gloo ranks on the CPU.  Defined as
functions (never module-level constants) so importing this module
touches no distributed state.
"""
from __future__ import annotations


def _device_type() -> str:
    import torch
    import torch.distributed as dist
    if dist.get_backend() == "nccl" and torch.cuda.is_available():
        return "cuda"
    return "cpu"


def _make_mesh(shape, axes):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError("start a process group first "
                           "(torch.distributed.init_process_group)")
    if dist.get_world_size() != n:
        raise RuntimeError(f"need {n} ranks for mesh {tuple(shape)}, the "
                           f"process group has {dist.get_world_size()}")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (16, 16) = (data, model) = 256 ranks.
    Multi-pod: (2, 16, 16) = (pod, data, model) = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes)


def make_host_mesh(*, data: int = 1, model: int = 1):
    """Small (data, model) mesh for tests and examples over the process
    group's ranks (data * model of them)."""
    return _make_mesh((data, model), ("data", "model"))
