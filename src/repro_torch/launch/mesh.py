"""Mesh construction (port of `repro.launch.mesh`): functions, not module
constants, so importing this module touches no device state and no
process group.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the current process group, one rank a device, with named dimensions
("data", "model") or ("pod", "data", "model") that the sharding rules
(`repro_torch.distributed`) read. Without a process group,
`make_host_mesh` starts a world of one over an in-process store (gloo on
the CPU, NCCL on CUDA): no address, no environment variable. A larger
world is the caller's `torch.distributed.init_process_group` (for a dry
run, PyTorch's fake backend)."""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.precision.backend import resolve_device


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _ensure_world(device_type: str) -> int:
    """The current world's size, after starting a world of one when no
    process group exists."""
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with `multi_pod`, over the current world; raises
    RuntimeError when the world is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world_size()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {have} — run in a "
            f"world of {n} ranks (a dry run: PyTorch's fake process "
            "group)")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1, device=None):
    """("data", "model") mesh over every rank of the current world (a
    world of one when there is no process group), `model_parallel` of
    them along "model"."""
    dev = resolve_device(device)
    n = _ensure_world(dev.type)
    mp = max(1, min(model_parallel, n))
    return init_device_mesh(dev.type, (n // mp, mp),
                            mesh_dim_names=("data", "model"))
