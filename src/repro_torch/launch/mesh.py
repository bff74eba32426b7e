"""Meshes over the ``torch.distributed`` default group.

The counterpart of ``repro.launch.mesh``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions over the
ranks of the default process group, in mesh-major rank order (rank =
``pod · data_size + data`` for a ``("pod", "data")`` mesh), and
``mesh.get_group(name)`` is the process group of one dimension. Functions,
not module constants: importing this module touches no process group.

Collectives move the tensors of the group's backend only: a mesh over CUDA
tensors needs ``nccl``, one over CPU tensors ``gloo`` (:func:`backend_for`).
Every rank calls these functions with the same arguments.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """The process-group backend that moves tensors of ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def available_ranks() -> int:
    """The world size of the default group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh_shape(shape, axes, *, device_type: str = "cuda"):
    """A mesh of ``shape`` with dimension names ``axes`` over every rank."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and names {axes} differ in length")
    n, have = math.prod(shape), available_ranks()
    if n > have:
        raise ValueError(
            f"make_mesh_shape: requested {'×'.join(map(str, shape))} = {n} "
            f"ranks but only {have} rank(s) are available; lower the shape or "
            f"start more ranks (init_process_group's world_size)")
    if not dist.is_initialized():
        raise ValueError("make_mesh_shape: no default process group; call "
                         "torch.distributed.init_process_group first")
    if n < have:
        raise ValueError(f"make_mesh_shape: a mesh spans the whole default group "
                         f"({have} ranks), got {n}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_host_mesh(n_data: int = 1, *, device_type: str = "cuda"):
    """A ("data",) mesh of ``n_data`` ranks over the default group.

    Requesting more ranks than exist raises a ValueError naming both counts.
    """
    have = available_ranks()
    if n_data > have:
        raise ValueError(
            f"make_host_mesh: requested {n_data} ranks but only {have} rank(s) "
            f"are available; lower n_data or start more ranks "
            f"(init_process_group's world_size)")
    return make_mesh_shape((n_data,), ("data",), device_type=device_type)
