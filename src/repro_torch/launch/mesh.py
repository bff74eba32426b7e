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
:func:`spawn_ranks` starts such a group: one process a rank.
"""
from __future__ import annotations

import json
import math
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


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


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16×16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_shape(shape, axes, device_type=device_type)


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


def _rank_main(rank, world, fn, args, device, root, threads):
    """One rank of :func:`spawn_ranks`: join the group, run ``fn``, leave."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(backend_for(device), init_method=f"file://{root}/rendezvous",
                            rank=rank, world_size=world)
    try:
        out = fn(*args)
        if rank == 0:
            (Path(root) / "result.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, fn, *args, device="cpu"):
    """``fn(*args)`` on every rank of a new default group of ``world`` processes.

    Returns rank 0's result. One process a rank (the ``spawn`` start
    method), a rendezvous file in a temporary directory, the backend of
    ``device`` (gloo for the CPU, where the parent's threads are shared
    out between the ranks; nccl for CUDA, rank r on card r). ``fn`` must
    be importable by name and return JSON-ready data. A failed rank raises
    here (``torch.multiprocessing.ProcessRaisedException``).
    """
    if torch.device(device).type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"spawn_ranks: {world} ranks need {world} cards, have "
                         f"{torch.cuda.device_count()}")
    threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory(prefix="repro-torch-ranks-") as root:
        mp.start_processes(_rank_main, args=(world, fn, args, str(device), root, threads),
                           nprocs=world, join=True, start_method="spawn")
        return json.loads((Path(root) / "result.json").read_text())
