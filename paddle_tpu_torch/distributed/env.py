"""Process-per-rank bring-up: the process group, each rank's device and
the mesh of named axes.

Counterpart of ``paddle_tpu/distributed/env.py`` (``init_parallel_env``
:29, ``get_rank``, ``get_world_size``, ``axis_size``).  JAX runs one
process a host over a device mesh; here every rank is a process of its
own.  The placement decides the backend:

* ``device="cpu"`` — every rank on the CPU, gloo;
* one card a rank (at least as many cards as ranks) — rank r on
  ``cuda:<r % cards>``, NCCL;
* fewer cards than ranks — every rank on ``cuda:0``, gloo, its
  collectives staged through pinned host memory (gloo moves host
  tensors).

The rank, world size and rendezvous come from the arguments or, as
``spawn`` and ``launch`` set them, from ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM`` / ``PADDLE_TPU_INIT_METHOD`` (and the device from
``PADDLE_TPU_DEVICE``, which ``launch --device cpu`` sets).  Nothing of a
cluster is discovered.
"""
from __future__ import annotations

import datetime
import os

import torch

from .topology import Mesh

_MESH: Mesh | None = None
_DEVICE = None
TIMEOUT_S = 600


def placement(world_size: int, device=None, local_rank: int = 0):
    """(device, backend, transport) of rank ``local_rank`` of
    ``world_size`` — see the module docstring."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu"), "gloo", "host"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "ranks on the CPU")
    cards = torch.cuda.device_count()
    if device is not None and torch.device(device).index is not None:
        return torch.device(device), "gloo", "staged"
    if cards >= world_size:
        return torch.device("cuda", local_rank % cards), "nccl", "nccl"
    return torch.device("cuda", 0), "gloo", "staged"


def init_process(rank=None, world_size=None, init_method=None,
                 device=None, timeout_s: float = TIMEOUT_S):
    """Join the default process group once per process and return this
    rank's device.  Arguments left None come from the environment."""
    global _DEVICE
    import torch.distributed as dist

    rank = int(os.environ["PADDLE_TRAINER_ID"] if rank is None else rank)
    world_size = int(os.environ["PADDLE_TRAINERS_NUM"]
                     if world_size is None else world_size)
    if init_method is None:
        init_method = os.environ["PADDLE_TPU_INIT_METHOD"]
    if device is None:
        device = os.environ.get("PADDLE_TPU_DEVICE")
    dev, backend, transport = placement(world_size, device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = (dev, backend, transport)
    return dev


def init_parallel_env(mesh_shape=None, device=None, **process) -> Mesh:
    """The mesh over this process group (joined first when needed, with
    ``process`` passed to :func:`init_process`), installed as the global
    one.  ``mesh_shape`` is an ordered {axis: size}: its order is the
    layout (rank-major first); None puts every rank on ``dp``.  The
    sizes must multiply to the world size.  Every group is created here,
    on every rank (:meth:`Mesh.build_groups`), and each is used once so
    that no later point-to-point call is a group's first."""
    global _MESH
    import torch.distributed as dist

    if not dist.is_initialized() or process:
        init_process(device=device, **process)
    world = dist.get_world_size()
    rank = dist.get_rank()
    if mesh_shape is None:
        mesh_shape = {"dp": world}
    shape = dict(mesh_shape)
    total = 1
    for v in shape.values():
        total *= int(v)
    if total != world:
        raise ValueError(f"mesh {shape} needs {total} ranks; the process "
                         f"group has {world}")
    dev, backend, transport = (_DEVICE if _DEVICE is not None
                               else placement(world, device, rank))
    mesh = Mesh(shape, rank, dev, backend, transport).build_groups()
    from . import collective

    for axes in list(mesh._groups):
        collective.all_reduce_(torch.zeros(1, device=dev), mesh, axes)
    _MESH = mesh
    return mesh


def get_mesh() -> Mesh:
    if _MESH is None:
        raise RuntimeError("no mesh: call init_parallel_env first")
    return _MESH


def get_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def axis_size(axis: str) -> int:
    return get_mesh().size(axis)
