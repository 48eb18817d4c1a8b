"""Meshes of ranks for the solver backend (counterpart of
``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
default process group, with named dims: ``("data", "model")`` for the
solver (the m row blocks shard over ``data``, n over ``model``), and a
leading ``"pod"`` as a second worker axis where one is wanted.  Every rank
runs the same program; a rank's coordinates in the mesh say which shard
it holds.  The mesh covers every rank of the group.

Every function resolves its device through ``repro_torch.device.resolve``
(``cuda`` unless the caller asks for the CPU) and starts the default group
where none is up (:func:`init_group`): NCCL for the card, gloo for the
CPU.  Nothing swaps one for the other.  Under ``torchrun`` the group comes
from its environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``); without it, a one-rank group, the twin
of the reference degrading to a (1, 1) mesh on a one-device host.  A
caller that wants another group (say two ranks on one card over gloo)
starts it itself before the first mesh.
"""
from __future__ import annotations

import math
import os
import tempfile
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import device as dev

__all__ = ["MULTI_POD", "SINGLE_POD", "init_group", "make_host_mesh",
           "make_mesh", "make_production_mesh", "mesh_device", "solver_mesh",
           "solver_mesh_for"]

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def init_group(device=None) -> torch.device:
    """This rank's device, with the default process group started if none
    is up.

    A ``cuda`` device becomes ``cuda:(LOCAL_RANK % device_count)`` and the
    current device.  With no group initialized, one is started: from
    ``torchrun``'s environment where ``RANK`` and ``WORLD_SIZE`` are set,
    else a ONE-RANK group through ``init_method="file://..."`` in a fresh
    temporary directory.  Its backend is ``nccl`` for a ``cuda`` device and
    ``gloo`` for ``cpu``.  A ``cuda`` device without CUDA raises
    (``device.resolve``).
    """
    device = dev.resolve(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    rank=int(os.environ["RANK"]),
                                    world_size=int(os.environ["WORLD_SIZE"]))
        else:
            store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_group_"),
                                 "store")
            dist.init_process_group(backend, init_method=f"file://{store}",
                                    rank=0, world_size=1)
    return device


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device=None) -> DeviceMesh:
    """A mesh of ``shape`` with dims named ``axes`` over every rank of the
    default group (started by :func:`init_group` where none is up), ranks
    in row-major order."""
    device = init_group(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} holds {math.prod(shape)} "
                         f"ranks; the process group has {world}: the mesh "
                         f"covers every rank")
    return DeviceMesh(device.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh of the dry-run: (16, 16) ``("data", "model")``,
    or (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``, the
    reference's shapes, over torch's fake process group of 256 or 512
    ranks in this one process (this process is rank 0; collectives
    complete without moving data).  The fake group becomes the process's
    default group: one already up must be a fake group, which is replaced
    where its size differs; a real one raises.  The dry-run's tensors are
    ``meta`` tensors on it, so nothing is allocated and no card is
    needed."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} group is up: the "
                               f"production mesh needs the fake group as "
                               f"the process's default group")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return DeviceMesh("cpu", torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> DeviceMesh:
    """A small ``("data", "model")`` mesh over the ranks there are (tests,
    examples): ``data`` and ``model`` cut to fit the world size."""
    device = init_group(device)
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, n // data)
    return make_mesh((data, model), ("data", "model"), device)


def solver_mesh(workers: int, model: int = 1, device=None) -> DeviceMesh:
    """The solver's mesh: ``data`` = workers, ``model`` = column shards."""
    return make_mesh((workers, model), ("data", "model"), device)


def solver_mesh_for(workers: int, model: int = 1, device=None) -> DeviceMesh:
    """The largest solver mesh the world size supports: ``data`` is the
    largest divisor of ``workers`` (the backend shards the m row blocks
    over it) that fits the world size over ``model``; on a one-rank group
    a (1, 1) mesh."""
    device = init_group(device)
    budget = max(1, dist.get_world_size() // max(1, model))
    data = max(d for d in range(1, workers + 1)
               if workers % d == 0 and d <= budget)
    return make_mesh((data, model), ("data", "model"), device)
