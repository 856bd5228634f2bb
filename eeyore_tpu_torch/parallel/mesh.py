"""Process meshes for chain- and temperature-axis sharding, on torch.distributed.

Counterpart of ``eeyore_tpu/parallel/mesh.py``. One process is one rank and
owns one device: ``cuda:{local rank}`` on the card (``initialize_distributed``
selects it), the CPU when the caller asks (``devices="cpu"``). A mesh axis is
a process group: a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with JAX's axis names, over every rank of the default group.

With no process group a mesh is a world of one (``LocalMesh``): this process
and its device, as JAX's ``chain_mesh()`` over one device. The collectives
of ``parallel/sharded.py`` skip the transport only there; a group of any
size, a one-rank NCCL group included, goes through the group.
"""

import math
import os
from typing import NamedTuple

import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           device="cuda", backend=None):
    """Join the process group (no-op when ``coordinator_address`` is None,
    as in JAX). ``coordinator_address`` is ``host:port`` (a ``tcp://``
    address) or any ``init_method`` URL (``file://...``, ``env://``). On a
    CUDA ``device`` the rank selects ``cuda:{LOCAL_RANK}`` (torchrun's), else
    ``cuda:{process_id % device_count}``, unless ``device`` names an index;
    ``backend`` defaults to NCCL there and to Gloo on the CPU."""
    if coordinator_address is None:
        return
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(index)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    address = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=process_id)


class LocalMesh:
    """A world of one: this process and its device, axes of size 1. It
    answers the part of ``DeviceMesh``'s interface the port reads."""

    def __init__(self, device, mesh_dim_names):
        self.device = torch.device(device)
        self.mesh_dim_names = tuple(mesh_dim_names)

    def get_group(self, mesh_dim=None):
        return None

    def __repr__(self):
        return f"LocalMesh({self.device}, {self.mesh_dim_names})"


def _mesh(devices, shape, names):
    """A mesh of ``shape`` with the axes ``names`` over the default group's
    ranks, each on its device of type ``devices`` (None: the card, the one
    ``initialize_distributed`` selected), or a world of one without a group."""
    device = torch.device("cuda" if devices is None else devices)
    if not dist.is_initialized():
        if any(s != 1 for s in shape):
            raise ValueError(f"a mesh of shape {shape} needs a process group of "
                             f"{math.prod(shape)} ranks; with none a mesh is "
                             "a world of one (initialize_distributed)")
        return LocalMesh(device, names)
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} must span the group's {world} ranks")
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=tuple(names))


def chain_mesh(num_devices=None, axis_name="chains", devices=None):
    """1-D mesh over the chain axis: every rank of the process group (a
    world of one without one). ``num_devices``, when given, must be that
    count; ``devices`` is the ranks' device type (None: the card)."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh(devices, (size if num_devices is None else num_devices,), (axis_name,))


def ladder_mesh(num_chain_shards, num_temp_shards, devices=None,
                chain_axis="chains", temp_axis="temp"):
    """2-D mesh (chains, temp) over ``num_chain_shards * num_temp_shards``
    ranks, rank ``c * num_temp_shards + t`` at (c, t): a temperature axis is
    a group of consecutive ranks, which on one host share NVLink."""
    return _mesh(devices, (num_chain_shards, num_temp_shards), (chain_axis, temp_axis))


def axis_group(mesh, axis_name):
    """The process group of ``mesh``'s axis ``axis_name`` (None in a world of one)."""
    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh has axes {mesh.mesh_dim_names}, not {axis_name!r}")
    return mesh.get_group(axis_name)


def mesh_device(mesh):
    """This rank's device in ``mesh``."""
    if isinstance(mesh, LocalMesh):
        return mesh.device
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class ChainSharding(NamedTuple):
    """This rank's share of a leading (chain) axis sharded over a mesh axis,
    the rest replicated: its ``rank`` of ``size`` along the axis, its
    ``device`` and the axis's process ``group`` (None in a world of one)."""

    rank: int
    size: int
    device: torch.device
    group: object

    def rows(self, n):
        """The slice of this rank's rows of a leading axis of length ``n``."""
        if n % self.size:
            raise ValueError(f"a leading axis of {n} does not divide over {self.size} shards")
        block = n // self.size
        return slice(self.rank * block, (self.rank + 1) * block)

    def shard(self, tensor):
        """This rank's rows of the global ``tensor``, on its device."""
        tensor = torch.as_tensor(tensor)
        return tensor[self.rows(tensor.shape[0])].to(self.device)


def chain_sharding(mesh, axis_name="chains"):
    """Shard the leading (chain) axis over ``axis_name``, replicate the rest."""
    group = axis_group(mesh, axis_name)
    if group is None:
        return ChainSharding(0, 1, mesh_device(mesh), None)
    return ChainSharding(dist.get_rank(group), dist.get_world_size(group), mesh_device(mesh),
                         group)
