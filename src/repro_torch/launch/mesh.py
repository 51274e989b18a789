"""Production meshes and the card's constants.

Port of ``repro.launch.mesh``.  ``make_production_mesh`` returns a
:class:`~repro_torch.parallel.sharding.MeshShape` (axis names and sizes,
no devices): single-pod 16 x 16 as (data, model), multi-pod 2 x 16 x 16
as (pod, data, model), the reference's layouts, so their specs and shard
shapes resolve without a process a device.  ``make_device_mesh`` is the
live (data, model) ``DeviceMesh`` a sharded step runs on
(``launch/steps.place_cell``); ``make_host_mesh`` is the initialised
process group's world as a 1-D ``("data",)`` ``DeviceMesh``.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.sharding import MeshShape, mesh_size


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_card_mesh() -> MeshShape:
    """One card as a (data, model) mesh of 1 x 1 (the one-card dry run)."""
    return MeshShape(("data", "model"), (1, 1))


def make_device_mesh(shape: Union[MeshShape, Tuple[int, int]],
                     device: DeviceLike = None) -> DeviceMesh:
    """The live ``DeviceMesh`` of ``shape`` (a ``MeshShape``, with its axis
    names, or the (data, model) sizes) over every rank of the initialised
    process group, on ``device``'s type (``None`` means ``"cuda"``).  Over
    a gloo group of ranks on one card, run DTensor's collectives under
    ``repro_torch.parallel.peer_staged.PeerStaged``."""
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    if not isinstance(shape, MeshShape):
        shape = MeshShape(("data", "model"), tuple(shape))
    if mesh_size(shape) != dist.get_world_size():
        raise ValueError(f"a {shape.sizes} mesh needs {mesh_size(shape)} "
                         f"ranks; the group has {dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, shape.sizes,
                            mesh_dim_names=shape.axis_names)


def make_host_mesh() -> DeviceMesh:
    """Every rank of the initialised process group as a 1-D (data,) mesh
    (on the CUDA devices under NCCL, on the CPU otherwise)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (dist.get_world_size(),),
                            mesh_dim_names=("data",))


# NVIDIA H100 SXM5 constants for the roofline model (per card), from
# NVIDIA's datasheet at the 700 W limit: datasheet figures, not
# measurements of this port.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12                  # B/s, HBM3
NVLINK_BW = 450e9                 # B/s, NVLink 4, one direction
