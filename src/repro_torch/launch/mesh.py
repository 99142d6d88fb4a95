"""The launcher's meshes, the port of ``repro.launch.mesh``: ``make_mesh``
over the ranks of a ``torch.distributed`` world, the production meshes,
and the card's constants for the roofline.

The mesh itself (``ProcessMesh``, ``AbstractMesh``) lives in
``core.mesh``, which the model, serving and training layers import; this
module adds what only a launcher needs. A production mesh runs in a world
of 256 or 512 ranks started by ``torchrun``, one card a rank, over NCCL
(``production_mesh_from_env``).

Importing this module touches no device and no process group.
"""
from __future__ import annotations

import os
from math import prod

import torch
import torch.distributed as dist

from repro_torch.core.api import YdfError
from repro_torch.core.mesh import AbstractMesh, ProcessMesh

# NVIDIA H100 80GB HBM3, 700.00 W (NVIDIA's data sheet, SXM part, dense
# rates): the least time a piece of work can take on one card is its
# operations over these peaks or its bytes over the memory rate. The card's
# power limit, as nvidia-smi reports it, goes beside every number measured
# against them.
H100_BF16_FLOPS = 989e12       # FLOP/s, bf16 on the tensor cores
H100_F32_FLOPS = 67e12         # FLOP/s, float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12     # HBM3 bytes/s
H100_HBM_BYTES = 80e9          # 80 GB of device memory
H100_NVLINK_BYTES_PER_S = 450e9  # NVLink 4, each direction (900 GB/s both)

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape, axes, *, device=None) -> ProcessMesh:
    """The default process group's ranks as a mesh of ``axes`` sized
    ``shape`` (a world of prod(shape) ranks; collective)."""
    return ProcessMesh(shape, axes, device)


def production_mesh_shape(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 = 256 chips per pod; multi_pod adds a leading 2-pod axis."""
    return AbstractMesh(*PRODUCTION_SHAPES[multi_pod])


def production_world_error(world: int, *, multi_pod: bool) -> YdfError | None:
    """The refusal of a production mesh in a world of ``world`` ranks."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    if world == prod(shape):
        return None
    return YdfError(f"the {'multi' if multi_pod else 'single'}-pod production mesh "
                    f"{dict(zip(axes, shape))} needs a world of {prod(shape)} ranks; "
                    f"this one has {world}")


def make_production_mesh(*, multi_pod: bool = False, device=None) -> ProcessMesh:
    """The production mesh over the default process group, which must hold
    256 ranks (512 with ``multi_pod``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    err = production_world_error(world, multi_pod=multi_pod)
    if err is not None:
        raise err
    return ProcessMesh(*PRODUCTION_SHAPES[multi_pod], device)


def production_mesh_from_env(*, multi_pod: bool, device=None) -> ProcessMesh:
    """The production mesh of a world started by ``torchrun`` (env://
    rendezvous: WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT),
    the size checked before any process group is made. On the card each
    rank takes the card of its LOCAL_RANK and the world runs NCCL; on the
    CPU, gloo. (Ranks that share one card are ``core.distributed.run_world``'s,
    on gloo; not this.)"""
    from repro_torch.core.engines import resolve_device
    world = int(os.environ.get("WORLD_SIZE", "1"))
    err = production_world_error(world, multi_pod=multi_pod)
    if err is not None:
        raise err
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise YdfError(f"local rank {local} has no card of its own: this host "
                           f"has {torch.cuda.device_count()}")
        dev, backend = torch.device("cuda", local), "nccl"
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return make_production_mesh(multi_pod=multi_pod, device=dev)
