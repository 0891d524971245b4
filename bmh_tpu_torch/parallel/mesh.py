"""The block axis as a device mesh (bmh_tpu/parallel/mesh.py on torch.distributed).

Every block is independent (its own BWT shift and Huffman table), so data
parallelism rides a 1-D mesh over blocks.  In PyTorch's idiom a mesh is a
`DeviceMesh` with one process per device: over cards it runs on NCCL, over
the CPU on gloo.  The default process group comes from the caller
(`torch.distributed.init_process_group`); where none exists,
`init_device_mesh` makes one from the environment (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BLOCK_AXIS = "blocks"


def make_mesh(n_devices: int | None = None, axis_name: str = BLOCK_AXIS,
              local: bool = False, device="cuda") -> DeviceMesh:
    """A 1-D mesh of one process per device, its dimension named
    `axis_name`.  By default it spans every process of the group;
    local=True spans this host's processes only (LOCAL_WORLD_SIZE of
    them, the whole group where that is unset), the per-host pattern of
    bmh_tpu's local mesh.  n_devices, where given, must equal the span.
    `device` is "cuda" (each process on card rank % cards, NCCL) or "cpu"
    (gloo)."""
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for "
                           "a gloo mesh over the CPU")
    world = dist.get_world_size() if dist.is_initialized() else int(
        os.environ.get("WORLD_SIZE", "1"))
    span = int(os.environ.get("LOCAL_WORLD_SIZE", world)) if local else world
    if n_devices is not None and n_devices != span:
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} "
                         f"processes; this group has {span}")
    if world % span:
        raise ValueError(f"LOCAL_WORLD_SIZE {span} does not divide the world {world}")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                                 if dist.is_initialized() else 0))
                              % torch.cuda.device_count())
    if span == world:
        return init_device_mesh(device_type, (world,), mesh_dim_names=(axis_name,))
    return init_device_mesh(device_type, (world // span, span),
                            mesh_dim_names=("hosts", axis_name))[axis_name]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this process works on in `mesh`."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def block_sharding(mesh: DeviceMesh, axis_name: str = BLOCK_AXIS):
    """This process's stripe of the leading (block) axis: a function that
    takes a (B, ...) tensor, B divisible by the mesh size, and returns rows
    [r * B/n, (r + 1) * B/n) for this process's coordinate r, where
    PartitionSpec(axis_name) puts them."""
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    r = mesh.get_local_rank(axis_name)

    def stripe(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"{b} blocks do not split over {n} devices")
        return x[r * (b // n):(r + 1) * (b // n)]

    return stripe
