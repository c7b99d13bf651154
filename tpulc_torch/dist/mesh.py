"""Device mesh for block data-parallelism (port of `tpulc/dist/mesh.py`).

tpulc's mesh is a 1-D `jax.sharding.Mesh` over the `'blocks'` axis of
one process's devices.  Here a rank is one process on one device, and
the mesh is a 1-D `DeviceMesh` named "blocks" over an initialised
process group (NCCL on the card, gloo on the CPU).  Rank r holds the
contiguous block shard [r B / W, (r + 1) B / W), tpulc's `P('blocks')`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tpulc_torch.device import resolve

BLOCKS_AXIS = "blocks"


def make_mesh(n: int | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """1-D mesh over every rank of the initialised default group.

    n, when given, must be the world size (a rank drives one device);
    device_type defaults to "cuda", where rank r takes card r % count."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks over a group of {world}")
    dev = resolve(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (world,),
                            mesh_dim_names=(BLOCKS_AXIS,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
