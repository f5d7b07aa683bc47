"""Device meshes over the initialised process group; port of
``repro.launch.mesh``.

Single pod: 256 ranks as (16, 16) over ("data", "model").  Multi-pod: 512
ranks as (2, 16, 16) over ("pod", "data", "model"); the "pod" axis crosses
hosts and carries pure data parallelism.

Functions, not module constants, so that importing this module touches no
process group.  The device type follows the group's backend (NCCL: cuda,
else cpu) unless the caller names it.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

__all__ = ["make_production_mesh", "make_local_mesh", "mesh_device_type"]


def mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first (torchrun sets one up)")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = _world()
    if world != need:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'single-pod'} production mesh "
            f"{shape} over {axes} needs a world of {need} ranks; this process "
            f"group has {world}")
    return init_device_mesh(device_type or mesh_device_type(), shape,
                            mesh_dim_names=axes)


def make_local_mesh(device_type: Optional[str] = None):
    """Every rank of the process group as a 1-D "data" mesh (tests, the
    training driver)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or mesh_device_type(), (_world(),),
                            mesh_dim_names=("data",))
