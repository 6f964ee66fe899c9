"""Device meshes.  Counterpart of ``repro/launch/mesh.py``: functions, not
module constants, so importing this module touches no process group.

A ``DeviceMesh`` spans the ranks of a ``torch.distributed`` world; nothing
on a machine tells a program of a cluster, so a multi-rank caller starts
the world itself (``init_process_group`` with its address, size and rank)
before it asks for a mesh.
"""
from __future__ import annotations

import math
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (16,16) over ("data","model") = 256 ranks.
    Multi-pod: (2,16,16) over ("pod","data","model") = 512 ranks.  The
    world must already hold exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != math.prod(shape):
        raise RuntimeError(
            f"the production mesh {dict(zip(axes, shape))} needs a world of "
            f"{math.prod(shape)} ranks; "
            + (f"this one has {world}" if world else "none is initialized"))
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(device):
    """A (1,1) ("data","model") mesh on ``device``'s type.  Starts a
    one-rank world (gloo on the CPU, nccl on CUDA, over a file store in a
    temporary directory) when none exists; raises when the existing world
    has more than one rank."""
    dev = resolve_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise RuntimeError(f"make_local_mesh needs a one-rank world; "
                               f"this one has {dist.get_world_size()} ranks")
    else:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_mesh_"),
                            "store")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.FileStore(path, 1), rank=0,
                                world_size=1)
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data",
                                                               "model"))
