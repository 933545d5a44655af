"""Mesh construction of the port: the counterpart of `repro/launch/mesh.py`.

Functions (never a module-level constant), so importing this module touches
no device and no process group.  Each builds a `DeviceMesh` over the ranks
of the default process group, which the caller initialises first
(`torch.distributed.init_process_group` with its own address, world size
and rank).  Shapes: 16x16 = one pod of 256 cards; 2x16x16 = two pods (512
cards) with a leading "pod" axis.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, shape=None, device_type: str = "cuda"):
    """The production mesh, (16, 16) ("data", "model") or with `multi_pod`
    (2, 16, 16) ("pod", "data", "model"); `shape` gives another of two or
    three dims with the same names (the dry run's (1, 1) and (2, 2) cells).
    The process group must have exactly that many ranks."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    shape = tuple(shape)
    axes = ("pod", "data", "model")[-len(shape):]
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"the production mesh {shape} needs a world size of {n}, "
                         f"not {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """Small (data, model) mesh over the process group's ranks (tests and
    examples; `device_type="cpu"` with the gloo backend)."""
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
