"""Elastic scaling: re-mesh and re-shard a training job when the device
count changes (node failure, pool resize).  The port of
`repro/runtime/elastic.py`.

The checkpoint layer stores arrays whole (part-split along axis 0; a
sharded state is gathered leaf by leaf at save time), so elasticity is a
host-side concern:

  1. detect the new device count,
  2. build the largest (data, model) mesh that fits it,
  3. restore the latest checkpoint straight onto the new mesh's placements:
     each rank reads every leaf's part files on its host and copies only its
     own shard to its device (`CheckpointManager.restore` into `Placed`
     leaves), as JAX's `device_put(state, shardings)` hands each device its
     shard, so no device ever holds a whole sharded leaf,
  4. rebuild the sampler at the saved train step.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

import torch.distributed as dist

from ..ckpt import CheckpointManager
from ..ckpt.manager import Placed
from ..data import ShardedSampler
from . import sharding as sh


def best_mesh_shape(n_devices: int, *, prefer_model: int = 16
                    ) -> Tuple[int, int]:
    """Largest (data, model) grid for n_devices: model axis capped at
    prefer_model, data gets the rest; falls back toward (n, 1)."""
    model = min(prefer_model, n_devices)
    while model > 1 and n_devices % model:
        model -= 1
    return n_devices // model, model


def remesh(n_devices: Optional[int] = None, device_type: str = "cuda", *,
           prefer_model: int = 16):
    """The (data, model) `DeviceMesh` of `best_mesh_shape` over the default
    process group's ranks (all of them by default; the mesh must cover the
    world)."""
    from torch.distributed.device_mesh import init_device_mesh
    data, model = best_mesh_shape(n_devices or dist.get_world_size(),
                                  prefer_model=prefer_model)
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


@dataclass
class ElasticRestore:
    mesh: Any
    state: Any
    step: int
    sampler: ShardedSampler


def elastic_restore(ckpt: CheckpointManager, like_state: Any, global_batch: int,
                    n_samples: int, mesh, specs: Any = None) -> ElasticRestore:
    """Restore the latest checkpoint onto the `DeviceMesh` `mesh`.

    `like_state` gives only the structure, shapes, dtypes and device: plain
    tensors, DTensors (on any mesh) or `steps.abstract_state`'s fake
    tensors, so a state too large for one device needs no real copy of it.
    `specs` (optional) is a spec tree matching it built for the NEW mesh
    (`steps.train_state_specs`), by which every leaf is placed as it is
    read: each rank copies only its own shard of it to the device (a leaf
    whose spec is None comes back plain, whole on every rank).  Without
    `specs` each leaf comes back as `like_state`'s is (a DTensor at its
    placements, else plain).

    The sampler stands at the manifest's `train_step`, with the saved seed,
    as the port's `Trainer.init_or_restore` sets it: JAX's elastic restore
    loads the saved sampler state, whose step the producer thread has run
    ahead of training, and would skip batches that were read and never
    trained on.
    """
    like = like_state if specs is None else sh.map_specs(
        like_state, specs, lambda t, s: replace(
            Placed.of(t), mesh=None if s is None else mesh,
            placements=() if s is None else tuple(sh.placements(s, mesh))))
    step, state = ckpt.restore(like=like)
    man = ckpt.manifest(step)
    train_step = int(man.extra.get("train_step", step))
    s = ShardedSampler(n_samples=n_samples, global_batch=global_batch,
                       dp_rank=0, dp_size=1)
    s.load_state_dict({"step": train_step,
                       "seed": man.extra.get("sampler", {}).get("seed", s.seed)})
    return ElasticRestore(mesh=mesh, state=state, step=train_step, sampler=s)
