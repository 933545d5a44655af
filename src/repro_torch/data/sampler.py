"""Deterministic, shardable, resumable sample-order generation.

Every data-parallel host derives the SAME global permutation per epoch from
(seed, epoch) and takes a strided slice — no coordination RPCs (BuffetFS
spirit: nothing central on the hot path).  The sampler state is one integer
(global step), so checkpoint/restart resumes exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

import numpy as np


def _feistel_perm(n: int, seed: int) -> np.ndarray:
    """Deterministic pseudo-random permutation of range(n)."""
    rng = np.random.default_rng(seed)
    return rng.permutation(n)


@dataclass
class ShardedSampler:
    n_samples: int
    global_batch: int
    dp_rank: int
    dp_size: int
    seed: int = 0
    step: int = 0  # resumable cursor (global steps)

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.dp_size == 0
        return self.global_batch // self.dp_size

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.n_samples // self.global_batch)

    def indices_for_step(self, step: int) -> List[int]:
        epoch = step // self.steps_per_epoch
        within = step % self.steps_per_epoch
        perm = _feistel_perm(self.n_samples, self.seed + epoch)
        base = within * self.global_batch
        sl = perm[base + self.dp_rank * self.local_batch
                  : base + (self.dp_rank + 1) * self.local_batch]
        return [int(i) for i in sl]

    def __iter__(self) -> Iterator[List[int]]:
        while True:
            yield self.indices_for_step(self.step)
            self.step += 1

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, d: dict) -> None:
        self.step = d["step"]
        self.seed = d["seed"]
