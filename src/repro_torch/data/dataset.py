"""BuffetDataset — a corpus of small sample files over a BuffetFS namespace:
the port's copy of `repro/data/dataset.py`, the same layout and bytes.

Layout (directory-granular placement spreads shard dirs across BServers):

    /corpus/<name>/shard_0000/s_000000.tok
    /corpus/<name>/shard_0000/s_000001.tok
    ...
    /corpus/<name>/shard_0001/...
    /corpus/<name>/replica_0000/...          (optional, for hedged reads)
    /corpus/<name>/INDEX                     (sample counts per shard)

Reading a sample is open()+read()+close() of one small file: under BuffetFS
that is ONE critical-path RPC once shard directories are cached.  `lib` is
the storage client the caller passes in (a `repro.core.BLib`, or
`dirfs.DirLib` on a local directory); this module makes on it exactly the
calls the JAX module makes on a `BLib`.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np

from .tokens import decode_sample, encode_sample


@dataclass
class DatasetSpec:
    name: str
    n_shards: int
    samples_per_shard: List[int]
    seq_len_hint: int = 0
    replicated: bool = False

    @property
    def n_samples(self) -> int:
        return sum(self.samples_per_shard)


class BuffetDataset:
    """Read/write access to one corpus over a storage client."""

    def __init__(self, lib: Any, root: str = "/corpus", name: str = "default") -> None:
        self.lib = lib
        self.base = f"{root}/{name}"
        self.name = name
        self._spec: Optional[DatasetSpec] = None

    # --- write side -------------------------------------------------------
    @staticmethod
    def build(lib: Any, samples: List[np.ndarray], *, root: str = "/corpus",
              name: str = "default", shard_size: int = 256,
              replicate: bool = False) -> "BuffetDataset":
        """Materialize a corpus as many small files (the paper's workload)."""
        ds = BuffetDataset(lib, root, name)
        lib.makedirs(ds.base)
        counts: List[int] = []
        for si in range(0, max(1, (len(samples) + shard_size - 1) // shard_size)):
            shard = samples[si * shard_size : (si + 1) * shard_size]
            sdir = f"{ds.base}/shard_{si:04d}"
            lib.makedirs(sdir)
            for j, s in enumerate(shard):
                lib.write_file(f"{sdir}/s_{j:06d}.tok", encode_sample(s))
            counts.append(len(shard))
            if replicate:
                rdir = f"{ds.base}/replica_{si:04d}"
                lib.makedirs(rdir)
                for j, s in enumerate(shard):
                    lib.write_file(f"{rdir}/s_{j:06d}.tok", encode_sample(s))
        spec = DatasetSpec(name=name, n_shards=len(counts),
                           samples_per_shard=counts, replicated=replicate)
        lib.write_file(f"{ds.base}/INDEX", json.dumps(spec.__dict__).encode())
        ds._spec = spec
        return ds

    # --- read side ----------------------------------------------------------
    @property
    def spec(self) -> DatasetSpec:
        if self._spec is None:
            blob = self.lib.read_file(f"{self.base}/INDEX")
            self._spec = DatasetSpec(**json.loads(blob.decode()))
        return self._spec

    def sample_path(self, idx: int, *, replica: bool = False) -> str:
        spec = self.spec
        for si, cnt in enumerate(spec.samples_per_shard):
            if idx < cnt:
                prefix = "replica" if replica else "shard"
                return f"{self.base}/{prefix}_{si:04d}/s_{idx:06d}.tok"
            idx -= cnt
        raise IndexError(idx)

    def read_sample(self, idx: int, *, replica: bool = False) -> np.ndarray:
        return decode_sample(self.lib.read_file(self.sample_path(idx, replica=replica)))

    def warm_dirs(self) -> None:
        """Pre-cache shard directories: after this, every open() in the
        epoch is permission-checked locally (zero metadata RPCs)."""
        spec = self.spec
        for si in range(spec.n_shards):
            self.lib.agent.warm(f"{self.base}/shard_{si:04d}")

    def __len__(self) -> int:
        return self.spec.n_samples
