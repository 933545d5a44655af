"""Training batches from an in-memory corpus: what
`repro/data/pipeline.py::DataPipeline` yields, without BuffetFS.

A batch is a dict of numpy arrays, `tokens` [B, S] int32, `labels` [B, S]
int32 (tokens shifted by one) and `loss_mask` [B, S] fp32, built as
`DataPipeline._build_batch` builds it.  The port's Trainer takes any
iterable of such dicts, so the JAX `DataPipeline` over a BuffetFS cluster
can feed it too.
"""
from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np

from .sampler import ShardedSampler
from .tokens import pack_batch


def corpus_batches(corpus: Sequence[np.ndarray], sampler: ShardedSampler,
                   seq_len: int, pad_id: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    for indices in sampler:
        tokens, mask = pack_batch([corpus[i] for i in indices], seq_len + 1, pad_id)
        yield {"tokens": tokens[:, :-1],
               "labels": tokens[:, 1:].astype(np.int32),
               "loss_mask": mask[:, 1:]}
