"""Batch packing (the port's copy of `repro/data/tokens.py::pack_batch`;
the record format of that module belongs to the BuffetFS corpus, which the
port does not read yet)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def pack_batch(samples: list, seq_len: int, pad_id: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack variable-length samples into (tokens, loss_mask) of [B, seq_len]."""
    b = len(samples)
    out = np.full((b, seq_len), pad_id, dtype=np.int32)
    mask = np.zeros((b, seq_len), dtype=np.float32)
    for i, s in enumerate(samples):
        n = min(len(s), seq_len)
        out[i, :n] = s[:n]
        mask[i, :n] = 1.0
    return out, mask
