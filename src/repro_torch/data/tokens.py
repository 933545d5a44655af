"""Sample record format of the BuffetFS-served training corpus, and batch
packing: the port's copy of `repro/data/tokens.py`.

Each training sample is ONE SMALL FILE — the workload the paper targets
("machine learning ... access enormous small files").  A record is a tiny
fixed header plus raw little-endian token ids:

    [ magic u32 ][ version u16 ][ dtype u8 ][ reserved u8 ][ n_tokens u32 ][ tokens ]
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

MAGIC = 0xB0FFE7F5
_HDR = struct.Struct("<IHBBI")

_DTYPES = {0: np.uint16, 1: np.uint32}
_DTYPE_IDS = {np.dtype(np.uint16): 0, np.dtype(np.uint32): 1}


def encode_sample(tokens: np.ndarray) -> bytes:
    tokens = np.ascontiguousarray(tokens)
    if tokens.dtype not in _DTYPE_IDS:
        tokens = tokens.astype(np.uint32)
    did = _DTYPE_IDS[tokens.dtype]
    return _HDR.pack(MAGIC, 1, did, 0, tokens.size) + tokens.tobytes()


def decode_sample(blob: bytes) -> np.ndarray:
    magic, _ver, did, _r, n = _HDR.unpack_from(blob, 0)
    if magic != MAGIC:
        raise ValueError("bad sample magic")
    dt = _DTYPES[did]
    return np.frombuffer(blob, dtype=dt, count=n, offset=_HDR.size)


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
