"""Serve step functions of the port (counterpart of the serve half of
`repro/runtime/steps.py`; the train step comes with the training slice)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig
from ..models.transformer import decode_step, prefill


def prefill_step(params: Any, cache: Any, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig):
    return prefill(params, batch, cfg, cache)


def serve_step(params: Any, cache: Any, batch: Dict[str, torch.Tensor],
               pos: int, cfg: ModelConfig):
    """One-token decode against a cache filled to `pos`."""
    return decode_step(params, batch, cfg, cache, pos)
