"""repro_torch.models — the port's model zoo (dense decoder: train and serve
paths)."""
from .transformer import decode_step, forward, init_cache, init_model, loss_fn, prefill

__all__ = ["decode_step", "forward", "init_cache", "init_model", "loss_fn", "prefill"]
