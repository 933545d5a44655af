"""repro_torch.models — the port's model zoo (dense decoder serve path)."""
from .transformer import decode_step, init_cache, init_model, prefill

__all__ = ["decode_step", "init_cache", "init_model", "prefill"]
