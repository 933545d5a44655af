"""repro_torch.data — the port's training batches (sampler, packing and an
in-memory corpus source; the BuffetFS-backed dataset stays in the JAX
package for now, see ROADMAP.md)."""
from .pipeline import corpus_batches
from .sampler import ShardedSampler
from .tokens import pack_batch

__all__ = ["ShardedSampler", "corpus_batches", "pack_batch"]
