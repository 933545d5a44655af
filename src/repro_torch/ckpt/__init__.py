"""repro_torch.ckpt — the port's checkpoints over BuffetFS, in the JAX
package's layout."""
from .manager import CheckpointManager, Manifest

__all__ = ["CheckpointManager", "Manifest"]
