"""repro_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a).

Each subpackage holds the wrapper of one kernel (`kernel.py`, which counts
its launches in `<wrapper>.launches`) and its plain PyTorch version
(`ref.py`).  The CUDA sources live in `csrc/` and are built at first use by
`_build.py`.  A wrapper given a CPU tensor runs the plain version; given a
CUDA tensor it launches the kernel or raises.

Ported so far (the serve path): rmsnorm, flash-attention forward, decode
attention.  The others are listed in ROADMAP.md.
"""
from .decode_attention import decode_attention, decode_attention_ref
from .flash_attention import attention_ref, flash_attention_fwd, lse_ref
from .rmsnorm import rmsnorm, rmsnorm_ref

WRAPPERS = (rmsnorm, flash_attention_fwd, decode_attention)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = ["WRAPPERS", "attention_ref", "decode_attention", "decode_attention_ref",
           "flash_attention_fwd", "launches", "lse_ref", "reset_launches",
           "rmsnorm", "rmsnorm_ref"]
