"""repro_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a).

Each subpackage holds the wrappers of its kernels (`kernel.py`, each
counting its launches in `<wrapper>.launches`), their plain PyTorch
versions (`ref.py`) and, for the train path, an autograd op (`ops.py`)
whose backward runs the backward kernels.  The CUDA sources live in `csrc/`
and are built at first use by `_build.py`.  A wrapper given a CPU tensor
runs the plain version; given a CUDA tensor it launches the kernel or
raises.

Ported: rmsnorm (forward and backward), flash attention (forward, and the
backward's dq and dk/dv passes), decode attention, fused cross-entropy
(forward and backward), and the SSD scan (forward, and its backward, which
has no TPU counterpart).
"""
from .cross_entropy import ce_bwd_ref, ce_ref, ce_rows_ref, fused_ce, fused_ce_bwd, fused_ce_op
from .decode_attention import decode_attention, decode_attention_ref
from .flash_attention import (attention_bwd_ref, attention_ref, flash_attention,
                              flash_attention_bwd, flash_attention_bwd_dkv,
                              flash_attention_bwd_dq, flash_attention_fwd, lse_ref)
from .rmsnorm import rmsnorm, rmsnorm_bwd, rmsnorm_bwd_ref, rmsnorm_op, rmsnorm_ref
from .ssd_scan import ssd_scan, ssd_scan_bwd, ssd_scan_bwd_ref, ssd_scan_op, ssd_scan_ref

WRAPPERS = (rmsnorm, rmsnorm_bwd, flash_attention_fwd, flash_attention_bwd_dq,
            flash_attention_bwd_dkv, decode_attention, fused_ce, fused_ce_bwd, ssd_scan,
            ssd_scan_bwd)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = ["WRAPPERS", "attention_bwd_ref", "attention_ref", "ce_bwd_ref", "ce_ref",
           "ce_rows_ref", "decode_attention", "decode_attention_ref", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_fwd", "fused_ce", "fused_ce_bwd", "fused_ce_op", "launches",
           "lse_ref", "reset_launches", "rmsnorm", "rmsnorm_bwd", "rmsnorm_bwd_ref",
           "rmsnorm_op", "rmsnorm_ref", "ssd_scan", "ssd_scan_bwd", "ssd_scan_bwd_ref",
           "ssd_scan_op", "ssd_scan_ref"]
