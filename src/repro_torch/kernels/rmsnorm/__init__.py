from .kernel import rmsnorm, rmsnorm_bwd
from .ops import rmsnorm_op
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_bwd", "rmsnorm_bwd_ref", "rmsnorm_op", "rmsnorm_ref"]
