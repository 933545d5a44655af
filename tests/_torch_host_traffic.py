"""What a step does that a CUDA graph cannot replay, recorded op by op.

The Server captures its decode step as a CUDA graph on the card
(`repro_torch/launch/serve.py`).  A graph replays kernels on fixed
addresses: a read back to the host, an output whose size depends on the
data, a tensor made from host data or a copy from the CPU to the card
would either fail the capture or be frozen into it.  `HostTraffic` is a
dispatch mode that records such ops; tests/test_torch_serve_graph.py
traces the step on "meta" tensors with it, tests/test_torch_cuda.py on the
dry run's fake "cuda" tensors.
"""
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


# ops a captured step may not run: a read back to the host, an output whose
# size depends on the data, a tensor made from host data
HOST_OPS = frozenset({"_local_scalar_dense", "item", "nonzero", "masked_select",
                      "lift_fresh", "lift_fresh_copy"})


class HostTraffic(TorchDispatchMode):
    """While entered, records the name of every aten op (`names`, noted
    before the op runs: a read back to the host raises on a tensor with no
    values), and the ops that take a CPU tensor and give a tensor on
    another device (`to_device`).  `host_ops()` is the recorded ops of
    HOST_OPS.  Trace a step on tensors with no values (fake, or on "meta")
    and a host read fails the trace itself."""

    def __init__(self) -> None:
        super().__init__()
        self.names: set = set()
        self.to_device: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.names.add(name)
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if (any(t.device.type == "cpu" for t in ins)
                and any(t.device.type != "cpu" for t in outs)):
            self.to_device.append(name)
        return out

    def host_ops(self) -> list:
        return sorted(self.names & HOST_OPS)
