"""repro_torch — the PyTorch/CUDA port of the JAX model stack in `repro`.

The package mirrors `repro`'s module layout (configs, kernels, models,
runtime, launch) so every function has a counterpart of the same name.  It
imports `torch` and numpy only: never `jax`, and nothing of `repro`.

Kernels are hand-written CUDA C++ for Hopper (`kernels/csrc`), built with
`nvcc` at first use.  Each kernel wrapper dispatches on the tensor's device:
a CPU tensor takes the kernel's plain PyTorch version, a CUDA tensor launches
the kernel or raises.  Entry points run on `cuda` unless the caller passes
`device="cpu"`.
"""
