"""Build the port's CUDA kernels at first use and bind them with ctypes.

`load()` compiles every `csrc/*.cu` for `sm_90a` with `nvcc` (one process per
source, all started together), links the objects into one shared library
under `build/repro_torch_kernels/` at the root of the checkout, and loads it.
The library's name carries a hash of the sources and flags: an edited source
is rebuilt, an unchanged one is loaded from the build directory.  Each
source's `ptxas -v` report (registers, shared memory, spills) is kept beside
it as `<source>.log`.

The sources export plain C entry points.  Each takes its pointers and the
CUDA stream as `void*`, launches on that stream without synchronising or
allocating, and returns `cudaGetLastError()`; `check()` raises on a non-zero
code.  Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME or put it on PATH)")


def _sources() -> Sequence[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [*srcs, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(nvcc: str, srcs: Sequence[Path], target: Path) -> None:
    tmp = BUILD_DIR / f"tmp-{os.getpid()}-{target.stem}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in srcs:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c",
               str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        (BUILD_DIR / f"{src.name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    so_tmp = tmp / target.name
    link = [nvcc, *NVCC_FLAGS, "-shared", *(str(o) for _, o, _ in procs),
            "-o", str(so_tmp)]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
    os.replace(so_tmp, target)        # atomic: concurrent builds both succeed
    shutil.rmtree(tmp, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on any failure."""
    nvcc = nvcc_path()
    srcs = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"librepro_torch_kernels-{_digest(srcs)}.so"
    if not target.exists():
        _build(nvcc, srcs, target)
    lib = ctypes.CDLL(str(target))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def function(name: str, argtypes: tuple):
    """The C entry point `name` of the kernel library, typed."""
    fn = getattr(load(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = load().repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device, *, vector: bool = True) -> None:
    """Raise unless `t` is a `dtype` tensor on `device` whose last dim is
    contiguous and, when the kernel reads it in 16-byte vectors (`vector`),
    whose other strides and data pointer keep those loads aligned.  Nothing
    is cast or copied: a tensor the kernel cannot take is an error.  A fake
    tensor (the dry run's, on any device) is held to the same rules but for
    the data pointer, which it has not: its abstract path refuses what the
    kernel's refuses."""
    fake = isinstance(t, FakeTensor)
    if not (fake or t.is_cuda) or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not vector:
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous (strides {t.stride()})")
        return
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dim must be contiguous")
    vec = 16 // t.element_size()
    if (not fake and t.data_ptr() % 16) or any(st % vec for st in t.stride()[:-1]):
        raise ValueError(f"{name}: data pointer and strides must keep 16-byte "
                         f"alignment (strides {t.stride()})")


def kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """`t` itself if its last dim is contiguous and its strides and data
    pointer keep 16-byte loads aligned (what `require` takes), else a
    contiguous copy.  For tensors the caller does not control the layout
    of, such as the gradients autograd hands to a backward.  A fake tensor
    (the dry run's) has no data pointer: its strides alone decide."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and (isinstance(t, FakeTensor) or t.data_ptr() % 16 == 0)
            and all(st % vec == 0 for st in t.stride()[:-1])):
        return t
    return t.contiguous()


def stream(t) -> int:
    """PyTorch's current stream on `t`'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
