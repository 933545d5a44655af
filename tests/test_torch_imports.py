"""Rules of the port, checked on the CPU.

* `repro_torch` and `chip_smoke.py` import neither JAX nor the JAX package,
  nor `ml_dtypes` (the card's machine has none); nor do the gloo tests'
  rank modules.
* A kernel wrapper dispatches on `tensor.is_cuda` alone, after its one
  test for a fake tensor (the abstract path): a CUDA tensor goes to the
  kernel or raises, and never reaches the plain version; a fake tensor
  launches nothing and reaches neither.
* The kernels are built from the repo's CUDA sources, at first use only.
* `chip_smoke.py` exits non-zero and prints no result without a card or
  without the repo around it.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import ast
import importlib
import inspect
import json
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                        "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert {"repro_torch.convert", "repro_torch.launch.serve",
            "repro_torch.launch.train", "repro_torch.models.transformer",
            "repro_torch.runtime.steps", "repro_torch.optim.adamw",
            "repro_torch.data.sampler", "repro_torch.data.tokens",
            "repro_torch.data.pipeline", "repro_torch.tree",
            "repro_torch.configs.stablelm_3b", "repro_torch.kernels._build",
            "repro_torch.kernels.cross_entropy.kernel",
            "repro_torch.kernels.cross_entropy.ops",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.rmsnorm.ops", "repro_torch.kernels.ssd_scan.kernel",
            "repro_torch.kernels.ssd_scan.ops",
            "repro_torch.models.ssm", "repro_torch.configs.mamba2_130m",
            "repro_torch.configs.deepseek_v2_lite_16b",
            "repro_torch.configs.deepseek_v3_671b", "repro_torch.ckpt.manager",
            "repro_torch.data.dataset", "repro_torch.data.dirfs",
            "repro_torch.context", "repro_torch.runtime.sharding",
            "repro_torch.runtime.compression", "repro_torch.runtime.pipeline_par",
            "repro_torch.runtime.elastic", "repro_torch.launch.mesh",
            "repro_torch.analysis.model_math", "repro_torch.analysis.trace",
            "repro_torch.launch.dryrun", "repro_torch.kernels.abstract",
            "repro_torch.core.analysis", "repro_torch.core.analysis.buffetlint",
            "repro_torch.core.analysis.lockrec",
            "repro_torch.core.analysis.__main__"} <= set(mods)
    assert {f"repro_torch.core.{m}" for m in CORE_MODULES} <= set(mods)
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import importlib.util\n"
            f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'repro', 'ml_dtypes')]\n"
            "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "tests").glob("_torch_dist*_ranks.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_repro(path):
    """No module of the port, nor chip_smoke.py, nor the gloo tests' rank
    modules (which a spawned rank imports alone) names JAX or the JAX
    package."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), f"{path}: imports {n}"


# the port's BuffetFS: `repro.core`'s modules, one for one
CORE_MODULES = ("wire", "perms", "inode", "service", "transport", "repl", "bserver",
                "baselines", "cluster", "bagent", "blib", "failure")


def test_core_holds_the_jax_packages_modules_and_public_names():
    names = sorted(p.stem for p in (PKG / "core").glob("*.py"))
    assert names == sorted(CORE_MODULES + ("__init__",))
    jax_names = sorted(p.stem for p in (ROOT / "src" / "repro" / "core").glob("*.py"))
    assert names == jax_names


@pytest.mark.parametrize("path", sorted((PKG / "core").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_core_imports_the_standard_library_and_itself_only(path):
    """Every import of `repro_torch.core` is of the standard library or
    relative (within the package): its servers register into its own
    `SERVER_OPS` and never reach `repro.` or any other package."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top == "__future__" or top in sys.stdlib_module_names, \
                f"{path}: imports {n}"
            assert not n.startswith("repro"), f"{path}: imports {n}"


# every module of the JAX package: the port's file that takes its place
COUNTERPARTS = {
    "analysis/hlo.py": "analysis/trace.py",
    "analysis/model_math.py": "analysis/model_math.py",
    **{f"{d}/{m}.py": f"{d}/{m}.py" for d, names in {
        "ckpt": ("__init__", "manager"),
        "configs": ("__init__", "base", "chatglm3_6b", "command_r_35b",
                    "deepseek_v2_lite_16b", "deepseek_v3_671b", "jamba_1_5_large_398b",
                    "mamba2_130m", "musicgen_large", "pixtral_12b", "stablelm_3b",
                    "starcoder2_15b"),
        "core": ("__init__",) + CORE_MODULES,
        "core/analysis": ("__init__", "buffetlint", "lockrec"),
        "data": ("__init__", "dataset", "pipeline", "sampler", "tokens"),
        "kernels": ("__init__",),
        "kernels/cross_entropy": ("__init__", "kernel", "ops", "ref"),
        "kernels/decode_attention": ("__init__", "kernel", "ref"),
        "kernels/flash_attention": ("__init__", "kernel", "ops", "ref"),
        "kernels/rmsnorm": ("__init__", "kernel", "ops", "ref"),
        "kernels/ssd_scan": ("__init__", "kernel", "ops", "ref"),
        "launch": ("dryrun", "mesh", "serve", "train"),
        "models": ("__init__", "layers", "ssm", "transformer"),
        "optim": ("__init__", "adamw"),
        "runtime": ("__init__", "compression", "elastic", "pipeline_par", "sharding",
                    "steps"),
    }.items() for m in names},
    "context.py": "context.py",
    # a jax.jit wrapper of decode_attention: the kernel module's wrapper
    "kernels/decode_attention/ops.py": "kernels/decode_attention/kernel.py",
}


def test_every_jax_module_has_a_port_counterpart():
    """Each `.py` file of `src/repro` is in the table, and its port file
    exists."""
    jax_root = ROOT / "src" / "repro"
    jax_files = sorted(p.relative_to(jax_root).as_posix() for p in jax_root.rglob("*.py"))
    assert [f for f in jax_files if f not in COUNTERPARTS] == []
    assert [f for f in COUNTERPARTS if not (jax_root / f).is_file()] == []
    assert [v for v in COUNTERPARTS.values() if not (PKG / v).is_file()] == []


# ---------------------------------------------------------------------------
# dispatch: is_cuda alone decides, and a CUDA tensor never takes the plain path
# ---------------------------------------------------------------------------

class _LooksCuda(torch.Tensor):
    """A CPU tensor that answers is_cuda = True: what a wrapper does with a
    CUDA tensor, without a card (the C entry points are faked)."""

    @property
    def is_cuda(self):
        return True


def _cuda_like(t):
    return torch.Tensor._make_subclass(_LooksCuda, t)


_FLASH = "repro_torch.kernels.flash_attention.kernel"
_CE = "repro_torch.kernels.cross_entropy.kernel"
WRAPPERS = {
    "rmsnorm": ("repro_torch.kernels.rmsnorm.kernel", "rmsnorm_ref", "rmsnorm_bf16"),
    "rmsnorm_bwd": ("repro_torch.kernels.rmsnorm.kernel", "rmsnorm_bwd_ref",
                    "rmsnorm_bwd_bf16"),
    "flash_attention_fwd": (_FLASH, "attention_with_lse_ref", "flash_attention_fwd_bf16"),
    "flash_attention_bwd_dq": (_FLASH, "attention_bwd_dq_ref", "flash_attention_bwd_dq_bf16"),
    "flash_attention_bwd_dkv": (_FLASH, "attention_bwd_dkv_ref",
                                "flash_attention_bwd_dkv_bf16"),
    "decode_attention": ("repro_torch.kernels.decode_attention.kernel",
                         "decode_attention_ref", "decode_attention_bf16"),
    "fused_ce": (_CE, "ce_rows_ref", "ce_fwd_bf16"),
    "fused_ce_bwd": (_CE, "ce_bwd_ref", "ce_bwd_bf16"),
    "ssd_scan": ("repro_torch.kernels.ssd_scan.kernel", "ssd_scan_ref", "ssd_scan_fwd"),
    "ssd_scan_bwd": ("repro_torch.kernels.ssd_scan.kernel", "ssd_scan_bwd_ref", "ssd_scan_bwd"),
}


def _args(name, dtype=torch.bfloat16, d=32):
    """Arguments of each wrapper (`d`: the flash passes' head dim)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dt=dtype):
        return _cuda_like(torch.randn(*shape, generator=g).to(dt))

    def rows(*shape):                       # fp32 per-row tensors (lse, delta, mask, g)
        return r(*shape, dt=torch.float32)
    if name == "rmsnorm":
        return (r(4, 64), r(64)), {}
    if name == "rmsnorm_bwd":
        return (r(4, 64), r(64), r(4, 64)), {}
    if name == "flash_attention_fwd":
        return (r(1, 4, 16, d), r(1, 2, 16, d), r(1, 2, 16, d)), {}
    if name == "flash_attention_bwd_dq":
        return (r(1, 4, 16, d), r(1, 2, 16, d), r(1, 2, 16, d), r(1, 4, 16, d),
                r(1, 4, 16, d), rows(1, 4, 16)), {}
    if name == "flash_attention_bwd_dkv":
        return (r(1, 4, 16, d), r(1, 2, 16, d), r(1, 2, 16, d), r(1, 4, 16, d),
                rows(1, 4, 16), rows(1, 4, 16)), {}
    if name == "ssd_scan":                  # x, dt, a_log, B, C; h0 given
        return (r(1, 8, 2, 16), rows(1, 8, 2), rows(2), r(1, 8, 16), r(1, 8, 16)), {
            "h0": rows(1, 2, 16, 16)}
    if name == "ssd_scan_bwd":              # x, dt, a_log, B, C, h0, dy, dh_final
        return (r(1, 8, 2, 16), rows(1, 8, 2), rows(2), r(1, 8, 16), r(1, 8, 16),
                rows(1, 2, 16, 16), rows(1, 8, 2, 16), rows(1, 2, 16, 16)), {}
    labels = _cuda_like(torch.tensor([3, 0, 63, 7]))
    if name == "fused_ce":
        return (r(4, 64), labels, rows(4)), {}
    if name == "fused_ce_bwd":
        return (r(4, 64), labels, rows(4), rows(4), rows(4)), {}
    lengths = _cuda_like(torch.tensor([5], dtype=torch.int32))
    return (r(1, 4, 32), r(1, 20, 2, 32), r(1, 20, 2, 32), lengths), {}


@pytest.fixture
def fake_kernels(monkeypatch):
    calls = []

    def function(name, argtypes):
        def call(*args):
            assert len(args) == len(argtypes)
            calls.append(name)
            return 0
        return call
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    return calls


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cuda_tensor_launches_the_kernel_never_the_plain_version(name, fake_kernels,
                                                                 monkeypatch):
    mod_name, ref_name, entry = WRAPPERS[name]
    mod = importlib.import_module(mod_name)

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(mod, ref_name, plain)
    wrapper = getattr(mod, name)
    args, kw = _args(name)
    before = wrapper.launches
    wrapper(*args, **kw)
    assert wrapper.launches == before + 1
    assert entry in fake_kernels


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cuda_tensor_of_another_dtype_raises_not_casts(name, fake_kernels):
    mod = importlib.import_module(WRAPPERS[name][0])
    args, kw = _args(name, torch.float32)
    with pytest.raises(TypeError):
        getattr(mod, name)(*args, **kw)
    assert not fake_kernels


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cpu_tensor_takes_the_plain_version_without_building(name, fake_kernels):
    mod = importlib.import_module(WRAPPERS[name][0])
    args, kw = _args(name)
    plain = [a.as_subclass(torch.Tensor) for a in args]
    before = getattr(mod, name).launches
    getattr(mod, name)(*plain, **kw)
    assert getattr(mod, name).launches == before and not fake_kernels


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_dispatch_reads_only_is_cuda_and_never_falls_back(name):
    """Structurally: the wrapper reads `fake = isinstance(<first arg>,
    FakeTensor)`; its first statement that branches and returns is `if not
    (fake or <first arg>.is_cuda): return <plain>`, the next `if fake:
    return traced(...)` (the abstract path, after the checks a CUDA tensor
    meets); no other branch returns the plain version, and there is no
    try."""
    mod = importlib.import_module(WRAPPERS[name][0])
    fn = ast.parse(inspect.getsource(getattr(mod, name))).body[0]
    first_arg = fn.args.args[0].arg
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    assigns = [ast.unparse(n) for n in fn.body if isinstance(n, ast.Assign)]
    assert f"fake = isinstance({first_arg}, FakeTensor)" in assigns
    ifs = [n for n in fn.body if isinstance(n, ast.If)]
    dispatch, fake = [n for n in ifs if isinstance(n.body[-1], ast.Return)][:2]
    assert ast.unparse(dispatch.test) == f"not (fake or {first_arg}.is_cuda)"
    assert ast.unparse(fake.test) == "fake"
    assert ast.unparse(fake.body[-1].value).startswith("traced(")
    ref = WRAPPERS[name][1]
    calls_ref = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Name) and n.func.id == ref]
    assert len(calls_ref) == 1
    assert calls_ref[0] in list(ast.walk(dispatch))
    assert "environ" not in ast.unparse(fn)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_fake_tensor_takes_the_abstract_path(name, fake_kernels, monkeypatch):
    """A fake tensor (a CPU one, as the dry run's tests trace) reaches
    neither the kernel nor the plain version: fake outputs of the shapes
    and dtypes the plain version gives, `.traced` counts the call,
    `.launches` does not, and the recorded work is positive."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from repro_torch.kernels import abstract
    mod_name, ref_name, _ = WRAPPERS[name]
    mod = importlib.import_module(mod_name)
    args, kw = _args(name)
    plain = [a.as_subclass(torch.Tensor) for a in args]
    kw = {k: v.as_subclass(torch.Tensor) for k, v in kw.items()}
    wrapper = getattr(mod, name)
    want = wrapper(*plain, **kw)
    monkeypatch.setattr(mod, ref_name, lambda *a, **k: pytest.fail(
        "a fake tensor reached the plain version"))
    before, traced = wrapper.launches, wrapper.traced
    work = []
    with FakeTensorMode() as mode, abstract.recording(lambda *w: work.append(w)):
        got = wrapper(*(mode.from_tensor(a) for a in plain),
                      **{k: mode.from_tensor(v) for k, v in kw.items()})
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) if w is None else (
            isinstance(g, FakeTensor) and g.shape == w.shape and g.dtype == w.dtype)
    assert wrapper.launches == before and wrapper.traced == traced + 1
    assert not fake_kernels
    [(wname, flops, nbytes)] = work
    assert wname == name and flops > 0 and nbytes > 0


# the autograd ops of the train path: forward and backward both reach the
# kernels on a CUDA tensor, and no plain version
OPS = {
    "rmsnorm_op": ("repro_torch.kernels.rmsnorm.ops", ("rmsnorm", "rmsnorm_bwd"),
                   ("rmsnorm_bf16", "rmsnorm_bwd_bf16")),
    "flash_attention": ("repro_torch.kernels.flash_attention.ops",
                        ("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"),
                        ("flash_attention_fwd_bf16", "flash_attention_bwd_dq_bf16",
                         "flash_attention_bwd_dkv_bf16")),
    "fused_ce_op": ("repro_torch.kernels.cross_entropy.ops", ("fused_ce", "fused_ce_bwd"),
                    ("ce_fwd_bf16", "ce_bwd_bf16")),
    "ssd_scan_op": ("repro_torch.kernels.ssd_scan.ops", ("ssd_scan", "ssd_scan_bwd"),
                    ("ssd_scan_fwd", "ssd_scan_bwd")),
}


def _op_args(name):
    g = torch.Generator().manual_seed(1)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(torch.bfloat16).requires_grad_(True)
    if name == "rmsnorm_op":
        return r(4, 64), r(64)
    if name == "flash_attention":
        return r(1, 4, 16, 32), r(1, 2, 16, 32), r(1, 2, 16, 32)
    if name == "ssd_scan_op":               # x, dt, a_log, B, C: every input differentiable
        return (r(1, 8, 2, 16), r(1, 8, 2).float().detach().requires_grad_(True),
                r(2).float().detach().requires_grad_(True), r(1, 8, 16), r(1, 8, 16))
    return r(4, 64), torch.tensor([3, 0, 63, 7]), torch.ones(4)


@pytest.mark.parametrize("name", sorted(OPS))
def test_autograd_op_runs_the_kernels_forward_and_backward(name, fake_kernels,
                                                           monkeypatch):
    """Every tensor answers is_cuda = True (autograd makes the backward's
    tensors itself, so a subclass would not reach them)."""
    mod_name, wrappers, entries = OPS[name]
    op = getattr(importlib.import_module(mod_name), name)
    for w in wrappers:                      # no wrapper may take its plain path
        wmod = importlib.import_module(WRAPPERS[w][0])
        monkeypatch.setattr(wmod, WRAPPERS[w][1], lambda *a, **k: pytest.fail(
            "a CUDA tensor reached the plain version"))
    before = {w: getattr(importlib.import_module(WRAPPERS[w][0]), w).launches
              for w in wrappers}
    args = _op_args(name)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    out = op(*args)
    out = out[0] if isinstance(out, tuple) else out     # the SSD scan's y (h_final unused)
    inputs = [a for a in args if a.requires_grad]
    grads = torch.autograd.grad(out, inputs, torch.ones_like(out))
    monkeypatch.undo()
    assert len(grads) == len(inputs)
    assert fake_kernels == list(entries)    # forward, then the backward passes in order
    for w in wrappers:
        assert getattr(importlib.import_module(WRAPPERS[w][0]), w).launches == before[w] + 1


# head dim 80: every flash pass hands its kernel the caller's tensors at D 80
_HEAD_DIM_ARG = {"flash_attention_fwd_bf16": 9, "flash_attention_bwd_dq_bf16": 13,
                 "flash_attention_bwd_dkv_bf16": 13}


@pytest.mark.parametrize("name", ["flash_attention_fwd", "flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv"])
def test_head_dim_80_is_padded_by_the_dq_pass_alone(name, monkeypatch):
    """Every flash pass hands its kernel D 80 as it is, the dq pass too
    (the name dates from when the dq pass alone padded it to 128): one
    kernel call, head dim 80, and the caller's q, not a padded copy."""
    from repro_torch.kernels.flash_attention import kernel as fk

    calls = []

    def function(entry, argtypes):
        def call(*args):
            calls.append((entry, args))
            return 0
        return call
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    args, kw = _args(name, d=80)
    getattr(importlib.import_module(_FLASH), name)(*args, **kw)
    [(entry, cargs)] = calls
    assert 80 in fk.HEAD_DIMS and cargs[_HEAD_DIM_ARG[entry]] == 80
    assert cargs[0] == args[0].data_ptr()


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def test_kernel_sources_name_the_tpu_kernel_they_replace():
    sources = {p.name: p.read_text() for p in (PKG / "kernels" / "csrc").glob("*.cu")}
    for src, body in (("rmsnorm.cu", "rmsnorm/kernel.py::_rms_kernel"),
                      ("flash_attention.cu", "flash_attention/kernel.py::_fwd_kernel"),
                      ("flash_attention_bwd.cu", "flash_attention/kernel.py::_bwd_dq_kernel"),
                      ("decode_attention.cu", "decode_attention/kernel.py::_decode_kernel"),
                      ("cross_entropy.cu", "cross_entropy/kernel.py::_ce_kernel"),
                      ("ssd_scan.cu", "ssd_scan/kernel.py::_ssd_kernel")):
        head = sources[src][:1500]
        assert f"src/repro/kernels/{body}" in head
        assert "Bound on an H100" in head and "Design" in head


def test_build_targets_sm90a_into_an_ignored_directory(monkeypatch):
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR == ROOT / "build" / "repro_torch_kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    if shutil.which("nvcc") or os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    _build.load.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


def test_importing_the_package_builds_nothing():
    code = ("import repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.kernels._build as b;"
            "print(b.load.cache_info().currsize)")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "0"


# ---------------------------------------------------------------------------
# chip_smoke.py refuses to report without a card or without the repo
# ---------------------------------------------------------------------------

def test_chip_smoke_alone_in_a_directory_fails_without_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_without_a_card_fails_without_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "no CUDA device" in res.stderr
