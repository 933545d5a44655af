"""`chip_smoke.py`'s bookkeeping that needs no card: the kernel resource
report read from `ptxas -v` logs, its spill gate, and the SSD backward's
count of work.  The logs here are written by the test in ptxas's format."""
import importlib.util
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mangled(kernel, vals):
    return f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}I" + "".join(f"Li{v}E" for v in vals) + "EEvv"


def _fake_build(cs, tmp_path, spills=None):
    """A stand-in for `_build`: a log per source with one entry a kernel
    instance (spilling 8 bytes where `spills` names it), and shared-memory
    entry points that return the sum of their arguments."""
    logs = {}
    for kernel, source, _, _, (_, values) in cs.HOPPER_KERNELS:
        for vals in values:
            spill = 8 if (kernel, vals) == spills else 0
            logs.setdefault(source, []).append(
                f"ptxas info    : Compiling entry function '{_mangled(kernel, vals)}' for 'sm_90a'\n"
                f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
                f"ptxas info    : Used 128 registers, used 2 barriers\n")
    for source, entries in logs.items():
        (tmp_path / f"{source}.log").write_text("".join(entries))
    return types.SimpleNamespace(BUILD_DIR=tmp_path, INT=int,
                                 function=lambda name, argtypes: lambda *a: sum(a))


def test_hopper_kernel_report_reads_every_instance_with_its_parameters(tmp_path):
    cs = _chip_smoke()
    rows = cs.hopper_kernel_report(_fake_build(cs, tmp_path))
    walk = [r for r in rows if r["kernel"] == "ssd_bwd_walk_kernel"]
    grads = [r for r in rows if r["kernel"] == "ssd_bwd_grads_kernel"]
    assert sorted((r["P"], r["N"]) for r in walk) == sorted(
        (p, n) for p in (16, 32, 64) for n in (16, 32, 64, 128))
    assert len(grads) == 12 and all(r["threads"] == 512 for r in grads)
    # the shared memory entry point is called with the kind (0 walkers, 1
    # gradients) before P and N
    assert {r["dynamic_smem_bytes"] for r in grads if (r["P"], r["N"]) == (64, 128)} == {193}
    assert {r["dynamic_smem_bytes"] for r in walk if (r["P"], r["N"]) == (64, 128)} == {192}
    assert all(r["registers"] == 128 and r["spill_stores"] == 0 for r in rows)
    assert len([r for r in rows if r["kernel"] == "flash_fwd_kernel"]) == 4
    for r in rows:
        cs.check_no_spills(r)


@pytest.mark.parametrize("kernel,vals,fails", [
    ("ssd_bwd_grads_kernel", (64, 128), True),
    ("ssd_bwd_walk_kernel", (64, 128), True),
    ("ssd_bwd_walk_kernel", (32, 128), False),
    ("flash_bwd_dkv_kernel", (80,), True),
    ("flash_bwd_dkv_kernel", (128,), False),
])
def test_spill_gate_holds_the_instances_that_must_not_spill(tmp_path, kernel, vals, fails):
    cs = _chip_smoke()
    rows = cs.hopper_kernel_report(_fake_build(cs, tmp_path, spills=(kernel, vals)))
    spilling = [r for r in rows if r["spill_stores"]]
    assert len(spilling) == 1
    if fails:
        with pytest.raises(AssertionError, match="spills"):
            cs.check_no_spills(spilling[0])
    else:
        cs.check_no_spills(spilling[0])


def test_ssd_bwd_work_at_the_train_shape():
    """The bound's count at mamba2-130m's train shape (8 x 2048 tokens, 24
    heads, P 64, N 128), by hand: per (batch, head, chunk) the causal pairs
    T = 2080 times 2 P (dy u^T) + 3 P (att^T dy) + 2 N + 2 N (the
    E-weighted sums), and L P N = 524288 times 2 + 2 + 2 + 2 + 3; per
    (batch, chunk) C B^T, T N."""
    cs = _chip_smoke()
    nbytes, tc, f32 = cs.ssd_bwd_work(8, 2048, 24, 64, 128)
    macs = 8 * 24 * 32 * (2080 * (128 + 192 + 256 + 256) + 524288 * 11) + 8 * 32 * 2080 * 128
    assert tc == 2 * macs
    assert nbytes == 8 * 2048 * 24 * 64 * 8 + 4 * 8 * 2048 * 128 * 2 + 2 * 8 * 2048 * 24 * 4 + 2 * 24 * 4
    assert f32 == 2 * (8 * 24 * 32 * (2080 * (128 + 256) + 5 * 524288) + 8 * 32 * 2080 * 128)
