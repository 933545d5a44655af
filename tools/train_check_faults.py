"""Planted faults against chip_smoke.py's train_check_hybrid and kernel rows.

Each fault wraps a backward kernel's wrapper as the autograd ops call it, on
the card only (the CPU side keeps its plain versions), and the script runs
`chip_smoke.hybrid_train_check` (reduced jamba-1.5-large-398b, 192 tokens,
as chip_smoke.py runs it) with it in place; the faults of the SSD backward
are also held as chip_smoke.py's kernel phase holds that kernel (relative
L2 against fp64 autograd <= TOL_SSD_BWD_REL_L2) at jamba's P 64, N 16, and
the dk/dv fault against its plain version at TOL_BF16 at full width (64
query heads over 8 kv heads).  One JSON line a fault: what each gate reads
and whether it fails.

    python3 tools/train_check_faults.py        # on a card; writes nothing
"""
import importlib
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402

FA = importlib.import_module("repro_torch.kernels.flash_attention.ops")
FR = importlib.import_module("repro_torch.kernels.flash_attention.ref")
SS = importlib.import_module("repro_torch.kernels.ssd_scan.ops")


def dkv_half_group(real):
    """dk/dv from half of each GQA group (dO of its other query heads
    zeroed), as a cluster that drops half its partials would give them."""
    def bwd(q, k, v, out, lse, do, **kw):
        dq, dk, dv = real(q, k, v, out, lse, do, **kw)
        if q.is_cuda:
            rep = q.shape[1] // k.shape[1]
            do2 = do.clone()
            do2[:, [h for h in range(q.shape[1]) if h % rep >= rep // 2]] = 0
            _, dk, dv = real(q, k, v, out, lse, do2, **kw)
        return dq, dk, dv
    return bwd


def ssd_db_scaled(scale):
    def wrap(real):
        def bwd(*a, **kw):
            g = list(real(*a, **kw))
            if g[3].is_cuda:
                g[3] = g[3] * scale
            return tuple(g)
        return bwd
    return wrap


FAULTS = {"none": None, "dkv_half_group": (FA, "flash_attention_bwd", dkv_half_group),
          "ssd_dB_x1.02": (SS, "ssd_scan_bwd", ssd_db_scaled(1.02)),
          "ssd_dB_x1.10": (SS, "ssd_scan_bwd", ssd_db_scaled(1.10))}


def ssd_row(wrap, dev):
    """The SSD backward at jamba's P 64, N 16 ([2, 512, 256, 64], a nonzero
    h0 and dh_final) with the fault: relative L2 of dB against fp64."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_ref
    rng = np.random.default_rng(cs.SEED + 40)
    randn = cs.bf16_normal(rng, dev)
    args, h0 = cs.ssd_inputs(randn, rng, dev, 2, 512, 256, 64, 16, 0.3)
    dy = torch.from_numpy(rng.standard_normal(args[0].shape, dtype=np.float32)).to(dev)
    dhf = torch.from_numpy(rng.standard_normal(h0.shape, dtype=np.float32)).to(dev)
    got = (wrap(ssd_scan_bwd) if wrap else ssd_scan_bwd)(*args, h0, dy, dhf)
    exact = cs.ssd_grads_f64(ssd_scan_ref, args, h0, dy, dhf)
    rel = cs.rel_l2(got[3], exact[3].to(got[3].dtype))
    return {"dB_rel_l2_vs_fp64": rel, "tol": cs.TOL_SSD_BWD_REL_L2,
            "fails": rel > cs.TOL_SSD_BWD_REL_L2}


def dkv_row(wrap, dev):
    """dk/dv at full width (B 2, 64 heads over 8, S 512, D 128) with the
    fault, against the plain version at TOL_BF16."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, flash_attention_fwd
    randn = cs.bf16_normal(np.random.default_rng(cs.SEED + 41), dev)
    q, k, v, do = cs.flash_bwd_inputs(randn, 2, 512, 64, 8, 128)
    out, lse = flash_attention_fwd(q, k, v)
    _, dk, dv = (wrap(flash_attention_bwd) if wrap else flash_attention_bwd)(q, k, v, out, lse, do)
    _, rdelta = FR.attention_bwd_dq_ref(q, k, v, out, do, lse, q_offset=0)
    rk, rv = FR.attention_bwd_dkv_ref(q, k, v, do, lse, rdelta, q_offset=0)
    over = max(cs.excess(dk, rk, cs.TOL_BF16), cs.excess(dv, rv, cs.TOL_BF16))
    return {"excess_over_TOL_BF16": over, "fails": not over <= 0}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    for name, fault in FAULTS.items():
        mod, attr, wrap = fault if fault else (None, None, None)
        real = getattr(mod, attr) if mod else None
        if mod:
            setattr(mod, attr, wrap(real))
        try:
            rec = cs.hybrid_train_check(dev, cs.hybrid_small_config(), cs.SEED + 35,
                                        3 * cs.SSD_CHUNK, 3 * cs.SSD_CHUNK - 40)
        finally:
            if mod:
                setattr(mod, attr, real)
        line = {"fault": name, "train_check_hybrid": {
            "fails": not rec["ok"], "rel_err_loss": rec["rel_err_loss"],
            "rel_l2_all_grads": rec["rel_l2_all_grads"],
            "max_unit_rel_l2": max(rec["unit_rel_l2"].values()),
            "worst_leaf_rel_l2": rec["worst_leaf_rel_l2"], "tol": cs.TOL_GRAD}}
        if mod is SS or name == "none":
            line["ssd_scan_bwd_row"] = ssd_row(wrap if mod is SS else None, dev)
        if mod is FA or name == "none":
            line["flash_attention_bwd_dkv_row"] = dkv_row(wrap if mod is FA else None, dev)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
