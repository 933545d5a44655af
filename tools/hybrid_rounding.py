"""Where reduced jamba-1.5-large-398b's bf16 gradients part from its fp32
ones, and how far a last-bit change moves them (CPU, plain versions).

chip_smoke.py's train_check_hybrid compares the card with the CPU unit by
unit because the whole model's bf16 gradients are not fixed to TOL_GRAD by
their rounding; this script shows why, on `chip_smoke.hybrid_small_config`
(one period block, d 128, 192 tokens, train_check_hybrid's seed), each
MoE layer's selection pinned to the bf16 run's.  One JSON line a part:

* "residual": bf16 against fp32 params along the residual stream, at each
  layer's mixer output and block output: the relative L2 difference of
  the activation and of the loss's gradient there;
* "mamba_layer": the last Mamba layer alone on the fp32 run's input and
  output gradient: its bf16 rounding ("bf16_exact_input"), and the fp32
  layer fed the bf16 run's input instead ("fp32_bf16_input": how much a
  Mamba layer amplifies a difference of its input), each the relative L2
  difference of its output and of its input's gradient;
* "last_bit": the relative L2 change of all bf16 gradients when one step
  of the computation changes in its last bits: 1e-6 relative noise on
  the SSD scan's fp32 output; the plain scan at the kernels' 64-row
  chunks; attention's probabilities rounded to bf16 before P V.

    PYTHONPATH=src python tools/hybrid_rounding.py       # ~20 s, CPU only
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
from repro_torch.models import init_model, layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

SK = importlib.import_module("repro_torch.kernels.ssd_scan.kernel")
FO = importlib.import_module("repro_torch.kernels.flash_attention.ops")
FR = importlib.import_module("repro_torch.kernels.flash_attention.ref")


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def run(params, batch, cfg, pin):
    """The loss's gradients and, at each layer's mixer output and output,
    the activation and its gradient; each MoE layer's selection pinned."""
    params = tree_map(lambda t: t.detach().clone(), params)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    points, real_mixer = {}, (T.S.ssm_fwd, T.L.attention_fwd)

    def keep(fn):
        def f(*a, **kw):
            y, extra = fn(*a, **kw)
            y.retain_grad()
            points[f"{len(points) // 2}.mixer"] = y
            return y, extra
        return f
    T.S.ssm_fwd, T.L.attention_fwd = keep(real_mixer[0]), keep(real_mixer[1])
    real_layer = T._apply_hybrid_layer

    def layer(*a, **kw):
        h, aux, st = real_layer(*a, **kw)
        h.retain_grad()
        points[f"{len(points) // 2}.out"] = h
        return h, aux, st
    T._apply_hybrid_layer = layer
    try:
        with cs.RouteRecorder(layers) as rec:
            rec.pin = pin
            loss, _ = T.loss_fn(params, batch, cfg)
            calls = rec.take()
        loss.backward()
    finally:
        T.S.ssm_fwd, T.L.attention_fwd = real_mixer
        T._apply_hybrid_layer = real_layer
    return ([t.grad.float() for t in leaves], [c["idx"] for c in calls],
            {k: (v.detach().float(), v.grad.float()) for k, v in points.items()})


def mamba_layer(p, x, dy, cfg):
    """One Mamba layer's output and its input's gradient."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    x = x.detach().clone().requires_grad_(True)
    y, _ = T.S.ssm_fwd(p, x, cfg)
    y.backward(dy.to(y.dtype))
    return y.detach().float(), x.grad.float()


def main() -> int:
    from dataclasses import replace
    cfg = replace(cs.hybrid_small_config(), remat="none")
    seed, seq = cs.SEED + 35, 3 * cs.SSD_CHUNK
    params = init_model(cfg, torch.Generator().manual_seed(seed), "cpu")
    toks = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (2, seq + 1))
    mask = np.ones((2, seq), np.float32)
    mask[1, seq - 40:] = 0.0
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:]),
             "loss_mask": torch.from_numpy(mask)}
    f32 = tree_map(lambda t: t.detach().float(), params)
    g_bf, pin, pts_bf = run(params, batch, cfg, None)
    g_32, _, pts_32 = run(f32, batch, cfg, pin)
    print(json.dumps({"part": "residual", "all_grads_bf16_vs_fp32":
                      rel(torch.cat([g.flatten() for g in g_bf]),
                          torch.cat([g.flatten() for g in g_32])),
                      "points": {k: {"activation": rel(pts_bf[k][0], pts_32[k][0]),
                                     "gradient": rel(pts_bf[k][1], pts_32[k][1])}
                                 for k in pts_32}}))
    last = max(i for i in range(cfg.hybrid.period) if i != cfg.hybrid.attn_index)
    p = params["blocks"][0]["layers"][last]["mixer"]
    x32 = T.L.apply_norm(tree_map(lambda t: t.float(),
                                  params["blocks"][0]["layers"][last]["mixer_norm"]),
                         pts_32[f"{last - 1}.out"][0])
    xbf = T.L.apply_norm(params["blocks"][0]["layers"][last]["mixer_norm"],
                         pts_bf[f"{last - 1}.out"][0].bfloat16())
    dy = pts_32[f"{last}.mixer"][1]
    ref = mamba_layer(tree_map(lambda t: t.float(), p), x32.bfloat16().float(), dy, cfg)
    out = {"input_bf16_vs_fp32": rel(xbf, x32)}
    for name, (pp, xx) in {"bf16_exact_input": (p, x32.bfloat16()),
                           "fp32_bf16_input": (tree_map(lambda t: t.float(), p),
                                               xbf.float())}.items():
        y, gx = mamba_layer(pp, xx, dy, cfg)
        out[name] = {"output": rel(y, ref[0]), "input_gradient": rel(gx, ref[1])}
    print(json.dumps({"part": "mamba_layer", "layer": last, **out}))

    def noisy_scan(*a, chunk=256, **kw):
        y, h = real_scan(*a, chunk=chunk, **kw)
        g = torch.Generator().manual_seed(int(y.shape.numel()))
        return y * (1 + 1e-6 * torch.randn(y.shape, generator=g)), h

    def chunk64(fn):
        return lambda *a, chunk=256, **kw: fn(*a, chunk=cs.SSD_CHUNK, **kw)

    def p_bf16(q, k, v, scale=None, causal=True):
        b, h, s, _ = q.shape
        sc = FR._masked_scores(q, k, scale, causal, None, None)
        m = sc.amax(-1, keepdim=True)
        e = torch.exp(sc - m)
        lsum = e.sum(-1, keepdim=True)
        o = torch.einsum("bgrst,bgtd->bgrsd", e.bfloat16().float(), v.float()) / lsum
        return (o.reshape(b, h, s, -1).to(q.dtype),
                (m + torch.log(lsum)).squeeze(-1).reshape(b, h, s))
    real_scan, real_bwd, real_fwd = SK.ssd_scan_ref, SK.ssd_scan_bwd_ref, FO.flash_attention_fwd
    changes = {"ssd_scan_output_1e-6_noise": [(SK, "ssd_scan_ref", noisy_scan)],
               "ssd_scan_at_64_row_chunks": [(SK, "ssd_scan_ref", chunk64(real_scan)),
                                             (SK, "ssd_scan_bwd_ref", chunk64(real_bwd))],
               "attention_P_rounded_to_bf16": [(FO, "flash_attention_fwd", p_bf16)]}
    moved = {}
    for name, patches in changes.items():
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
        try:
            g, _, _ = run(params, batch, cfg, pin)
        finally:
            SK.ssd_scan_ref, SK.ssd_scan_bwd_ref, FO.flash_attention_fwd = (
                real_scan, real_bwd, real_fwd)
        moved[name] = rel(torch.cat([x.flatten() for x in g]),
                          torch.cat([x.flatten() for x in g_bf]))
    print(json.dumps({"part": "last_bit", "all_grads_moved": moved}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
