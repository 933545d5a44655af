"""Training driver of the port: the device path of `repro/launch/train.py`.

`Trainer.run` takes a batch, runs `runtime/steps.py::train_step` (the
model's loss through the kernels, autograd back through their backward
kernels, AdamW) and logs, for `steps` steps.  It is the same for every
family `loss_fn` trains: the dense decoders, the Mamba2 (ssm) stack, the
MoE family (deepseek-v2-lite-16b, and deepseek-v3-671b with its MTP head,
whose loss the step's metrics carry as `mtp_ce`) and the hybrid family
(jamba-1.5-large-398b).  The stub-frontend families (pixtral-12b,
musicgen-large) train on tokens alone, through the token table (plus
musicgen-large's sinusoidal positions), as the JAX Trainer feeds them.
`n_layers` cuts the depth (the first layers of the
config, the dense prefix first, every width kept; the MTP head stays): a
model whose train state does not fit one card trains a few of its layers
(deepseek-v3-671b: its 3 dense layers).  A hybrid model is cut as JAX's
`init_model` reads its depth, into n_layers // period period blocks, so
`n_layers` must be a multiple of the period (jamba: 8, one block).
Batches come from any iterable of numpy batch dicts in the format
`repro.data.DataPipeline` yields (tokens, labels, loss_mask), or else from
an in-memory corpus (synthesised as the JAX Trainer does when none is
given) through the port's sampler and `pack_batch`.  Reading the corpus
from BuffetFS and checkpointing to it wait for a later slice (ROADMAP.md).
Runs on `cuda` unless the config says `device="cpu"`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
        --steps 20 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --full \\
        --steps 8 --batch 8 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v2-lite-16b \\
        --full --n-layers 6 --steps 8 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v3-671b \\
        --full --n-layers 3 --steps 8 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-large \\
        --full --steps 8 --batch 8 --seq 512
"""
from __future__ import annotations

import argparse
import statistics
import time
from dataclasses import dataclass, replace
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..configs import get_config
from ..data import ShardedSampler, corpus_batches
from ..optim import AdamWConfig
from ..runtime.steps import make_train_state, make_train_step_fn
from .serve import resolve_device


@dataclass
class TrainerConfig:
    arch: str = "stablelm-3b"
    reduced: bool = True
    steps: int = 50
    global_batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    log_every: int = 10
    device: str = "cuda"
    seed: int = 0                       # random weights
    moment_dtype: torch.dtype = torch.float32
    n_layers: Optional[int] = None      # keep the config's first n layers
    #                                     (hybrid: n_layers // period blocks)


class Trainer:
    def __init__(self, tc: TrainerConfig, *,
                 batches: Optional[Iterable[Dict[str, np.ndarray]]] = None,
                 corpus: Optional[list] = None) -> None:
        self.tc = tc
        self.device = resolve_device(tc.device)
        cfg = get_config(tc.arch)
        cfg = cfg.reduced() if tc.reduced else cfg
        if tc.n_layers is not None:
            if not 1 <= tc.n_layers <= cfg.n_layers:
                raise ValueError(f"n_layers must be in 1..{cfg.n_layers}, got {tc.n_layers}")
            if cfg.hybrid is not None and tc.n_layers % cfg.hybrid.period:
                raise ValueError(f"n_layers must be a multiple of the hybrid period "
                                 f"{cfg.hybrid.period}, got {tc.n_layers}")
            cfg = replace(cfg, n_layers=tc.n_layers)
        self.cfg = cfg
        self.opt_cfg = AdamWConfig(lr=tc.lr, total_steps=tc.steps,
                                   warmup_steps=max(1, tc.steps // 20),
                                   moment_dtype=tc.moment_dtype)
        if batches is None:
            if corpus is None:   # synthesise one, as the JAX Trainer does
                rng = np.random.default_rng(0)
                n = max(tc.global_batch * 16, 128)
                corpus = [rng.integers(1, self.cfg.vocab_size,
                                       size=tc.seq_len + 1).astype(np.uint32)
                          for _ in range(n)]
            self.sampler = ShardedSampler(n_samples=len(corpus),
                                          global_batch=tc.global_batch,
                                          dp_rank=0, dp_size=1)
            batches = corpus_batches(corpus, self.sampler, tc.seq_len)
        self.batches = iter(batches)
        self.step_fn = make_train_step_fn(self.cfg, self.opt_cfg)
        self.state: Optional[Dict[str, Any]] = None

    def init_state(self, params: Any = None) -> None:
        """Random weights from `tc.seed` on the device, or the given params."""
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        self.state = make_train_state(self.cfg, self.opt_cfg, gen, self.device,
                                      params=params)

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        dtypes = {"tokens": torch.long, "labels": torch.long,
                  "loss_mask": torch.float32}
        return {k: torch.as_tensor(np.asarray(batch[k]), dtype=dt).to(self.device)
                for k, dt in dtypes.items() if k in batch}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> Dict[str, Any]:
        """Returns final_loss and steps (as the JAX Trainer), plus the loss of
        every step, step_s (median wall time of the steps after the first,
        each ending in a sync), tokens_per_s, and with an MTP head the
        `mtp_ce` of every step (mtp_ces)."""
        if self.state is None:
            self.init_state()
        tc = self.tc
        losses, times, mtp_ces = [], [], []
        for step in range(tc.steps):
            batch = self._to_device(next(self.batches))
            self._sync()
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            losses.append(float(metrics["loss"]))          # waits for the step
            times.append(time.perf_counter() - t0)
            if "mtp_ce" in metrics:
                mtp_ces.append(float(metrics["mtp_ce"]))
            if (step + 1) % tc.log_every == 0 or step == tc.steps - 1:
                print(f"[trainer] step {step+1}/{tc.steps} loss={losses[-1]:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"({sum(times):.1f}s)")
        step_s = statistics.median(times[1:] or times)
        tokens = tc.global_batch * tc.seq_len
        out = {"final_loss": losses[-1], "steps": tc.steps, "losses": losses,
               "step_s": step_s, "tokens_per_s": tokens / step_s}
        if mtp_ces:
            out["mtp_ces"] = mtp_ces
        return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--moment-dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--n-layers", type=int, default=None)
    args = ap.parse_args(argv)
    tc = TrainerConfig(arch=args.arch, steps=args.steps, global_batch=args.batch,
                       seq_len=args.seq, lr=args.lr, reduced=args.reduced,
                       device=args.device, seed=args.seed,
                       moment_dtype=getattr(torch, args.moment_dtype),
                       n_layers=args.n_layers)
    out = Trainer(tc).run()
    print(f"[trainer] done: final_loss={out['final_loss']:.4f} steps={out['steps']} "
          f"step_s={out['step_s']:.3f} tokens_per_s={out['tokens_per_s']:.1f}")


if __name__ == "__main__":
    main()
