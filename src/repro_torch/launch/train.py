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
Batches come from a corpus of small sample files read through BuffetFS,
as the JAX Trainer reads them (`data.BuffetDataset`: one file a sample,
shard directories warmed once, then `data.DataPipeline`'s prefetch thread
and hedged reads), over the storage client the caller passes as `lib` (a
`repro.core.BLib`), or else over `data.DirLib` on `tc.data_dir` (a temp
dir when none is given).  The corpus found there is reused; else the given
one, or one synthesised as the JAX Trainer does, is written.  Every
`ckpt_every` steps and at the last step the state is saved to
`/ckpt/<run_name>` through `ckpt.CheckpointManager` (async, atomic,
crc-checked, in the JAX package's layout), and `init_or_restore` resumes
from the latest one when `tc.resume` is set.  A caller that passes
`batches=` (any iterable of numpy batch dicts in the format `DataPipeline`
yields: tokens, labels, loss_mask) gets no dataset and no checkpoint.
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
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --full \\
        --steps 12 --batch 8 --seq 2048 --data-dir runs/m2 --run m2
    # the same with --steps 16 resumes at step 12, from runs/m2's checkpoint
"""
from __future__ import annotations

import argparse
import math
import shutil
import statistics
import tempfile
import time
import weakref
from dataclasses import dataclass, replace
from typing import Any, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..ckpt import CheckpointManager
from ..configs import get_config
from ..data import BuffetDataset, DataPipeline, DirLib, ShardedSampler
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
    ckpt_every: int = 20
    log_every: int = 10
    run_name: str = "run0"
    hedge_delay_s: Optional[float] = None
    resume: bool = True
    data_dir: Optional[str] = None      # DirLib's directory when no lib is given
    device: str = "cuda"
    seed: int = 0                       # random weights
    moment_dtype: torch.dtype = torch.float32
    n_layers: Optional[int] = None      # keep the config's first n layers
    #                                     (hybrid: n_layers // period blocks)


class Trainer:
    def __init__(self, tc: TrainerConfig, *, lib: Any = None,
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
        self.lib = self.dataset = self.sampler = self.pipeline = self.ckpt = None
        self._rm_root = None
        if batches is None:
            self._setup_storage(lib, corpus)
            self.batches = self._pipeline_batches()
        else:
            self.batches = iter(batches)
        self.step_fn = make_train_step_fn(self.cfg, self.opt_cfg)
        self.state: Optional[Dict[str, Any]] = None
        self.start_step = 0

    def _setup_storage(self, lib: Any, corpus: Optional[list]) -> None:
        """The corpus, sampler, pipeline and checkpoints over `lib`, as the
        JAX Trainer sets them up over its cluster."""
        tc = self.tc
        if lib is None:
            root = tc.data_dir
            if root is None:   # nothing could resume from it: removed with the Trainer
                root = tempfile.mkdtemp(prefix="buffetfs_train_")
                self._rm_root = weakref.finalize(self, shutil.rmtree, root, True)
            lib = DirLib(root)
        self.lib = lib
        if corpus is None:   # synthesise one, as the JAX Trainer does
            rng = np.random.default_rng(0)
            n = max(tc.global_batch * 16, 128)
            corpus = [rng.integers(1, self.cfg.vocab_size,
                                   size=tc.seq_len + 1).astype(np.uint32)
                      for _ in range(n)]
        try:
            self.dataset = BuffetDataset(self.lib, name="train")
            _ = self.dataset.spec  # existing corpus?
        except OSError:
            self.dataset = BuffetDataset.build(
                self.lib, corpus, name="train",
                replicate=tc.hedge_delay_s is not None)
        self.sampler = ShardedSampler(n_samples=len(self.dataset),
                                      global_batch=tc.global_batch,
                                      dp_rank=0, dp_size=1)
        self.pipeline = DataPipeline(self.dataset, self.sampler,
                                     seq_len=tc.seq_len,
                                     hedge_delay_s=tc.hedge_delay_s)
        self.ckpt = CheckpointManager(self.lib, tc.run_name, parts=4,
                                      keep_last=2)

    def _pipeline_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        # a generator: the pipeline's thread starts at the first batch, after
        # init_or_restore has set the sampler
        yield from self.pipeline

    def init_state(self, params: Any = None) -> None:
        """Random weights from `tc.seed` on the device, or the given params."""
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        self.state = make_train_state(self.cfg, self.opt_cfg, gen, self.device,
                                      params=params)

    def init_or_restore(self, params: Any = None) -> None:
        """`init_state`, then, with `tc.resume` and a committed checkpoint,
        the state, the train step and the sampler's position from the
        latest one."""
        self.init_state(params)
        if self.ckpt is None or not self.tc.resume:
            return
        try:
            step, restored = self.ckpt.restore(like=self.state)
        except (FileNotFoundError, KeyError):
            print("[trainer] fresh start")
            return
        man = self.ckpt.manifest(step)
        self.state = restored
        self.start_step = int(man.extra["train_step"])
        # The sampler resumes at the train step, before the pipeline's thread
        # starts (it does at the first batch).  Only the seed is read from
        # the saved sampler state: JAX's Trainer saves the sampler's own
        # step, which its producer thread has run ahead of training (by up
        # to prefetch + 1 batches, by timing), so a JAX resume would skip
        # batches that were read and never trained on.
        self.sampler.load_state_dict({"step": self.start_step,
                                      "seed": man.extra["sampler"]["seed"]})
        print(f"[trainer] resumed from step {self.start_step}")

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        dtypes = {"tokens": torch.long, "labels": torch.long,
                  "loss_mask": torch.float32}
        return {k: torch.as_tensor(np.asarray(batch[k]), dtype=dt).to(self.device)
                for k, dt in dtypes.items() if k in batch}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, until: Optional[int] = None) -> Dict[str, Any]:
        """Steps `start_step` .. `until` (default `tc.steps`; an earlier
        `until` stops the run there, as a preemption would, with the
        schedule of the whole run and a checkpoint at the stop).  Returns
        final_loss and steps (as the JAX Trainer; with a storage client
        that counts RPCs, also its critical_rpcs and async_rpcs), plus the
        loss and the wall time of every step run (step_times_s, each ending
        in a sync), step_s (their median after the first), tokens_per_s,
        with checkpoints the seconds the last save's writes kept the run
        waiting at its end (ckpt_wait_s), and with an MTP head the `mtp_ce`
        of every step (mtp_ces)."""
        if self.state is None:
            self.init_or_restore()
        tc = self.tc
        stop = tc.steps if until is None else until
        losses, times, mtp_ces = [], [], []
        for step in range(self.start_step, stop):
            batch = self._to_device(next(self.batches))
            self._sync()
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            losses.append(float(metrics["loss"]))          # waits for the step
            times.append(time.perf_counter() - t0)
            if "mtp_ce" in metrics:
                mtp_ces.append(float(metrics["mtp_ce"]))
            if (step + 1) % tc.log_every == 0 or step == stop - 1:
                print(f"[trainer] step {step+1}/{tc.steps} loss={losses[-1]:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"({sum(times):.1f}s)")
            if self.ckpt is not None and ((step + 1) % tc.ckpt_every == 0
                                          or step == stop - 1):
                # async save: the copy to the host blocks (AdamW updates the
                # state in place), the file writes run beside the next steps.
                # The sampler's position saved is the next batch training
                # takes, not the producer thread's (which runs ahead).
                self.ckpt.save(step + 1, self.state, block=False, extra={
                    "train_step": step + 1,
                    "sampler": {"step": step + 1, "seed": self.sampler.seed},
                    "arch": self.cfg.name,
                })
        wait_s = None
        if self.pipeline is not None:
            t0 = time.perf_counter()
            self.ckpt.wait()
            wait_s = time.perf_counter() - t0
            self.pipeline.stop()
        step_s = statistics.median(times[1:] or times) if times else math.nan
        tokens = tc.global_batch * tc.seq_len
        out = {"final_loss": losses[-1] if losses else math.nan, "steps": tc.steps,
               "losses": losses, "step_s": step_s, "step_times_s": times,
               "tokens_per_s": tokens / step_s}
        if wait_s is not None:
            out["ckpt_wait_s"] = wait_s
        if self.lib is not None and self.lib.agent.stats is not None:
            rpc = self.lib.agent.stats.snapshot()
            out["critical_rpcs"] = rpc["critical_path"]
            out["async_rpcs"] = rpc["async_offpath"]
        if mtp_ces:
            out["mtp_ces"] = mtp_ces
        return out

    def shutdown(self) -> None:
        """Stops the pipeline and waits for a save in flight; a temp dir the
        Trainer made itself is removed.  The caller owns a `lib` it passed."""
        if self.pipeline is not None:
            self.ckpt.wait()
            self.pipeline.stop()
        if self._rm_root is not None:
            self._rm_root()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--run", default="run0")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--moment-dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--n-layers", type=int, default=None)
    args = ap.parse_args(argv)
    tc = TrainerConfig(arch=args.arch, steps=args.steps, global_batch=args.batch,
                       seq_len=args.seq, lr=args.lr, reduced=args.reduced,
                       data_dir=args.data_dir, run_name=args.run,
                       device=args.device, seed=args.seed,
                       moment_dtype=getattr(torch, args.moment_dtype),
                       n_layers=args.n_layers)
    tr = Trainer(tc)
    try:
        out = tr.run()
    finally:
        tr.shutdown()
    print(f"[trainer] done: final_loss={out['final_loss']:.4f} steps={out['steps']} "
          f"step_s={out['step_s']:.3f} tokens_per_s={out['tokens_per_s']:.1f}")


if __name__ == "__main__":
    main()
