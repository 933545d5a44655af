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
`core.BLib`, or `data.DirLib` on a local directory), or else, as the JAX
Trainer does, over the port's own BuffetFS: a `core.BuffetCluster` of
`tc.n_servers` in-process servers backed by `tc.data_dir` (a temp dir when
none is given), a `core.BAgent` and a `core.BLib` over it, shut down with
the Trainer.  A new Trainer over the same `data_dir` restarts the servers
from what they persisted and resumes.  The corpus found there is reused;
else the given one, or one synthesised as the JAX Trainer does, is
written.  Every `ckpt_every` steps and at the last step the state is
saved to `/ckpt/<run_name>` through `ckpt.CheckpointManager` (async,
atomic, crc-checked, in the JAX package's layout), and `init_or_restore`
resumes from the latest one when `tc.resume` is set.  A caller that passes
`batches=` (any iterable of numpy batch dicts in the format `DataPipeline`
yields: tokens, labels, loss_mask) gets no dataset and no checkpoint.
Runs on `cuda` unless the config says `device="cpu"`.

The train step is compiled as JAX's Trainer jits `train_step` with the
state donated: on a CUDA device, with a state of plain tensors, the first
step runs eagerly on a side stream (the warm-up: the kernels build, cuBLAS
initialises, the RMSNorm backward's grid barrier is made for that stream),
then one whole step (the loss's forward, autograd's backward through the
hand-written backward kernels, AdamW) is captured there as a
`torch.cuda.CUDAGraph`, and every later step copies its batch into the
graph's static buffers and replays it.  AdamW advances every state leaf in
place, so the graph replays onto the state's own tensors; a state whose
leaves are not the captured ones (`init_or_restore`, or a caller setting
`state`), or a batch of another shape, is captured anew.  On the CPU, and
with DTensor leaves (a sharded state), the same step runs eagerly; the
choice follows the device and the leaves' type, with no switch and no
fallback: a capture or replay that fails raises.

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
from typing import Any, Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .. import core
from ..ckpt import CheckpointManager
from ..configs import get_config
from ..data import BuffetDataset, DataPipeline, ShardedSampler
from ..kernels import add_launches, launches
from ..optim import AdamWConfig
from ..runtime.steps import make_train_state, make_train_step_fn
from ..tree import tree_leaves
from .serve import resolve_device

BATCH_DTYPES = {"tokens": torch.long, "labels": torch.long, "loss_mask": torch.float32}


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
    n_servers: int = 4
    hedge_delay_s: Optional[float] = None
    resume: bool = True
    data_dir: Optional[str] = None      # the BuffetFS cluster's backing directory
    device: str = "cuda"
    seed: int = 0                       # random weights
    moment_dtype: torch.dtype = torch.float32
    n_layers: Optional[int] = None      # keep the config's first n layers
    #                                     (hybrid: n_layers // period blocks)


class _TrainGraph:
    """The train step's CUDA graph and what it replays on, kept across steps
    and runs as JAX's jit keeps a step's executable: the state's leaves it
    was captured on (weak references: the graph keeps no state alive), the
    static batch each step is copied into, the stream it was warmed up and
    captured on, and once captured the graph, its static metrics (rewritten
    by every replay) and one replay's kernel launches."""

    def __init__(self, state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                 device: torch.device) -> None:
        self.leaves = [weakref.ref(t) for t in tree_leaves(state)]
        self.batch = {k: torch.empty_like(v, device=device) for k, v in batch.items()}
        self.stream = torch.cuda.Stream(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.metrics: Dict[str, torch.Tensor] = {}
        self.launches: Dict[str, int] = {}

    def takes(self, state: Dict[str, Any], batch: Dict[str, torch.Tensor]) -> bool:
        """Whether a step on `state` and `batch` (host tensors) replays on
        what was captured: the same leaf tensors, a batch of the same keys,
        shapes and dtypes."""
        leaves = tree_leaves(state)
        return (len(leaves) == len(self.leaves)
                and all(r() is t for r, t in zip(self.leaves, leaves))
                and batch.keys() == self.batch.keys()
                and all(v.shape == self.batch[k].shape and v.dtype == self.batch[k].dtype
                        for k, v in batch.items()))


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
        self.cluster = self.agent = None
        self._close_storage = None
        if batches is None:
            self._setup_storage(lib, corpus)
            self.batches = self._pipeline_batches()
        else:
            self.batches = iter(batches)
        self.step_fn = make_train_step_fn(self.cfg, self.opt_cfg)
        self.state: Optional[Dict[str, Any]] = None
        self.start_step = 0
        self._graph: Optional[_TrainGraph] = None

    def _setup_storage(self, lib: Any, corpus: Optional[list]) -> None:
        """The corpus, sampler, pipeline and checkpoints over `lib`, as the
        JAX Trainer sets them up over its cluster."""
        tc = self.tc
        if lib is None:
            lib = self._start_buffetfs()
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

    def _start_buffetfs(self) -> Any:
        """The port's BuffetFS over `tc.data_dir`, as the JAX Trainer builds
        it: a cluster of `tc.n_servers` servers, an agent and a BLib.  A
        cluster that cannot start raises.  The agent, the cluster and a temp
        dir made here go with the Trainer (`shutdown`, or when it is
        collected)."""
        root = self.tc.data_dir
        made = root is None     # nothing could resume from it: removed with the Trainer
        if made:
            root = tempfile.mkdtemp(prefix="buffetfs_train_")
        cluster = agent = None
        try:
            cluster = core.BuffetCluster(root_dir=root, n_servers=self.tc.n_servers)
            agent = core.BAgent(cluster)
        except BaseException:
            _close_storage(agent, cluster, root if made else None)
            raise
        self.cluster, self.agent = cluster, agent
        self._close_storage = weakref.finalize(self, _close_storage, agent, cluster,
                                               root if made else None)
        return core.BLib(agent)

    def _pipeline_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        # a generator: the pipeline's thread starts at the first batch, after
        # init_or_restore has set the sampler
        yield from self.pipeline

    def init_state(self, params: Any = None) -> None:
        """Random weights from `tc.seed` on the device, or the given params."""
        self._graph = None          # its pool goes before a new state is made
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

    @staticmethod
    def _host_batch(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(batch[k]), dtype=dt)
                for k, dt in BATCH_DTYPES.items() if k in batch}

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device) for k, v in self._host_batch(batch).items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _graphed(self) -> bool:
        """Whether steps run through the train graph: on a CUDA device with
        a state of plain tensors (DTensor leaves run eagerly)."""
        return self.device.type == "cuda" and not any(
            isinstance(t, DTensor) for t in tree_leaves(self.state))

    def train_graph(self) -> Optional[torch.cuda.CUDAGraph]:
        """The train step's CUDA graph, once captured.  It keeps its nodes
        (`keep_graph`): `debug_dump(path)` writes them."""
        return None if self._graph is None else self._graph.graph

    def _stage(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The graph's static batch with `batch` copied in from the host (a
        new `_TrainGraph`, to be captured, where the state's leaves or the
        batch's shapes are not the captured ones)."""
        host = self._host_batch(batch)
        if self._graph is None or not self._graph.takes(self.state, host):
            self._graph = None
            self._graph = _TrainGraph(self.state, host, self.device)
        for k, v in host.items():
            self._graph.batch[k].copy_(v)
        return self._graph.batch

    def _train_once(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One train step on `batch`, the same ops eagerly and in a graph:
        AdamW writes the state's leaves in place.  Returns the metrics."""
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics

    def _warm_up_and_capture(self, g: _TrainGraph) -> Tuple[Dict[str, torch.Tensor], float]:
        """The first step on g's state and batch, then its graph.  The step
        runs eagerly on g's stream (the warm-up: the kernels build, cuBLAS
        initialises, the RMSNorm backward's grid barrier is made for that
        stream, outside the graph's pool) and is this run's step; the
        warm-up's cached blocks are released before the graph's private pool
        takes its own; the capture runs nothing.  The wrappers counted the
        captured calls, which ran no kernel: those counts are taken back out
        and kept as one replay's.  Returns the step's metrics and the
        capture's seconds."""
        stream = g.stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            metrics = self._train_once(g.batch)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self._sync()
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = launches()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=stream):
            g.metrics = self._train_once(g.batch)
        graph.instantiate()             # a kept graph is instantiated on request
        capture_s = time.perf_counter() - t0
        g.launches = {k: v - before[k] for k, v in launches().items() if v != before[k]}
        add_launches(g.launches, -1)
        if not g.takes(self.state, g.batch):
            raise RuntimeError("the captured train step replaced a state leaf: its graph "
                               "would replay onto stale tensors")
        g.graph = graph
        return metrics, capture_s

    def _step(self, batch: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], float]:
        """One step: a replay of the train graph, its warm-up and capture, or
        the eager step.  Returns the metrics and the seconds spent capturing."""
        g = self._graph if self._graphed() else None
        if g is None:
            return self._train_once(batch), 0.0
        if g.graph is None:
            return self._warm_up_and_capture(g)
        g.graph.replay()
        add_launches(g.launches)
        return g.metrics, 0.0

    def run(self, until: Optional[int] = None) -> Dict[str, Any]:
        """Steps `start_step` .. `until` (default `tc.steps`; an earlier
        `until` stops the run there, as a preemption would, with the
        schedule of the whole run and a checkpoint at the stop).  Returns
        final_loss and steps (as the JAX Trainer; with a storage client
        that counts RPCs, also its critical_rpcs and async_rpcs), plus the
        loss and the wall time of every step run (step_times_s, each ending
        in a sync, a capture's seconds left out), step_s (their median after
        the first), tokens_per_s, capture_s (the seconds this run spent
        capturing the train graph: 0 where one was replayed, and on the CPU),
        with checkpoints the seconds the last save's writes kept the run
        waiting at its end (ckpt_wait_s), and with an MTP head the `mtp_ce`
        of every step (mtp_ces)."""
        if self.state is None:
            self.init_or_restore()
        tc = self.tc
        stop = tc.steps if until is None else until
        losses, times, mtp_ces = [], [], []
        capture_s = 0.0
        for step in range(self.start_step, stop):
            raw = next(self.batches)
            batch = self._stage(raw) if self._graphed() else self._to_device(raw)
            self._sync()
            t0 = time.perf_counter()
            metrics, cap = self._step(batch)
            losses.append(float(metrics["loss"]))          # waits for the step
            times.append(time.perf_counter() - t0 - cap)
            capture_s += cap
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
               "tokens_per_s": tokens / step_s, "capture_s": capture_s}
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
        """Stops the pipeline and waits for a save in flight; then shuts down
        the agent and the cluster the Trainer built, as the JAX Trainer does,
        and removes a temp dir it made.  The caller owns a `lib` it passed."""
        if self.pipeline is not None:
            self.ckpt.wait()
            self.pipeline.stop()
        if self._close_storage is not None:
            self._close_storage()


def _close_storage(agent: Any, cluster: Any, rm_root: Optional[str]) -> None:
    """Shuts down a Trainer's own BuffetFS (the agent drains its async
    closes first) and removes its temp dir."""
    if agent is not None:
        agent.shutdown()
    if cluster is not None:
        cluster.shutdown()
    if rm_root is not None:
        shutil.rmtree(rm_root, ignore_errors=True)


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
          f"step_s={out['step_s']:.3f} tokens_per_s={out['tokens_per_s']:.1f} "
          f"critical_rpcs={out['critical_rpcs']} async_rpcs={out['async_rpcs']}")


if __name__ == "__main__":
    main()
