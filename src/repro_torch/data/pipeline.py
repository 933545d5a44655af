"""DataPipeline — background-prefetched, straggler-tolerant input pipeline
over a `BuffetDataset`: the port's copy of `repro/data/pipeline.py`; and
`corpus_batches`, the same batches from an in-memory corpus.

* **Metadata off the hot path** — `warm_dirs()` caches every shard directory
  once; after that an epoch of N sample reads costs exactly N critical-path
  RPCs (the paper's headline property), not 2-3N.
* **Prefetch** — batch k+1 is fetched while step k computes: the training
  step never waits for I/O in steady state.  The producer thread advances
  the sampler ahead of training, by up to `prefetch` + 1 batches, so the
  sampler's own state is not the train position (see `launch/train.py`).
* **Hedged reads** — if a sample read exceeds `hedge_delay_s` (a straggling
  or dead BServer), the same sample is requested from its replica directory
  and the first response wins; a primary that fails fast (server down)
  sends the read to the replica at once.

A batch is a dict of numpy arrays, `tokens` [B, S] int32, `labels` [B, S]
int32 (tokens shifted by one) and `loss_mask` [B, S] fp32.
"""
from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from .dataset import BuffetDataset
from .sampler import ShardedSampler
from .tokens import pack_batch


def _batch_dict(samples: list, seq_len: int, pad_id: int) -> Dict[str, np.ndarray]:
    tokens, mask = pack_batch(samples, seq_len + 1, pad_id)
    return {"tokens": tokens[:, :-1],
            "labels": tokens[:, 1:].astype(np.int32),
            "loss_mask": mask[:, 1:]}


def corpus_batches(corpus: Sequence[np.ndarray], sampler: ShardedSampler,
                   seq_len: int, pad_id: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """The batches `DataPipeline` yields, from samples held in memory."""
    for indices in sampler:
        yield _batch_dict([corpus[i] for i in indices], seq_len, pad_id)


@dataclass
class PipelineStats:
    batches: int = 0
    samples: int = 0
    hedged: int = 0
    hedge_wins: int = 0


class DataPipeline:
    def __init__(self, dataset: BuffetDataset, sampler: ShardedSampler, *,
                 seq_len: int, prefetch: int = 2, io_threads: int = 4,
                 hedge_delay_s: Optional[float] = None,
                 pad_id: int = 0) -> None:
        self.dataset = dataset
        self.sampler = sampler
        self.seq_len = seq_len
        self.pad_id = pad_id
        self.hedge_delay_s = hedge_delay_s
        self.stats = PipelineStats()
        self._pool = cf.ThreadPoolExecutor(max_workers=io_threads,
                                           thread_name_prefix="buffet-io")
        self._hedge_pool = cf.ThreadPoolExecutor(max_workers=io_threads,
                                                 thread_name_prefix="buffet-hedge")
        self._q: "queue.Queue[Optional[Dict[str, np.ndarray]]]" = queue.Queue(
            maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- sample read with hedging ---------------------------------------
    def _read_sample(self, idx: int) -> np.ndarray:
        if self.hedge_delay_s is None or not self.dataset.spec.replicated:
            return self.dataset.read_sample(idx)
        primary = self._hedge_pool.submit(self.dataset.read_sample, idx)
        try:
            return primary.result(timeout=self.hedge_delay_s)
        except cf.TimeoutError:
            # straggler: race the replica against the slow primary
            self.stats.hedged += 1
            secondary = self._hedge_pool.submit(
                self.dataset.read_sample, idx, replica=True)
            while True:
                done, pending = cf.wait({primary, secondary},
                                        return_when=cf.FIRST_COMPLETED)
                for f in done:
                    if f.exception() is None:
                        if f is secondary:
                            self.stats.hedge_wins += 1
                        return f.result()
                if not pending:  # both failed
                    raise primary.exception()
        except Exception:
            # primary failed fast (server down): read the replica directly
            self.stats.hedged += 1
            out = self.dataset.read_sample(idx, replica=True)
            self.stats.hedge_wins += 1
            return out

    def _build_batch(self, indices) -> Dict[str, np.ndarray]:
        samples = list(self._pool.map(self._read_sample, indices))
        self.stats.batches += 1
        self.stats.samples += len(samples)
        return _batch_dict(samples, self.seq_len, self.pad_id)

    # --- prefetch loop -----------------------------------------------------
    def _producer(self) -> None:
        it = iter(self.sampler)
        while not self._stop.is_set():
            try:
                batch = self._build_batch(next(it))
            except Exception as e:  # surface to the consumer, don't die mute
                batch = e
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return

    def start(self) -> "DataPipeline":
        self.dataset.warm_dirs()  # metadata RPCs happen HERE, once
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        return self

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self._thread is None:
            self.start()
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def stop(self) -> None:
        self._stop.set()
        while True:  # unblock the producer if it is waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._pool.shutdown(wait=False)
        self._hedge_pool.shutdown(wait=False)
