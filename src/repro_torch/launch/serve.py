"""Batched serving entry point of the port: prefill + greedy decode loop.

Counterpart of `repro/launch/serve.py`.  Loads (or initialises) a model on
the card, serves a batch of token prompts against a KV cache, and returns
the greedy tokens.  Runs on `cuda` unless the caller passes `device="cpu"`.
An arch with a stub frontend (pixtral-12b's vit, musicgen-large's encodec)
takes each token's row of a seeded table as its `embeds`, as JAX's Server.
Given a `DeviceMesh` (`mesh=`), the Server runs the sharded serve path, as
JAX's dry run lowers it (JAX's own Server never shards): params at
`param_specs` (`shard_params`), the cache at `cache_specs` (`shard_cache`),
each batch at `batch_shardings`, every step under the cell's activation
specs; the logits come back whole.

The decode step is compiled as JAX's Server jits `serve_step` with the
cache donated: on a CUDA device without a mesh the Server captures one
decode step per batch size as a `torch.cuda.CUDAGraph` and replays it for
every later token, the position a device scalar the step advances itself.
The batch size's cache is kept (the donated buffer) and zeroed at each
call.  On the CPU, and under a mesh (whose cache keeps host int positions),
the same step runs eagerly; the choice follows the device, with no switch
and no fallback: a capture or replay that fails raises.  The prefill stays
eager, as a graph replayed once per prompt shape saves nothing.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b --tokens 32
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import InputShape, get_config
from ..context import activation_specs
from ..kernels import add_launches, launches
from ..models import init_cache, init_model
from ..runtime import sharding as sh
from ..runtime.steps import prefill_step, serve_step, shard_batch, shard_cache, shard_params
from ..tree import tree_leaves


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device without a card is an error, never
    a quiet switch to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "device='cpu' to run the plain versions on the CPU")
    return dev


# the stub frontend's table: JAX's Server draws it from this seed
STUB_SEED, STUB_SCALE = 1234, 0.02
_STUB_ROWS = 4096           # rows drawn at a time: ~84 MB of fp32 at d 5120


def stub_table(vocab: int, d: int, device) -> torch.Tensor:
    """The stub frontend's [vocab, d] table as bf16 on `device`: the bits of
    JAX's `Server._embed_stub`, which draws `default_rng(STUB_SEED)
    .standard_normal((vocab, d), float32) * STUB_SCALE` and casts the rows
    it indexes to bf16.  The draws are taken in blocks of rows from the same
    generator (the same stream, in the same order), each block scaled in
    fp32 on the host and cast on `device`, so the host holds one block."""
    rng = np.random.default_rng(STUB_SEED)
    table = torch.empty((vocab, d), dtype=torch.bfloat16, device=device)
    for r0 in range(0, vocab, _STUB_ROWS):
        rows = min(_STUB_ROWS, vocab - r0)
        block = rng.standard_normal((rows, d), dtype=np.float32) * np.float32(STUB_SCALE)
        table[r0:r0 + rows] = torch.from_numpy(block).to(device)
    return table


class _Decode:
    """One batch size's decode state, kept across calls as JAX's jit keeps a
    step's executable and its donated cache: the cache, the step's inputs
    (the token [B, 1], the position, a 0-d int64) and what the step writes
    in place (each token fed at its position in `tokens` [B, max_len], the
    finite flag); on the card also the step's CUDA graph, its output logits
    (rewritten by every replay) and one replay's kernel launches."""

    def __init__(self, cache, batch: int, max_len: int, device) -> None:
        self.cache = cache
        self.tok = torch.zeros((batch, 1), dtype=torch.long, device=device)
        self.pos = torch.zeros((), dtype=torch.long, device=device)
        self.tokens = torch.zeros((batch, max_len), dtype=torch.long, device=device)
        self.finite = torch.ones((), dtype=torch.bool, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}


class Server:
    def __init__(self, arch: str, *, reduced: bool = True, max_len: int = 512,
                 params=None, device="cuda", seed: int = 0, mesh=None) -> None:
        self.device = resolve_device(device)
        cfg = get_config(arch)
        self.cfg = cfg.reduced() if reduced else cfg
        self.max_len = max_len
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            with torch.inference_mode():
                params = init_model(self.cfg, gen, self.device)
        self.mesh = mesh
        self.params = params if mesh is None else shard_params(params, self.cfg, mesh)
        # JAX rebuilds the stub table on the host at every call (every decode
        # step); the port builds it once and gathers each step's rows on the
        # device
        self._stub = (None if self.cfg.frontend is None
                      else stub_table(self.cfg.vocab_size, self.cfg.d_model, self.device))
        self._decodes: Dict[int, _Decode] = {}

    def _embed_stub(self, tokens: torch.Tensor) -> Optional[torch.Tensor]:
        """Stub modality frontend: deterministic pseudo-embeddings per token,
        [..., d] bf16 (audio and vlm archs take precomputed frame or patch
        embeddings); None for an arch without a frontend."""
        return None if self._stub is None else self._stub[tokens]

    def batch(self, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The model's batch for `tokens` [B, S] on the server's device: the
        tokens, and the stub frontend's `embeds` where the arch has one."""
        out = {"tokens": tokens}
        emb = self._embed_stub(tokens)
        if emb is not None:
            out["embeds"] = emb
        return out

    def _step(self, fn, cache, batch: Dict[str, torch.Tensor], shape: InputShape, *args):
        """One prefill or decode step; under a mesh the batch is placed by
        `batch_shardings` and the step runs under the shape's activation
        specs, and the logits come back whole."""
        if self.mesh is None:
            return fn(self.params, cache, batch, *args, self.cfg)
        decode = shape.kind == "decode"
        batch = shard_batch(batch, self.mesh, shape, for_decode=decode)
        with activation_specs(sh.activation_specs_for(sh.mesh_shape(self.mesh), shape,
                                                      self.cfg)):
            logits, cache = fn(self.params, cache, batch, *args, self.cfg)
        return logits.full_tensor(), cache

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode_graph(self, batch: int) -> Optional[torch.cuda.CUDAGraph]:
        """The decode step's CUDA graph at this batch size, once captured.
        It keeps its nodes (`keep_graph`): `debug_dump(path)` writes them."""
        d = self._decodes.get(batch)
        return None if d is None else d.graph

    def generate(self, prompts: np.ndarray, n_tokens: int) -> Dict[str, object]:
        """prompts [B, S0] int -> generated [B, n_tokens], greedy.

        Returns the JAX Server's dict (tokens, prefill_s, decode_tok_per_s)
        plus `finite`: whether every logit of the run was finite,
        `last_logits`: a copy of the last step's logits [B, 1, V], and
        `capture_s`: the seconds this call spent capturing the decode graph
        (0 where one was reused, and off the graph's path), which
        decode_tok_per_s leaves out.  Runs under inference mode, or under a
        mesh under no_grad: in inference mode DTensor meets composite ops
        (einsum) undecomposed and decomposes them anew at every call, an
        order of magnitude more host time."""
        with torch.inference_mode() if self.mesh is None else torch.no_grad():
            return self._generate(prompts, n_tokens)

    def _state(self, batch: int) -> _Decode:
        """The batch size's decode state, its cache zeroed (a new one the
        first time): the prefill reads the Mamba layers' states as its h0."""
        d = self._decodes.get(batch)
        if d is None:
            cache = init_cache(self.cfg, batch, self.max_len, self.device)
            if self.mesh is not None:
                cache = shard_cache(cache, self.cfg, self.mesh, batch, self.max_len)
            d = self._decodes[batch] = _Decode(cache, batch, self.max_len, self.device)
        else:
            for t in tree_leaves(d.cache):
                t.zero_()
        return d

    def _decode_once(self, d: _Decode, pos) -> torch.Tensor:
        """One decode step on d's buffers, the same ops eagerly and in a
        graph: the token fed is kept at its position, the step runs at
        `pos` (d.pos, or a host int under a mesh), then the finite flag, the
        next token (the argmax) and the next position are written in place.
        Returns the step's logits."""
        b = d.tok.shape[0]
        d.tokens.index_copy_(1, d.pos.reshape(1), d.tok)
        logits, _ = self._step(serve_step, d.cache, self.batch(d.tok),
                               InputShape("decode", self.max_len, b, "decode"), pos)
        d.finite.logical_and_(torch.isfinite(logits).all())
        d.tok.copy_(logits[:, -1].argmax(-1, keepdim=True))
        d.pos.add_(1)
        return logits

    def _warm_up_and_capture(self, d: _Decode) -> Tuple[torch.Tensor, float]:
        """The first decode step at a batch size on the card, then its graph.
        The step runs eagerly on the stream that then captures (the warm-up:
        the kernels build, cuBLAS initialises) and is this call's first
        step; the capture runs nothing.  The wrappers counted the captured
        calls, which ran no kernel: those counts are taken back out and kept
        as one replay's.  Returns the step's logits and the capture's
        seconds."""
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            logits = self._decode_once(d, d.pos)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = launches()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=stream):
            d.logits = self._decode_once(d, d.pos)
        graph.instantiate()             # a kept graph is instantiated on request
        capture_s = time.perf_counter() - t0
        d.launches = {k: v - before[k] for k, v in launches().items() if v != before[k]}
        add_launches(d.launches, -1)
        d.graph = graph
        return logits, capture_s

    def _generate(self, prompts: np.ndarray, n_tokens: int) -> Dict[str, object]:
        b, s0 = prompts.shape
        if s0 + n_tokens > self.max_len:
            raise ValueError(f"{s0} prompt + {n_tokens} new tokens exceed "
                             f"max_len {self.max_len}")
        d = self._state(b)
        graphed = self.device.type == "cuda" and self.mesh is None
        prefill = InputShape("prefill", s0, b, "prefill")
        batch = self.batch(torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                           device=self.device))
        self._sync()
        t0 = time.perf_counter()
        logits, _ = self._step(prefill_step, d.cache, batch, prefill)
        self._sync()
        prefill_s = time.perf_counter() - t0

        d.finite.copy_(torch.isfinite(logits).all())
        d.tok.copy_(logits[:, -1].argmax(-1, keepdim=True))
        d.pos.fill_(s0)
        capture_s = 0.0
        self._sync()
        t0 = time.perf_counter()
        for i in range(n_tokens):
            if d.graph is not None:
                d.graph.replay()
                add_launches(d.launches)
                logits = d.logits
            elif graphed:
                logits, capture_s = self._warm_up_and_capture(d)
            else:
                logits = self._decode_once(d, d.pos if self.mesh is None else s0 + i)
        self._sync()
        decode_s = time.perf_counter() - t0 - capture_s
        return {"tokens": d.tokens[:, s0:s0 + n_tokens].cpu().numpy().astype(np.int32),
                "prefill_s": prefill_s,
                "decode_tok_per_s": b * n_tokens / max(decode_s, 1e-9),
                "finite": bool(d.finite), "last_logits": logits.clone(),
                "capture_s": capture_s}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    srv = Server(args.arch, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, srv.cfg.vocab_size,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    out = srv.generate(prompts, args.tokens)
    print(f"[serve] arch={args.arch} device={srv.device} "
          f"prefill={out['prefill_s']:.2f}s "
          f"decode={out['decode_tok_per_s']:.1f} tok/s")
    print(out["tokens"][:, :8])


if __name__ == "__main__":
    main()
