"""Batched serving entry point of the port: prefill + greedy decode loop.

Counterpart of `repro/launch/serve.py`.  Loads (or initialises) a model on
the card, serves a batch of token prompts against a KV cache, and returns
the greedy tokens.  Runs on `cuda` unless the caller passes `device="cpu"`.
An arch with a stub frontend (pixtral-12b's vit, musicgen-large's encodec)
takes each token's row of a seeded table as its `embeds`, as JAX's Server.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b --tokens 32
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs import get_config
from ..models import init_cache, init_model
from ..runtime.steps import prefill_step, serve_step


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


class Server:
    def __init__(self, arch: str, *, reduced: bool = True, max_len: int = 512,
                 params=None, device="cuda", seed: int = 0) -> None:
        self.device = resolve_device(device)
        cfg = get_config(arch)
        self.cfg = cfg.reduced() if reduced else cfg
        self.max_len = max_len
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            with torch.inference_mode():
                params = init_model(self.cfg, gen, self.device)
        self.params = params
        # JAX rebuilds the stub table on the host at every call (every decode
        # step); the port builds it once and gathers each step's rows on the
        # device
        self._stub = (None if self.cfg.frontend is None
                      else stub_table(self.cfg.vocab_size, self.cfg.d_model, self.device))

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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, n_tokens: int) -> Dict[str, object]:
        """prompts [B, S0] int -> generated [B, n_tokens], greedy.

        Returns the JAX Server's dict (tokens, prefill_s, decode_tok_per_s)
        plus `finite`: whether every logit of the run was finite."""
        b, s0 = prompts.shape
        if s0 + n_tokens > self.max_len:
            raise ValueError(f"{s0} prompt + {n_tokens} new tokens exceed "
                             f"max_len {self.max_len}")
        cache = init_cache(self.cfg, b, self.max_len, self.device)
        batch = self.batch(torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                           device=self.device))
        self._sync()
        t0 = time.perf_counter()
        logits, cache = prefill_step(self.params, cache, batch, self.cfg)
        self._sync()
        prefill_s = time.perf_counter() - t0

        finite = torch.isfinite(logits).all()
        outs: List[torch.Tensor] = []
        tok = logits[:, -1].argmax(-1)
        self._sync()
        t0 = time.perf_counter()
        for i in range(n_tokens):
            outs.append(tok)
            logits, cache = serve_step(self.params, cache, self.batch(tok[:, None]),
                                       s0 + i, self.cfg)
            finite &= torch.isfinite(logits).all()
            tok = logits[:, -1].argmax(-1)
        self._sync()
        decode_s = time.perf_counter() - t0
        tokens = (torch.stack(outs, 1) if outs
                  else torch.empty((b, 0), dtype=torch.long))
        return {"tokens": tokens.cpu().numpy().astype(np.int32),
                "prefill_s": prefill_s,
                "decode_tok_per_s": b * n_tokens / max(decode_s, 1e-9),
                "finite": bool(finite)}


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
