"""Batched serving entry point of the port: prefill + greedy decode loop.

Counterpart of `repro/launch/serve.py`.  Loads (or initialises) a model on
the card, serves a batch of token prompts against a KV cache, and returns
the greedy tokens.  Runs on `cuda` unless the caller passes `device="cpu"`.

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
        batch = {"tokens": torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                           device=self.device)}
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
            logits, cache = serve_step(self.params, cache, {"tokens": tok[:, None]},
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
