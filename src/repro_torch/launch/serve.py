"""Serving launcher: batched greedy decoding with a KV cache, as
:mod:`repro.launch.serve`.

The prompt is teacher-forced through :func:`decode_step` one token at a
time, then each next token is the greedy argmax.  An encoder-decoder first
runs its encoder once (:func:`encode_for_decode`, before the timed loop)
on the reference's stub frames, float32 ones ``(batch, frontend_tokens,
frontend_dim)``, into the cache's ``enc_out``.  Weights are drawn from
``--seed`` (:func:`init_params`); the prompt from ``np.random.default_rng
(seed)``, as in the reference.  Runs on the CUDA card by default (raises
without one); ``--device cpu`` runs on the CPU.

Examples:
  python -m repro_torch.launch.serve --arch gemma3-1b --preset full
  python -m repro_torch.launch.serve --arch rwkv6-1.6b --preset tiny --device cpu
  python -m repro_torch.launch.serve --arch seamless-m4t-medium --preset tiny --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.nn.param import init_params
from repro_torch.nn.transformer import (decode_step, encode_for_decode, init_cache,
                                        model_template)


def make_prompt(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """The reference's prompt: ``(batch, prompt_len)`` ids in [1, vocab)."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, size=(batch, prompt_len))


def serve(cfg, params, prompt: np.ndarray, new_tokens: int,
          device=None) -> Tuple[np.ndarray, Dict[str, float]]:
    """Greedy decode after a teacher-forced ``prompt (batch, prompt_len)``.

    Returns ``(tokens (batch, prompt_len + new_tokens), stats)``; stats has
    the wall ``seconds`` of the loop (synchronized; an encoder-decoder's
    encode runs before it), its ``decode_steps``,
    ``tokens_per_s`` (``batch * max_len / seconds``, the figure the
    reference's loop prints: every token of the returned sequences) and
    ``decode_tokens_per_s`` (``batch * decode_steps / seconds``: tokens
    through :func:`decode_step`, ``max_len - 1`` per sequence).
    """
    dev = resolve_device(device)
    batch, prompt_len = prompt.shape
    max_len = prompt_len + new_tokens
    with torch.inference_mode():
        enc_len = cfg.frontend_tokens if cfg.is_encoder_decoder else 0
        cache = init_cache(cfg, batch, max_len, enc_len=enc_len, device=dev)
        if cfg.is_encoder_decoder:
            frames = torch.ones((batch, cfg.frontend_tokens, cfg.frontend_dim),
                                dtype=torch.float32, device=dev)
            cache["enc_out"] = encode_for_decode(cfg, params, frames)
        prompt_t = torch.as_tensor(prompt, dtype=torch.long, device=dev)
        tok = prompt_t[:, :1]
        out = [tok]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(max_len - 1):
            logits, cache = decode_step(cfg, params, cache, tok, i)
            if i + 1 < prompt_len:               # teacher-force the prompt
                tok = prompt_t[:, i + 1: i + 2]
            else:
                tok = torch.argmax(logits, dim=-1)[:, None]
            out.append(tok)
        seqs = torch.cat(out, dim=1).cpu().numpy()
        dt = time.perf_counter() - t0
    steps = max_len - 1

    def rate(n):
        return n / dt if dt > 0 else float("inf")

    return seqs, {"seconds": dt, "decode_steps": steps,
                  "tokens_per_s": rate(batch * max_len),
                  "decode_tokens_per_s": rate(batch * steps)}


def main(argv=None) -> None:
    """Parse ``argv`` (``sys.argv[1:]`` when None) and serve."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "tiny":
        cfg = cfg.reduced()
    params = init_params(model_template(cfg), args.seed, device=dev)
    prompt = make_prompt(cfg, args.batch, args.prompt_len, args.seed)
    seqs, stats = serve(cfg, params, prompt, args.new_tokens, dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"[serve] {cfg.name}: decoded {args.batch}x{seqs.shape[1]} tokens in "
          f"{stats['seconds']:.2f}s ({stats['tokens_per_s']:.1f} tok/s, "
          f"{stats['decode_tokens_per_s']:.1f} decode tok/s on {where})")
    print("[serve] first sequence:", seqs[0].tolist())


if __name__ == "__main__":
    main()
