"""Batched serving demo: decode from a CDSGD-trained consensus model.

Trains a tiny LM collaboratively (4 agents on a ring, CDMSGD), extracts the
consensus (agent-mean) model, then serves batched greedy-decode requests
with a KV cache (an encoder-decoder runs its encoder once first, on the
reference's stub frames).  On the CUDA card by default:

    PYTHONPATH=src python -m repro_torch.examples.serve_batched --arch gemma3-1b
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import make_optimizer, make_topology
from repro_torch.core.trainer import CollaborativeTrainer
from repro_torch.data import lm_agent_batches, make_lm_tokens
from repro_torch.device import resolve_device
from repro_torch.launch.train import lm_loss
from repro_torch.nn import (decode_step, encode_for_decode, init_cache, init_params,
                            model_template)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--train-steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=0.005)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    params = init_params(model_template(cfg), 0)

    # 1. collaborative training (4 agents, ring)
    topo = make_topology("ring", 4)
    trainer = CollaborativeTrainer(lm_loss(cfg), params, topo,
                                   make_optimizer("cdmsgd", args.lr, mu=0.9), device=dev)
    tokens = make_lm_tokens(1 << 14, vocab=cfg.vocab_size, seed=0)
    batches = lm_agent_batches(tokens, 4, 4, 32, seed=0)
    for _ in range(args.train_steps):
        m = trainer.step(next(batches))
    print(f"[serve] trained {args.train_steps} steps, loss={m['loss']:.3f}")

    # 2. consensus model -> batched KV-cache decoding
    serve_params = trainer.mean_params()
    max_len = args.prompt_len + args.new_tokens
    prompts = np.stack([tokens[i * 100: i * 100 + args.prompt_len]
                        for i in range(args.batch)])
    with torch.inference_mode():
        enc_len = cfg.frontend_tokens if cfg.is_encoder_decoder else 0
        cache = init_cache(cfg, args.batch, max_len, enc_len=enc_len, device=dev)
        if cfg.is_encoder_decoder:
            cache["enc_out"] = encode_for_decode(cfg, serve_params, torch.ones(
                (args.batch, cfg.frontend_tokens, cfg.frontend_dim), device=dev))
        prompt_t = torch.as_tensor(prompts, dtype=torch.long, device=dev)
        tok = prompt_t[:, :1]
        seqs = [tok]
        t0 = time.time()
        for i in range(max_len - 1):
            logits, cache = decode_step(cfg, serve_params, cache, tok, i)
            if i + 1 < args.prompt_len:
                tok = prompt_t[:, i + 1: i + 2]
            else:
                tok = torch.argmax(logits, -1)[:, None]
            seqs.append(tok)
        out = torch.cat(seqs, dim=1).cpu().numpy()
        dt = time.time() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"[serve] {args.batch} requests x {max_len} tokens in {dt:.2f}s "
          f"({args.batch * max_len / dt:.1f} tok/s on {where})")
    for b in range(min(args.batch, 2)):
        print(f"[serve] req{b}: prompt={out[b, :args.prompt_len].tolist()} "
              f"-> {out[b, args.prompt_len:].tolist()}")
    return out


if __name__ == "__main__":
    main()
