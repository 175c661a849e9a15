"""End-to-end example: collaborative LM pre-training with CDSGD/CDMSGD.

Trains one of the zoo's architectures collaboratively across N agents,
each holding a private shard of the token stream (the paper's
data-parallel, decentralized setting applied to a modern LM), with
checkpointing and evaluation against a held-out stream.

Scale presets:
  --scale tiny   (default) the reduced config
  --scale 100m   a ~100M-param config for a few hundred steps

On the CUDA card by default (``--device cpu`` on the CPU):

    PYTHONPATH=src python -m repro_torch.examples.collaborative_lm_pretrain \\
        --arch rwkv6-1.6b --agents 4 --topology ring --steps 60
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import make_optimizer, make_topology, schedules
from repro_torch.core.consensus import describe_exchange_cost
from repro_torch.core.trainer import CollaborativeTrainer
from repro_torch.data import lm_agent_batches, make_lm_tokens
from repro_torch.device import resolve_device
from repro_torch.launch.train import lm_loss
from repro_torch.nn import count_params, init_params, model_template


def scale_config(cfg, scale: str):
    if scale == "tiny":
        return cfg.reduced()
    if scale == "100m":
        return dataclasses.replace(
            cfg.reduced(), name=cfg.name + "-100m",
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=min(cfg.n_kv_heads, 12),
            head_dim=64, d_ff=3072, vocab_size=32768,
            n_experts=min(cfg.n_experts, 8) if cfg.is_moe else 0,
            d_ff_expert=1024 if cfg.is_moe else 0)
    raise ValueError(scale)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--scale", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--optimizer", default="cdmsgd")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--fused", action="store_true",
                    help="flat-buffer fused consensus update")
    ap.add_argument("--exchange", default="f32",
                    choices=["f32", "bf16", "int8", "fp8"],
                    help="simulated neighbor-exchange wire precision "
                         "(implies --fused; the knob lives on the fused path)")
    ap.add_argument("--diminishing", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = scale_config(get_config(args.arch), args.scale)
    template = model_template(cfg)
    params = init_params(template, 0)
    print(f"[e2e] {cfg.name}: {count_params(template):,} params | "
          f"{args.agents} agents | {args.topology} | {args.optimizer}")

    sched = (schedules.diminishing(theta=args.lr * 20, eps=1.0, t=20.0)
             if args.diminishing else args.lr)
    kw = {"mu": 0.9} if args.optimizer in ("cdmsgd", "cdmsgd_nesterov") else {}
    if args.exchange != "f32" and not args.fused:
        print(f"[e2e] --exchange {args.exchange} implies --fused; enabling")
        args.fused = True
    if args.fused:
        kw["fused"] = True
    opt = make_optimizer(args.optimizer, sched, **kw)
    topo = make_topology(args.topology, args.agents)

    loss_of = lm_loss(cfg)
    trainer = CollaborativeTrainer(loss_of, params, topo, opt, device=dev,
                                   exchange=args.exchange)
    print("[e2e] " + describe_exchange_cost(trainer.state.params, topo, args.exchange))

    # private token shards per agent
    tokens = make_lm_tokens(1 << 16, vocab=cfg.vocab_size, seed=0)
    batches = lm_agent_batches(tokens, args.agents, args.batch, args.seq, seed=0)
    held_out = make_lm_tokens(1 << 12, vocab=cfg.vocab_size, seed=99)

    t0 = time.time()
    first_loss = None
    for i in range(args.steps):
        m = trainer.step(next(batches))
        first_loss = first_loss or m["loss"]
        if (i + 1) % 10 == 0:
            print(f"[e2e] step {i+1:>4} loss={m['loss']:.4f} "
                  f"consensus={m['consensus_error']:.3e} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")

    # evaluate the consensus model on held-out tokens
    hb = {"inputs": torch.as_tensor(held_out[None, : args.seq], dtype=torch.int32,
                                    device=dev),
          "targets": torch.as_tensor(held_out[None, 1: args.seq + 1], dtype=torch.int32,
                                     device=dev)}
    with torch.no_grad():
        held, _ = loss_of(trainer.mean_params(), hb)
    print(f"[e2e] train loss {first_loss:.4f} -> {m['loss']:.4f}; "
          f"held-out (consensus model): {float(held):.4f}")
    assert m["loss"] < first_loss, "training must reduce the loss"
    if args.ckpt:
        print("[e2e] saved:", save_checkpoint(args.ckpt, trainer.state.step,
                                              {"params": trainer.state.params}))
    return trainer


if __name__ == "__main__":
    main()
