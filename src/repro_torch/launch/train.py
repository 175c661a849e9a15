"""Training launcher: collaborative training of a model-zoo LM for any
ported ``--arch``, as :mod:`repro.launch.train`.

N agents (the stacked simulation, one device) train the architecture's
next-token loss through :class:`~repro_torch.core.trainer.
CollaborativeTrainer` with the reference's flags, defaults and "implies
``--fused``" rules; the fused consensus update is one kernel launch per
parameter dtype bucket per step (the zoo's dense models are one bfloat16
bucket; an MoE model adds its float32 routers' bucket).  A VLM's batch
carries the reference's stub frontend, ones for every patch.  ``--checkpoint-dir`` saves the whole train state after the run;
``--resume`` restores it first and fast-forwards the batch stream, so a
resumed run continues the uninterrupted one bit for bit.  Weights are drawn
from ``--seed`` (:func:`~repro_torch.nn.param.init_params`).  Runs on the
CUDA card by default (raises without one); ``--device cpu`` runs on the
CPU.

Examples:
  python -m repro_torch.launch.train --arch gemma3-1b --preset full \\
      --agents 4 --topology ring --optimizer cdmsgd --fused --batch 1 --seq 1024
  python -m repro_torch.launch.train --arch rwkv6-1.6b --preset tiny \\
      --device cpu --optimizer cdmsgd --topology ring --agents 8
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import restore_train_state, save_train_state
from repro_torch.configs import get_config
from repro_torch.core import make_optimizer, make_topology, schedules
from repro_torch.core.consensus import describe_exchange_cost
from repro_torch.core.trainer import CollaborativeTrainer, TrainState, train_loop
from repro_torch.data import lm_agent_batches, make_lm_tokens
from repro_torch.device import resolve_device
from repro_torch.nn.param import count_params, init_params
from repro_torch.nn.transformer import loss_fn, model_template


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--agents", type=int, default=5)
    ap.add_argument("--topology", default="fully_connected")
    ap.add_argument("--optimizer", default="cdsgd")
    ap.add_argument("--fused", action="store_true",
                    help="flat-buffer fused consensus update (one kernel "
                         "launch per dtype bucket; consensus optimizers only)")
    ap.add_argument("--exchange", default="f32",
                    choices=["f32", "bf16", "int8", "fp8"],
                    help="neighbor-exchange wire precision of the fused "
                         "path: int8/fp8 = stochastic-rounding quantization "
                         "before the exchange, ~4x fewer bytes per neighbor")
    ap.add_argument("--schedule", default="sync", choices=["sync", "overlap"],
                    help="exchange schedule: 'overlap' double-buffers the "
                         "quantized wire payloads in the optimizer state "
                         "(one-step-stale neighbor mixing; implies --fused)")
    ap.add_argument("--mixing-strategy", default="static",
                    choices=["static", "time_varying", "multi_round"],
                    help="mixing strategy of the fused consensus path: "
                         "'time_varying' cycles --topology-schedule's Pi_t, "
                         "'multi_round' runs --consensus-rounds inner "
                         "i-CDSGD rounds per step (implies --fused)")
    ap.add_argument("--consensus-rounds", type=int, default=1,
                    help="inner consensus rounds per gradient step (k-round "
                         "i-CDSGD: x' = Pi^k x - a g; k x the wire bytes)")
    ap.add_argument("--topology-schedule", default=None,
                    help="time-varying Pi_t schedule spec, e.g. "
                         "'alternating:ring:torus' or 'gossip:8'")
    ap.add_argument("--error-feedback", action="store_true",
                    help="carry quantization residuals in the optimizer "
                         "state and compress residual+payload (int8/fp8 "
                         "exchanges only; adds 0 wire bytes)")
    ap.add_argument("--momentum-mixing", default="none",
                    choices=["none", "mixed"],
                    help="'mixed' puts the momentum buffer on the wire and "
                         "mixes it with the same Pi (v' = mu Pi v - a g); "
                         "2x wire bytes; momentum optimizers only (implies "
                         "--fused)")
    ap.add_argument("--staleness", type=int, default=1,
                    help="bounded-staleness ring depth S (requires "
                         "--schedule overlap, implies --fused)")
    ap.add_argument("--fault-schedule", default=None,
                    help="deterministic fault-injection spec, e.g. "
                         "'straggler:1:2', 'stall:1:1:3,drop:0:2' or 'none' "
                         "(requires --schedule overlap, implies --fused)")
    ap.add_argument("--compressor", default="none",
                    help="wire compressor: 'none', 'int8'/'fp8' (alias the "
                         "--exchange precisions), 'topk:p', 'topk:auto:B' "
                         "or 'rank:r'; topk/rank are biased and require "
                         "--error-feedback (implies --fused)")
    ap.add_argument("--sparse-update", default=None, choices=["on", "off"],
                    help="top-k compressor only: 'on' (the default for topk) "
                         "feeds the compact wire to the sparse kernels; "
                         "'off' decompresses it for the dense update")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--local-steps", type=int, default=1,
                    help="FedAvg E: local steps between sync averages; wire "
                         "accounting reports bytes/E")
    ap.add_argument("--lr-schedule", default="fixed", choices=["fixed", "diminishing"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="restore params AND the full optimizer state (incl. "
                         "overlap wire buffers / error-feedback residuals) "
                         "from --checkpoint-dir before training")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def lm_loss(cfg):
    """The next-token loss of ``cfg`` on a batch ``{"inputs", "targets"}``;
    a frontend model's batch gets the reference's stub frontend, float32
    ones for every patch / frame."""
    def loss(p, batch):
        if cfg.modality in ("audio", "vlm"):
            batch = {**batch, "frontend": torch.ones(
                (batch["inputs"].shape[0], cfg.frontend_tokens, cfg.frontend_dim),
                dtype=torch.float32, device=batch["inputs"].device)}
        return loss_fn(cfg, p, batch)
    return loss


def main(argv=None) -> CollaborativeTrainer:
    """Parse ``argv`` (``sys.argv[1:]`` when None), train, and return the
    trainer (its state, history and wire accounting)."""
    ap = _parser()
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.preset == "tiny":
        cfg = cfg.reduced()

    template = model_template(cfg)
    params = init_params(template, args.seed, device=dev)
    print(f"[train] {cfg.name}: {count_params(template):,} params, "
          f"{args.agents} agents over {args.topology}")

    sched = (args.lr if args.lr_schedule == "fixed"
             else schedules.diminishing(theta=args.lr * 10, eps=1.0, t=10.0))
    kw = {}
    if args.optimizer in ("cdmsgd", "cdmsgd_nesterov", "msgd", "fedavg"):
        kw["mu"] = args.momentum
    if args.optimizer == "fedavg":
        kw["local_steps"] = args.local_steps
    if args.exchange != "f32" and not args.fused:
        print(f"[train] --exchange {args.exchange} implies --fused; enabling")
        args.fused = True
    if args.schedule == "overlap" and not args.fused:
        print("[train] --schedule overlap implies --fused; enabling")
        args.fused = True
    fault_tolerant = (args.staleness > 1
                      or (args.fault_schedule not in (None, "none")))
    if fault_tolerant and args.schedule != "overlap":
        ap.error("--staleness > 1 / --fault-schedule need --schedule overlap "
                 "(the staleness ring generalizes the overlap wire buffer)")
    nontrivial_mixing = (args.mixing_strategy != "static"
                         or args.consensus_rounds > 1 or args.error_feedback
                         or args.momentum_mixing != "none" or fault_tolerant
                         or args.compressor != "none")
    if nontrivial_mixing and not args.fused:
        print("[train] non-static mixing strategy implies --fused; enabling")
        args.fused = True
    if args.fused:
        kw["fused"] = True
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume needs --checkpoint-dir")
    opt = make_optimizer(args.optimizer, sched, **kw)
    topo = make_topology(args.topology, args.agents)

    trainer = CollaborativeTrainer(
        lm_loss(cfg), params, topo, opt, device=dev, exchange=args.exchange,
        schedule=args.schedule, microbatches=args.microbatch,
        mixing_strategy=args.mixing_strategy,
        consensus_rounds=args.consensus_rounds,
        topology_schedule=args.topology_schedule,
        error_feedback=args.error_feedback,
        momentum_mixing=args.momentum_mixing, staleness=args.staleness,
        fault_schedule=args.fault_schedule, compressor=args.compressor,
        sparse_update=(None if args.sparse_update is None
                       else args.sparse_update == "on"))
    del params

    program = trainer.program
    if not program.is_trivial:
        print(f"[train] mixing program: {program.describe()}")
        if not program.schedule.is_static:
            d = program.schedule.diagnostics(program.rounds)
            print(f"[train] schedule effective gap "
                  f"{d['effective_gap']:.4f} (per-matrix "
                  f"{['%.4f' % g for g in d['per_matrix_gap']]})")
    if args.optimizer == "fedavg":
        print(f"[train] fedavg all-reduce: {trainer.wire_bytes_per_step:,} "
              f"bytes/agent/step amortized (sync every "
              f"{opt.local_steps} steps"
              + (", params + momentum averaged" if opt.mu else "") + ")")
    else:
        print("[train] " + describe_exchange_cost(
            trainer.state.params,
            program.schedule if not program.schedule.is_static else topo,
            trainer.exchange, rounds=program.rounds,
            payloads=program.n_payloads, program=program))
    tokens = make_lm_tokens(1 << 15, vocab=cfg.vocab_size, seed=args.seed)
    batches = lm_agent_batches(tokens, args.agents, args.batch, args.seq,
                               seed=args.seed)

    if args.resume:
        p0, o0 = restore_train_state(args.checkpoint_dir,
                                     trainer.state.params,
                                     trainer.state.opt_state)
        trainer.state = TrainState(params=p0, opt_state=o0, step=int(o0.step))
        # fast-forward the (deterministic, seed-keyed) batch stream past the
        # steps the checkpointed run already consumed
        for _ in range(trainer.state.step):
            next(batches)
        print(f"[train] resumed at step {trainer.state.step} (full opt "
              "state incl. wire/residual buffers; batch stream "
              "fast-forwarded)")

    train_loop(trainer, batches, args.steps, log_every=args.log_every,
               printer=print)
    final = trainer.history.rows[-1]
    print(f"[train] done: loss={final['loss']:.4f} "
          f"consensus_error={final['consensus_error']:.3e}")
    if args.checkpoint_dir:
        p = save_train_state(args.checkpoint_dir, trainer.state.step,
                             trainer.state.params, trainer.state.opt_state)
        print(f"[train] checkpoint: {p}")
    return trainer


if __name__ == "__main__":
    main()
