#!/usr/bin/env python
"""Causal language-model training (data-parallel), the twin of
examples/train_lm.py: ``transformer_lm`` with the flash kernels (K1-K3
on the card), next-token loss, single/DP/DDP through the strategy
layer, goodput fields per log window, the final weights as the JAX
script writes them (``<out>/lm_final.msgpack``, flax msgpack, which
``serve_lm --restore`` serves).  ``main(argv)`` returns the trained
state.

    python -m dtdl_tpu_torch.examples.train_lm --batch-size 32 --seq-len 128
    python -m dtdl_tpu_torch.launch.local --nproc 2 -- \\
        -m dtdl_tpu_torch.examples.train_lm --strategy ddp --platform cpu

Observability (:mod:`dtdl_tpu_torch.obs`): goodput and MFU per log window
through a ``GoodputMeter``, and with ``--trace PATH`` a Perfetto-loadable
Chrome trace of the host phases (``data``, ``dispatch``, ``drain``) and
the window-settled device track, as the JAX twin writes it.
"""

import time

import numpy as np

from dtdl_tpu_torch.bridge import state_dict_to_flax
from dtdl_tpu_torch.ckpt import save_weights
from dtdl_tpu_torch.data.datasets import load_dataset
from dtdl_tpu_torch.data.loader import DataLoader
from dtdl_tpu_torch.data.sharding import ShardedSampler
from dtdl_tpu_torch.examples.common import bootstrap
from dtdl_tpu_torch.metrics.report import Reporter, StdoutSink
from dtdl_tpu_torch.models import generate, transformer_lm
from dtdl_tpu_torch.obs import (GoodputMeter, Observer, lm_train_flops,
                                peak_flops_per_chip)
from dtdl_tpu_torch.parallel import choose_strategy
from dtdl_tpu_torch.runtime import is_leader, process_count, process_index
from dtdl_tpu_torch.train.optim import adamw
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_lm_train_step
from dtdl_tpu_torch.utils.config import (add_ckpt_flags, add_data_flags,
                                         add_topology_flags, add_train_flags,
                                         flag, make_parser)
from dtdl_tpu_torch.utils.random import seed_everything


def main(argv=None):
    parser = make_parser("dtdl_tpu_torch: causal LM training (DP/DDP)")
    add_train_flags(parser, batch_size=32, lr=3e-4, epochs=2)
    add_data_flags(parser, dataset="synthetic_lm")
    add_ckpt_flags(parser)
    add_topology_flags(parser)
    flag(parser, "--strategy", default="auto",
         choices=["auto", "single", "dp", "ddp"])
    flag(parser, "--model-size", default="tiny",
         choices=["tiny", "small", "base"])
    flag(parser, "--seq-len", type=int, default=128)
    flag(parser, "--attn", default="flash", choices=["flash", "dense"])
    flag(parser, "--vocab-chunk-size", type=int, default=0,
         help=">0: vocab-chunked LM loss with tiles of N vocab COLUMNS")
    flag(parser, "--n-experts", type=int, default=0,
         help=">0: switch-MoE MLPs with this many experts")
    flag(parser, "--moe-dispatch", default="dense",
         choices=["dense", "routed"])
    flag(parser, "--capacity-factor", type=float, default=1.25)
    flag(parser, "--moe-top-k", type=int, default=1)
    flag(parser, "--moe-group-size", type=int, default=0)
    flag(parser, "--moe-aux-weight", type=float, default=0.01)
    flag(parser, "--generate-tokens", type=int, default=0,
         help=">0: after training, greedily decode this many tokens from "
              "a training-prefix prompt, one row per replica")
    flag(parser, "--trace", default="",
         help="write a Chrome-trace JSON of the host phases here")
    args = parser.parse_args(argv)

    if args.dataset != "synthetic_lm":
        raise SystemExit("train_lm trains on token data; "
                         "use --dataset synthetic_lm")

    device = bootstrap(args)
    seed_everything(args.seed)
    strategy = choose_strategy(args.strategy)

    train_tokens, _ = load_dataset(args.dataset, seq_len=args.seq_len)
    model = transformer_lm(args.model_size, device=device, seed=args.seed,
                           max_seq=args.seq_len, attn_impl=args.attn,
                           n_experts=args.n_experts,
                           moe_dispatch=args.moe_dispatch,
                           capacity_factor=args.capacity_factor,
                           moe_top_k=args.moe_top_k,
                           moe_group_size=args.moe_group_size)
    if train_tokens.max() >= model.cfg.vocab_size:
        raise SystemExit("dataset vocab exceeds model vocab")

    nproc = process_count()
    strategy.per_replica_batch(args.batch_size)   # validate divisibility
    sampler = ShardedSampler(len(train_tokens), nproc, process_index(),
                             shuffle=True, seed=args.seed)
    per_proc = args.batch_size // nproc
    loader = DataLoader({"tokens": train_tokens}, per_proc,
                        sampler=sampler, device=device)
    state = strategy.replicate(init_state(model, None, adamw(args.lr),
                                          device=device))
    step = make_lm_train_step(strategy,
                              vocab_chunk_size=args.vocab_chunk_size,
                              moe_aux_weight=args.moe_aux_weight)
    # goodput and MFU per log window through the reporter; with --trace
    # a span trace of the host phases (one card a process: its peak)
    on_card = model.device.type == "cuda"
    obs = Observer(trace_path=args.trace or None, sentinel="warn",
                   goodput=GoodputMeter(
                       flops_per_step=lm_train_flops(model.cfg, per_proc,
                                                     args.seq_len),
                       tokens_per_step=per_proc * (args.seq_len - 1),
                       peak_flops=peak_flops_per_chip() if on_card
                       else None))
    step = obs.watch(step, "lm_train_step")
    global_step = 0
    t_win, steps_win = time.perf_counter(), 0
    with Reporter([StdoutSink()]) as reporter:
        for epoch in range(args.epochs):
            loader.set_epoch(epoch)
            for batch in loader:
                with obs.span("data"):
                    sharded = strategy.shard_batch(batch)
                with obs.span("dispatch", step=global_step):
                    state, metrics = step(state, sharded)
                steps_win += 1
                if global_step % args.log_interval == 0:
                    with obs.span("drain"):
                        loss = float(metrics["loss"])  # settles the window
                        row = {"epoch": epoch, "step": global_step,
                               "loss": loss,
                               "accuracy": float(metrics["accuracy"]),
                               "ppl": float(np.exp(min(20.0, loss)))}
                        if "moe_aux_loss" in metrics:
                            row["moe_aux_loss"] = float(
                                metrics["moe_aux_loss"])
                    row.update(obs.window(steps_win,
                                          time.perf_counter() - t_win))
                    t_win, steps_win = time.perf_counter(), 0
                    reporter.report(row)
                global_step += 1
    if args.trace and is_leader():
        print(f"trace written to {obs.save()}", flush=True)
    if args.save_model:
        path = save_weights(f"{args.out}/lm_final.msgpack",
                            state_dict_to_flax(model))
        if is_leader():
            print(f"saved weights to {path}", flush=True)
    # the diagnostic decode runs after the save: a generation error must
    # never discard the trained weights
    if args.generate_tokens:
        n_rows = max(1, strategy.num_replicas)
        prompt = train_tokens[:n_rows, :8]
        out = generate(model, prompt, args.generate_tokens,
                       strategy=strategy)
        if is_leader():
            print("generated:", out.cpu().numpy()[0].tolist(), flush=True)
    return state


if __name__ == "__main__":
    main()
