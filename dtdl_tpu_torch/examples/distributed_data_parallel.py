#!/usr/bin/env python
"""Multi-process allreduce data parallelism — the flagship path, the twin
of examples/distributed_data_parallel.py.

PyramidNet-110 on CIFAR-10 with the reference's recipe: multi-process
rendezvous, per-process card binding, gradient allreduce, per-rank
dataset stripes, the GLOBAL batch split over the ranks, SGD + StepLR(2,
0.1), the weights saved at the end by the leader alone.

    python -m dtdl_tpu_torch.launch.local --nproc 2 -- \\
        -m dtdl_tpu_torch.examples.distributed_data_parallel --batch-size 64

or by hand, one shell per rank:

    python -m dtdl_tpu_torch.examples.distributed_data_parallel \\
        --coordinator h1:8476 --num-processes 2 --process-id 0|1

``--platform cpu`` runs the world on the CPU over gloo.  Each rank ends
with one ``ddp_summary`` JSON line: its parameter and BatchNorm-statistic
digests, steps and training samples per second.
"""

import json
import time

import torch

from dtdl_tpu_torch.bridge import state_dict_to_flax
from dtdl_tpu_torch.ckpt import Checkpointer
from dtdl_tpu_torch.examples.common import (bootstrap, build_mesh_from_args,
                                            cifar_loaders, sgd_steplr)
from dtdl_tpu_torch.metrics.report import JsonlSink, Reporter, StdoutSink
from dtdl_tpu_torch.models import pyramidnet
from dtdl_tpu_torch.parallel import DataParallel
from dtdl_tpu_torch.parallel.collectives import tree_digest
from dtdl_tpu_torch.runtime import is_leader, process_count, process_index
from dtdl_tpu_torch.train.loop import evaluate, train_epoch
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_eval_step, make_train_step
from dtdl_tpu_torch.utils.config import (add_ckpt_flags, add_data_flags,
                                         add_topology_flags, add_train_flags,
                                         flag, make_parser)
from dtdl_tpu_torch.utils.random import seed_everything


def main(argv=None):
    parser = make_parser("dtdl_tpu_torch: multi-process allreduce DDP "
                         "CIFAR-10")
    add_train_flags(parser, batch_size=64, lr=0.1, epochs=20)
    add_data_flags(parser, dataset="cifar10")
    add_ckpt_flags(parser)
    add_topology_flags(parser)
    flag(parser, "--dist-backend", default="",
         choices=["", "nccl", "gloo"],
         help="collective backend; empty follows the device (nccl on the "
              "card, gloo on the CPU)")
    flag(parser, "--dtype", default="bfloat16",
         choices=["float32", "bfloat16"])
    args = parser.parse_args(argv)

    device = bootstrap(args)
    seed_everything(args.seed)
    strategy = DataParallel(build_mesh_from_args(args))
    if is_leader():
        print(f"DDP over {strategy.num_replicas} replicas on "
              f"{process_count()} process(es); global batch "
              f"{args.batch_size} -> "
              f"{strategy.per_replica_batch(args.batch_size)}/replica",
              flush=True)

    train_loader, val_loader = cifar_loaders(args, args.seed, device)
    tx, _ = sgd_steplr(args.lr, args.momentum, args.weight_decay,
                       len(train_loader))
    model = pyramidnet(dtype=getattr(torch, args.dtype), device=device,
                       seed=None)
    state = strategy.replicate(init_state(model, args.seed, tx,
                                          device=device))

    step = make_train_step(strategy)
    eval_step = make_eval_step(strategy)
    sinks = [StdoutSink(prefix=f"[p{process_index()}]")]
    if is_leader():
        sinks.append(JsonlSink(f"{args.out}/log.jsonl"))
    train_s = 0.0
    with Reporter(sinks) as reporter:
        for epoch in range(args.epochs):
            t0 = time.perf_counter()
            state, _ = train_epoch(step, state, train_loader, strategy,
                                   reporter=reporter, epoch=epoch,
                                   log_interval=args.log_interval)
            train_s += time.perf_counter() - t0
            evaluate(eval_step, state, val_loader, strategy,
                     reporter=reporter, epoch=epoch)
    params = state_dict_to_flax(model)
    if args.save_model:
        path = Checkpointer(args.out).save_final(params)
        if is_leader():
            print(f"leader saved weights to {path}", flush=True)
    stats = state.batch_stats
    print("ddp_summary " + json.dumps({
        "rank": process_index(), "world": process_count(),
        "params_digest": tree_digest(params),
        "batch_stats_digest": tree_digest(stats),
        "steps": state.step, "train_s": train_s,
        "samples_per_s": state.step * args.batch_size / train_s}),
        flush=True)


if __name__ == "__main__":
    main()
