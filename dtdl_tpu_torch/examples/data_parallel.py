#!/usr/bin/env python
"""Data parallelism on CIFAR-10 PyramidNet, the twin of
examples/data_parallel.py (the reference's pytorch/data_parallel.py).

The JAX script is one process over the local devices.  A port process
drives one card (:mod:`dtdl_tpu_torch.runtime.mesh`), so here the
``DataParallel`` mesh is the process world: ``--gpu-nums`` 0 or 1 runs
at world 1; more cards are more processes, through the launcher and the
``distributed_data_parallel`` twin, and a larger count here raises
rather than run on fewer cards than asked.  A count between 1 and the
world's raises too: a sub-mesh is ROADMAP A11b.

    python -m dtdl_tpu_torch.examples.data_parallel --batch-size 256

``--platform cpu`` runs on the CPU.
"""

import torch

from dtdl_tpu_torch.bridge import state_dict_to_flax
from dtdl_tpu_torch.ckpt import Checkpointer
from dtdl_tpu_torch.examples.common import (add_device_flags, bootstrap,
                                            cifar_loaders, sgd_steplr)
from dtdl_tpu_torch.metrics.report import Reporter, StdoutSink
from dtdl_tpu_torch.models import pyramidnet
from dtdl_tpu_torch.parallel import DataParallel
from dtdl_tpu_torch.runtime import build_mesh, process_count
from dtdl_tpu_torch.train.loop import evaluate, train_epoch
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_eval_step, make_train_step
from dtdl_tpu_torch.utils.config import (add_ckpt_flags, add_data_flags,
                                         add_train_flags, flag, make_parser)
from dtdl_tpu_torch.utils.random import seed_everything


def check_device_count(n: int, script: str) -> None:
    """A count of cards other than 0 (the world's) or the process world
    raises: each port process drives one card, so more cards are more
    processes, and fewer than the world are a sub-mesh (ROADMAP A11b)."""
    world = process_count()
    if n > world:
        raise NotImplementedError(
            f"{n} devices asked for, and this world has {world} process(es) "
            f"of one card each; run one process per card: python -m "
            f"dtdl_tpu_torch.launch.local --nproc {n} -- -m "
            f"dtdl_tpu_torch.examples.distributed_data_parallel (the "
            f"{script} twin runs on the cards of its world)")
    if 0 < n < world:
        raise NotImplementedError(
            f"{n} devices asked for: data parallelism over {n} of this "
            f"world's {world} processes (a sub-mesh) is ROADMAP queue A11b; "
            f"launch {n} processes")


def main(argv=None):
    parser = make_parser("dtdl_tpu_torch: data-parallel CIFAR-10")
    add_train_flags(parser, batch_size=64, lr=0.1, epochs=20)
    add_data_flags(parser, dataset="cifar10")
    add_ckpt_flags(parser)
    add_device_flags(parser)
    flag(parser, "--gpu-nums", "--device-nums", type=int, default=0,
         help="devices to use (0 = the process world's); any count "
              "other than the world's, one card per process, raises")
    flag(parser, "--dtype", default="bfloat16",
         choices=["float32", "bfloat16"])
    args = parser.parse_args(argv)

    device = bootstrap(args)
    check_device_count(args.gpu_nums, "data_parallel")
    seed_everything(args.seed)
    strategy = DataParallel(build_mesh())
    print(f"DataParallel over {strategy.num_replicas} local device(s); "
          f"global batch {args.batch_size} -> "
          f"{strategy.per_replica_batch(args.batch_size)}/replica", flush=True)

    train_loader, val_loader = cifar_loaders(args, args.seed, device)
    tx, _ = sgd_steplr(args.lr, args.momentum, args.weight_decay,
                       len(train_loader))
    model = pyramidnet(dtype=getattr(torch, args.dtype), device=device,
                       seed=None)
    state = strategy.replicate(init_state(model, args.seed, tx,
                                          device=device))

    step = make_train_step(strategy)
    eval_step = make_eval_step(strategy)
    reporter = Reporter([StdoutSink()])
    for epoch in range(args.epochs):
        state, _ = train_epoch(step, state, train_loader, strategy,
                               reporter=reporter, epoch=epoch,
                               log_interval=args.log_interval)
        evaluate(eval_step, state, val_loader, strategy,
                 reporter=reporter, epoch=epoch)
    if args.save_model:
        path = Checkpointer(args.out).save_final(state_dict_to_flax(model))
        print(f"saved weights to {path}", flush=True)


if __name__ == "__main__":
    main()
