#!/usr/bin/env python
"""Data parallelism on CIFAR-10 PyramidNet, the twin of
examples/data_parallel.py (the reference's pytorch/data_parallel.py).

The JAX script is one process over the local devices.  A port process
drives one card (:mod:`dtdl_tpu_torch.runtime.mesh`), so here the
``DataParallel`` mesh is the process world: ``--gpu-nums`` 0 runs over
the whole world; more cards than the world's processes raise (more
cards are more processes, through the launcher and the
``distributed_data_parallel`` twin) rather than run on fewer cards than
asked; a count below the world's trains over its first n processes (a
sub-mesh, as the JAX script's mesh of n of its local devices), and the
others leave before the loop.

    python -m dtdl_tpu_torch.examples.data_parallel --batch-size 256

``--platform cpu`` runs on the CPU.
"""

import argparse

import torch

from dtdl_tpu_torch.bridge import state_dict_to_flax
from dtdl_tpu_torch.ckpt import Checkpointer
from dtdl_tpu_torch.examples.common import (add_device_flags, bootstrap,
                                            cifar_loaders, sgd_steplr)
from dtdl_tpu_torch.metrics.report import Reporter, StdoutSink
from dtdl_tpu_torch.models import pyramidnet
from dtdl_tpu_torch.parallel import DataParallel
from dtdl_tpu_torch.runtime import (barrier, build_mesh, process_count,
                                    process_index)
from dtdl_tpu_torch.runtime.mesh import sub_mesh
from dtdl_tpu_torch.train.loop import evaluate, train_epoch
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_eval_step, make_train_step
from dtdl_tpu_torch.utils.config import (add_ckpt_flags, add_data_flags,
                                         add_train_flags, flag, make_parser)
from dtdl_tpu_torch.utils.random import seed_everything


def check_device_count(n: int, script: str) -> None:
    """A count of cards above the process world's raises: each port
    process drives one card, so more cards are more processes.  0 (the
    world's), the world's and any count below it (a sub-mesh of the first
    n processes, :func:`device_mesh`) pass."""
    world = process_count()
    if n > world:
        raise NotImplementedError(
            f"{n} devices asked for, and this world has {world} process(es) "
            f"of one card each; run one process per card: python -m "
            f"dtdl_tpu_torch.launch.local --nproc {n} -- -m "
            f"dtdl_tpu_torch.examples.distributed_data_parallel (the "
            f"{script} twin runs on the cards of its world)")


def device_mesh(n: int, script: str):
    """The data-parallel mesh of ``--gpu-nums n`` (checked by
    :func:`check_device_count`): the world for 0 or the world's count,
    else the first n processes; ``None`` on a process outside it (it
    sits this run out).  Every process must call it (making a group is
    collective over the world)."""
    check_device_count(n, script)
    if n == 0 or n == process_count():
        return build_mesh()
    return sub_mesh(range(n))


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
    # the launcher's rendezvous (python -m dtdl_tpu_torch.launch.local
    # --nproc N -- -m dtdl_tpu_torch.examples.data_parallel ...)
    for name, kind, default in (("--coordinator", str, ""),
                                ("--num-processes", int, 1),
                                ("--process-id", int, 0)):
        parser.add_argument(name, type=kind, default=default,
                            help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    device = bootstrap(args)
    mesh = device_mesh(args.gpu_nums, "data_parallel")
    if mesh is None:
        # outside the sub-mesh: meet the world's leader-gated steps (the
        # dataset's, the weights write's) and leave before the loop
        print(f"process {process_index()} sits out: --gpu-nums "
              f"{args.gpu_nums} trains over the first {args.gpu_nums} of "
              f"{process_count()}", flush=True)
        cifar_loaders(args, args.seed, device)
        if args.save_model:
            Checkpointer(args.out)
            barrier("save_weights")
        return
    seed_everything(args.seed)
    strategy = DataParallel(mesh)
    print(f"DataParallel over {strategy.num_replicas} local device(s); "
          f"global batch {args.batch_size} -> "
          f"{strategy.per_replica_batch(args.batch_size)}/replica", flush=True)

    train_loader, val_loader = cifar_loaders(args, args.seed, device,
                                             mesh=mesh)
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
