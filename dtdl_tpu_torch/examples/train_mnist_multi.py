#!/usr/bin/env python
"""MNIST MLP across processes, Trainer API (ChainerMN parity) — the twin
of examples/train_mnist_multi.py.

The MPI communicator becomes the ``torch.distributed`` rendezvous (NCCL
on the card, gloo on the CPU); the multi-node optimizer's gradient
allreduce is the strategy's ``grad_sync``; rank-0 dataset load +
``scatter_dataset`` becomes deterministic per-process sharding; the
multi-node evaluator is the sum-synced eval step; logging extensions
are leader-gated.

    python -m dtdl_tpu_torch.launch.local --nproc 2 -- \\
        -m dtdl_tpu_torch.examples.train_mnist_multi -b 400 -e 2
"""

from dtdl_tpu_torch.examples.common import bootstrap, device_kind
from dtdl_tpu_torch.examples.train_mnist import (add_chainer_flags,
                                                 build_trainer)
from dtdl_tpu_torch.parallel import distributed_data_parallel
from dtdl_tpu_torch.runtime import is_leader, process_count
from dtdl_tpu_torch.utils.config import (add_data_flags, add_topology_flags,
                                         flag, make_parser)


def main(argv=None):
    parser = make_parser(
        "dtdl_tpu_torch: Trainer-style MNIST MLP, multi-process DP")
    add_chainer_flags(parser, batchsize=400)
    add_data_flags(parser, dataset="mnist")
    add_topology_flags(parser)
    flag(parser, "--communicator", type=str, default="nccl",
         help="accepted for parity (the reference picks pure_nccl/naive); "
              "the backend follows the device, or --dist-backend")
    flag(parser, "--dist-backend", default="", choices=["", "nccl", "gloo"])
    flag(parser, "--gpu", "-g", action="store_true",
         help="accepted for parity; the card is the default device")
    args = parser.parse_args(argv)
    device = bootstrap(args)   # communicator creation = rendezvous

    if is_leader():
        print("==========================================")
        print(f"Num process (COMM_WORLD): {process_count()}")
        print(f"Using {device_kind(device)} "
              f"(communicator='{args.communicator}')")
        print(f"Num unit: {args.unit}")
        print(f"Num Minibatch-size: {args.batchsize}")
        print(f"Num epoch: {args.epoch}")
        print("==========================================", flush=True)

    strategy = distributed_data_parallel()
    trainer = build_trainer(args, strategy, device)
    if args.resume:
        trainer.resume(args.resume)
    trainer.run()


if __name__ == "__main__":
    main()
