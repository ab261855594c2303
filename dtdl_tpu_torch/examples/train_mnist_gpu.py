#!/usr/bin/env python
"""MNIST MLP on the local devices, Trainer API (ParallelUpdater parity) —
the twin of examples/train_mnist_gpu.py.

Chainer's ``ParallelUpdater`` with a ``{'main': 0, 'second': 1}`` device
map becomes a ``DataParallel`` strategy over the local mesh (one replica
per port process; more cards are more processes, train_mnist_multi).

    python -m dtdl_tpu_torch.examples.train_mnist_gpu -b 400 -e 3
"""

from dtdl_tpu_torch.examples.common import add_device_flags, bootstrap
from dtdl_tpu_torch.examples.train_mnist import (add_chainer_flags,
                                                 build_trainer)
from dtdl_tpu_torch.parallel import data_parallel_local
from dtdl_tpu_torch.utils.config import add_data_flags, flag, make_parser


def main(argv=None):
    parser = make_parser("dtdl_tpu_torch: Trainer-style MNIST MLP, local DP")
    add_chainer_flags(parser, batchsize=400)
    add_data_flags(parser, dataset="mnist")
    add_device_flags(parser)
    flag(parser, "--gpu0", type=int, default=0,
         help="accepted for parity (the reference's device map); the mesh "
              "covers this process's device")
    flag(parser, "--gpu1", type=int, default=1, help="accepted for parity")
    args = parser.parse_args(argv)
    device = bootstrap(args)
    strategy = data_parallel_local()
    print(f"ParallelUpdater-style DP over {strategy.num_replicas} local "
          f"device(s)", flush=True)
    trainer = build_trainer(args, strategy, device)
    if args.resume:
        trainer.resume(args.resume)
    trainer.run()


if __name__ == "__main__":
    main()
