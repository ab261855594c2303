#!/usr/bin/env python
"""Single-device CIFAR-10 PyramidNet training, the twin of
examples/single_device.py (the reference's pytorch/single_gpu.py): one
device, the epoch loop with per-batch loss/accuracy/batch-time lines
every ``--log-interval`` steps, an evaluate per epoch, the final weights.

    python -m dtdl_tpu_torch.examples.single_device --batch-size 64 --lr 0.1 --epochs 2

``--platform cpu`` runs on the CPU.
"""

import torch

from dtdl_tpu_torch.bridge import state_dict_to_flax
from dtdl_tpu_torch.ckpt import save_weights
from dtdl_tpu_torch.examples.common import (add_device_flags, bootstrap,
                                            cifar_loaders, sgd_steplr)
from dtdl_tpu_torch.metrics.report import Reporter, StdoutSink
from dtdl_tpu_torch.models import pyramidnet
from dtdl_tpu_torch.parallel import SingleDevice
from dtdl_tpu_torch.train.loop import evaluate, train_epoch
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_eval_step, make_train_step
from dtdl_tpu_torch.utils.config import (add_ckpt_flags, add_data_flags,
                                         add_train_flags, flag, make_parser)
from dtdl_tpu_torch.utils.random import seed_everything


def main(argv=None):
    parser = make_parser("dtdl_tpu_torch: single-device CIFAR-10 PyramidNet")
    add_train_flags(parser, batch_size=64, lr=0.1, epochs=20)
    add_data_flags(parser, dataset="cifar10")
    add_ckpt_flags(parser)
    add_device_flags(parser)
    flag(parser, "--gpu-nums", type=int, default=1,
         help="accepted for parity with the reference; must be 1 here")
    flag(parser, "--dtype", default="bfloat16",
         choices=["float32", "bfloat16"])
    args = parser.parse_args(argv)
    if args.gpu_nums != 1:
        # the reference's guard: single_gpu.py refuses gpu_nums != 1
        raise SystemExit("single_device trains on exactly one device; use "
                         "data_parallel / distributed_data_parallel")

    device = bootstrap(args)
    seed_everything(args.seed)
    strategy = SingleDevice()
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
        path = save_weights(f"{args.out}/pyramidnet_final.msgpack",
                            state_dict_to_flax(model))
        print(f"saved weights to {path}", flush=True)


if __name__ == "__main__":
    main()
