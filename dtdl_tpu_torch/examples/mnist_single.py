#!/usr/bin/env python
"""MNIST CNN with the Keras-style compile/fit API, single process — the
twin of examples/mnist_single.py.

Build the 3-conv CNN (bf16 compute, f32 weights), ``fit`` with
TensorBoard + per-epoch checkpoint callbacks, then restore the latest
checkpoint and evaluate.  The reference's flag names, both spellings.

    python -m dtdl_tpu_torch.examples.mnist_single --batch_size 64 --epochs 2

``--platform cpu`` runs on the CPU.
"""

import torch

from dtdl_tpu_torch.examples.common import (add_device_flags, bootstrap,
                                            mnist_arrays)
from dtdl_tpu_torch.models import MnistCNN
from dtdl_tpu_torch.parallel import SingleDevice
from dtdl_tpu_torch.train import Model, ModelCheckpoint, TensorBoard
from dtdl_tpu_torch.train.optim import sgd
from dtdl_tpu_torch.utils.config import add_data_flags, flag, make_parser
from dtdl_tpu_torch.utils.random import seed_everything


def add_tf2_flags(parser):
    """The reference's flag surface (tensorflow2/mnist_single.py)."""
    flag(parser, "--train_dir", "-td", type=str, default="./train_dir")
    flag(parser, "--batch_size", "-b", type=int, default=64)
    flag(parser, "--test_batchsize", "-tb", type=int, default=1000)
    flag(parser, "--epochs", "-e", type=int, default=10)
    flag(parser, "--gpu_nums", "-g", type=int, default=0)
    flag(parser, "--cpu_nums", "-c", type=int, default=0)
    flag(parser, "--learning_rate", "-lr", type=float, default=0.01)
    flag(parser, "--momentum", type=float, default=0.5)
    flag(parser, "--log_interval", type=int, default=10)
    flag(parser, "--save_model", "-sm", action="store_true", default=False)
    flag(parser, "--seed", type=int, default=0)


def run(args, strategy, device):
    seed_everything(args.seed)
    (x, y), (vx, vy) = mnist_arrays(args)
    model = Model(MnistCNN(dtype=torch.bfloat16, device=device, seed=None),
                  strategy)
    model.compile(optimizer=sgd(args.learning_rate, momentum=args.momentum),
                  loss="sparse_categorical_crossentropy", seed=args.seed)
    model.fit(x, y, batch_size=args.batch_size, epochs=args.epochs,
              validation_data=(vx, vy),
              callbacks=[ModelCheckpoint(args.train_dir),
                         TensorBoard(f"{args.train_dir}/logs")])
    # evaluate after restore-latest
    if not model.load_latest(args.train_dir):
        raise SystemExit(f"no epoch weights under {args.train_dir}")
    res = model.evaluate(vx, vy, batch_size=args.test_batchsize)
    print(f"Eval loss: {res['loss']}, Eval Accuracy: {res['accuracy']}",
          flush=True)
    if args.save_model:
        model.save_weights(f"{args.train_dir}/final.msgpack")


def main(argv=None):
    parser = make_parser("dtdl_tpu_torch: Keras-style MNIST CNN (single)")
    add_tf2_flags(parser)
    add_data_flags(parser, dataset="mnist")
    add_device_flags(parser)
    args = parser.parse_args(argv)
    device = bootstrap(args)
    run(args, SingleDevice(), device)


if __name__ == "__main__":
    main()
