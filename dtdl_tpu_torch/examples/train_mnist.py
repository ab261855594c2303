#!/usr/bin/env python
"""MNIST MLP with the Trainer+extensions API (one device) — the twin of
examples/train_mnist.py.

MLP-1000, Adam, a Trainer with Evaluator / dump_graph / snapshot /
LogReport / PrintReport extensions, ``--resume`` from a snapshot.  The
reference's flag names; ``--gpu`` is accepted (the card is the default
device, ``--platform cpu`` the CPU).

    python -m dtdl_tpu_torch.examples.train_mnist -b 100 -e 3 -u 1000 -o result
    python -m dtdl_tpu_torch.examples.train_mnist --resume result/snapshot_1800 -e 5
"""

from dtdl_tpu_torch.examples.common import (add_device_flags, bootstrap,
                                            device_kind, mnist_arrays,
                                            per_process_loader)
from dtdl_tpu_torch.models import MLP
from dtdl_tpu_torch.parallel import SingleDevice
from dtdl_tpu_torch.train import (Evaluator, LogReport, PrintReport, Trainer,
                                  dump_graph, init_state, make_eval_step,
                                  make_train_step, snapshot)
from dtdl_tpu_torch.train.optim import adam
from dtdl_tpu_torch.utils.config import add_data_flags, flag, make_parser
from dtdl_tpu_torch.utils.random import seed_everything


def add_chainer_flags(parser, batchsize=100):
    """The reference's flag surface (chainer/train_mnist.py)."""
    flag(parser, "--batchsize", "-b", type=int, default=batchsize)
    flag(parser, "--epoch", "-e", type=int, default=20)
    flag(parser, "--frequency", "-f", type=int, default=-1,
         help="snapshot frequency in epochs (-1 = once, at the end)")
    flag(parser, "--out", "-o", default="result")
    flag(parser, "--resume", "-r", default="")
    flag(parser, "--unit", "-u", type=int, default=1000)
    flag(parser, "--seed", type=int, default=0)


def build_trainer(args, strategy, device):
    seed_everything(args.seed)
    (x, y), (vx, vy) = mnist_arrays(args, flatten=True)
    train_loader = per_process_loader(x, y, args.batchsize, shuffle=True,
                                      seed=args.seed, device=device)
    val_loader = per_process_loader(vx, vy, args.batchsize, shuffle=False,
                                    seed=args.seed, drop_last=False,
                                    device=device)
    state = strategy.replicate(init_state(
        MLP(n_units=args.unit, device=device, seed=None), args.seed,
        adam(1e-3), device=device))
    trainer = Trainer(state, make_train_step(strategy), train_loader,
                      strategy, stop_trigger=(args.epoch, "epoch"),
                      out=args.out)
    log = LogReport()
    trainer.extend(Evaluator(make_eval_step(strategy), val_loader, strategy))
    trainer.extend(dump_graph({"image": x[: args.batchsize],
                               "label": y[: args.batchsize]}))
    freq = args.epoch if args.frequency == -1 else max(1, args.frequency)
    trainer.extend(snapshot(), trigger=(freq, "epoch"))
    trainer.extend(log)
    trainer.extend(PrintReport(
        ["epoch", "iteration", "loss", "accuracy",
         "val_loss", "val_accuracy", "elapsed_time"], log))
    return trainer


def main(argv=None):
    parser = make_parser("dtdl_tpu_torch: Trainer-style MNIST MLP")
    add_chainer_flags(parser)
    add_data_flags(parser, dataset="mnist")
    add_device_flags(parser)
    flag(parser, "--gpu", "-g", type=int, default=-1,
         help="accepted for parity; the card is the default device")
    args = parser.parse_args(argv)
    device = bootstrap(args)

    print("=============================================")
    print(f"# device: {device_kind(device)}")
    print(f"# number of units: {args.unit}")
    print(f"# minibatch-size: {args.batchsize}")
    print(f"# epoch: {args.epoch}")
    print("=============================================", flush=True)

    trainer = build_trainer(args, SingleDevice(), device)
    if args.resume:
        trainer.resume(args.resume)
    trainer.run()


if __name__ == "__main__":
    main()
