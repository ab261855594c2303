#!/usr/bin/env python
"""MNIST CNN in the MXNet idiom, ``Module.fit`` over a KVStore, the twin
of examples/mxnet_kvstore.py::

    kv  = mx.kv.create(args.kv_store)            # 'local'|'device'|'dist_sync'
    mod = mx.mod.Module(symbol, context=ctxs)
    mod.fit(train_iter, eval_data=val_iter, optimizer='sgd',
            optimizer_params={'learning_rate': .1}, kvstore=kv,
            batch_end_callback=mx.callback.Speedometer(batch, 100),
            num_epoch=10)

The store sums gradients over the mesh's processes
(:mod:`dtdl_tpu_torch.parallel.kvstore`); ``--kv-store dist_async``
routes to the synchronous sum.

    python -m dtdl_tpu_torch.examples.mxnet_kvstore --kv-store device --batch-size 64
    python -m dtdl_tpu_torch.launch.local --nproc 2 -- \\
        -m dtdl_tpu_torch.examples.mxnet_kvstore --kv-store dist_sync

``--platform cpu`` runs on the CPU.
"""

import time

from dtdl_tpu_torch.bridge import state_dict_to_flax
from dtdl_tpu_torch.ckpt import save_weights
from dtdl_tpu_torch.data.loader import prefetch_to_device
from dtdl_tpu_torch.examples.common import (bootstrap, mnist_arrays,
                                            per_process_loader)
from dtdl_tpu_torch.metrics.report import Accumulator
from dtdl_tpu_torch.models import MnistCNN
from dtdl_tpu_torch.parallel.kvstore import create as kv_create
from dtdl_tpu_torch.parallel.kvstore import kvstore_strategy
from dtdl_tpu_torch.train.loop import evaluate
from dtdl_tpu_torch.train.optim import adam, add_decayed_weights, sgd
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_eval_step, make_train_step
from dtdl_tpu_torch.utils.config import (add_ckpt_flags, add_data_flags,
                                         add_topology_flags, flag,
                                         make_parser)
from dtdl_tpu_torch.utils.random import seed_everything


class Speedometer:
    """MXNet's batch_end_callback: a periodic samples/sec + metric line.
    Its window restarts at every epoch boundary (as MXNet's), so
    validation and epoch-summary time never enter a measurement."""

    def __init__(self, batch_size: int, frequent: int = 50):
        self.batch_size = batch_size
        self.frequent = frequent
        self._epoch = -1

    def __call__(self, epoch: int, nbatch: int, metrics: dict) -> None:
        if epoch != self._epoch:
            self._epoch = epoch
            self.tic = time.time()
            self.count = 0
        self.count += 1
        if self.count % self.frequent:
            return
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        line = "\t".join(f"{k}={v:.6f}" for k, v in metrics.items())
        print(f"Epoch[{epoch}] Batch [{nbatch}]\tSpeed: {speed:.2f} "
              f"samples/sec\t{line}", flush=True)
        self.tic = time.time()


class Module:
    """MXNet Module-flavored wrapper: symbol + strategy -> fit()."""

    def __init__(self, symbol, strategy):
        self.symbol = symbol
        self.strategy = strategy
        self.state = None

    def fit(self, train_loader, eval_loader=None, optimizer="sgd",
            optimizer_params=None, num_epoch: int = 10,
            batch_end_callback=None, seed: int = 0):
        params = dict(optimizer_params or {})
        lr = params.pop("learning_rate", 0.01)
        momentum = params.pop("momentum", 0.0)
        wd = params.pop("wd", 0.0)
        if optimizer == "sgd":
            tx = add_decayed_weights(wd, sgd(lr, momentum=momentum or None))
        elif optimizer == "adam":
            tx = adam(lr)
        else:
            raise ValueError(f"unsupported optimizer {optimizer!r}")

        seed_everything(seed)
        self.state = self.strategy.replicate(init_state(
            self.symbol, seed, tx, device=self.symbol.device))
        train_step = make_train_step(self.strategy)
        eval_step = make_eval_step(self.strategy)

        for epoch in range(num_epoch):
            train_loader.set_epoch(epoch)
            acc = Accumulator()
            tic = time.time()
            it = prefetch_to_device(iter(train_loader),
                                    self.strategy.shard_batch)
            for nbatch, batch in enumerate(it):
                self.state, metrics = train_step(self.state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                acc.add(metrics)
                if batch_end_callback is not None:
                    batch_end_callback(epoch, nbatch, metrics)
            means = acc.means()
            print(f"Epoch[{epoch}] Train-accuracy={means['accuracy']:.6f}")
            print(f"Epoch[{epoch}] Time cost={time.time() - tic:.3f}")
            if eval_loader is not None:
                val = evaluate(eval_step, self.state, eval_loader,
                               self.strategy)
                print(f"Epoch[{epoch}] Validation-accuracy="
                      f"{val['accuracy']:.6f}", flush=True)
        return self.state


def main(argv=None):
    parser = make_parser("dtdl_tpu_torch: MXNet-style Module.fit over a "
                         "KVStore")
    flag(parser, "--kv-store", type=str, default="device",
         choices=["local", "device", "dist_sync", "dist_device_sync",
                  "dist_async"])
    flag(parser, "-b", "--batch-size", type=int, default=64,
         help="GLOBAL batch size")
    flag(parser, "--lr", type=float, default=0.05)
    flag(parser, "--momentum", type=float, default=0.9)
    flag(parser, "--num-epochs", "--epochs", type=int, default=3)
    flag(parser, "--disp-batches", type=int, default=50,
         help="Speedometer frequency")
    flag(parser, "--seed", type=int, default=0)
    add_data_flags(parser, dataset="mnist")
    add_ckpt_flags(parser)
    add_topology_flags(parser)
    args = parser.parse_args(argv)
    device = bootstrap(args)

    kv = kv_create(args.kv_store)
    strategy = kvstore_strategy(kv)
    print(f"kvstore: kind={kv.kind} rank={kv.rank} "
          f"num_workers={kv.num_workers} width={kv.aggregation_width}",
          flush=True)

    (x, y), (vx, vy) = mnist_arrays(args)
    train_loader = per_process_loader(x, y, args.batch_size, shuffle=True,
                                      seed=args.seed, device=device)
    val_loader = per_process_loader(vx, vy, args.batch_size, shuffle=False,
                                    seed=args.seed, drop_last=False,
                                    device=device)

    symbol = MnistCNN(device=device, seed=None)
    mod = Module(symbol, strategy)
    mod.fit(train_loader, eval_loader=val_loader, optimizer="sgd",
            optimizer_params={"learning_rate": args.lr,
                              "momentum": args.momentum},
            num_epoch=args.num_epochs,
            batch_end_callback=Speedometer(args.batch_size,
                                           args.disp_batches),
            seed=args.seed)

    if args.save_model:
        # leader-gated, with a barrier, inside save_weights
        save_weights(f"{args.out}/mxnet_cnn.msgpack",
                     state_dict_to_flax(symbol))


if __name__ == "__main__":
    main()
