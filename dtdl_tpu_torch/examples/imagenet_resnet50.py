#!/usr/bin/env python
"""ResNet-50 data-parallel training, the throughput workload, the twin
of examples/imagenet_resnet50.py (``BASELINE.json``'s "ResNet-50/ImageNet
PyTorch DDP").

ResNet-50 v1.5 in bf16 compute (f32 weights and BatchNorm statistics),
``choose_strategy("auto")`` (DDP over the launcher's world, else one
card), per-process data stripes, Nesterov SGD at 0.9 with weight decay
1e-4 in front and a linear warm-up into a cosine decay, samples/s and
ms/step every ``--log-interval`` steps, and a closing accuracy over the
first global batch of the training pool.  ImageNet is not shipped: a
deterministic learnable synthetic pool (``class_pattern_images``) stands
in at full 224x224x3, made once per process.

    python -m dtdl_tpu_torch.examples.imagenet_resnet50 --batch-size 256 --steps 100
    python -m dtdl_tpu_torch.launch.local --nproc 2 -- \\
        -m dtdl_tpu_torch.examples.imagenet_resnet50 --batch-size 512

``--platform cpu`` runs on the CPU.
"""

import time

import torch

from dtdl_tpu_torch.data.synthetic import class_pattern_images
from dtdl_tpu_torch.examples.common import bootstrap, per_process_loader
from dtdl_tpu_torch.models import resnet50
from dtdl_tpu_torch.parallel import choose_strategy
from dtdl_tpu_torch.runtime import process_count, process_index
from dtdl_tpu_torch.train.optim import (add_decayed_weights, sgd,
                                        warmup_cosine_decay_schedule)
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_eval_step, make_train_step
from dtdl_tpu_torch.utils.config import (add_data_flags, add_topology_flags,
                                         flag, make_parser)
from dtdl_tpu_torch.utils.random import seed_everything


def main(argv=None):
    parser = make_parser("dtdl_tpu_torch: ResNet-50 DDP throughput workload")
    flag(parser, "-b", "--batch-size", type=int, default=256,
         help="GLOBAL batch size")
    flag(parser, "--steps", type=int, default=100)
    flag(parser, "--lr", type=float, default=0.1,
         help="base lr at batch 256 (scaled linearly with batch size)")
    flag(parser, "--warmup-steps", type=int, default=20)
    flag(parser, "--image-size", type=int, default=224)
    flag(parser, "--num-classes", type=int, default=1000)
    flag(parser, "--train-examples", type=int, default=4096,
         help="synthetic training pool size")
    flag(parser, "--log-interval", type=int, default=20)
    flag(parser, "--dtype", default="bfloat16",
         choices=["bfloat16", "float32"])
    flag(parser, "--s2d-stem", action="store_true",
         help="space-to-depth stem (renames the stem param path, so "
              "snapshots are not interchangeable with the standard-stem "
              "tree)")
    flag(parser, "--seed", type=int, default=0)
    add_data_flags(parser, dataset="synthetic")
    add_topology_flags(parser)
    args = parser.parse_args(argv)
    device = bootstrap(args)

    seed_everything(args.seed)
    strategy = choose_strategy("auto")
    n_chips = process_count()

    model = resnet50(num_classes=args.num_classes,
                     dtype=getattr(torch, args.dtype),
                     s2d_stem=args.s2d_stem, device=device, seed=None)
    base = args.lr * args.batch_size / 256  # linear scaling rule
    schedule = warmup_cosine_decay_schedule(
        0.0, base, args.warmup_steps, max(args.steps, args.warmup_steps + 1))
    tx = add_decayed_weights(1e-4, sgd(schedule, momentum=0.9,
                                       nesterov=True))
    state = strategy.replicate(init_state(model, args.seed, tx,
                                          device=device))
    train_step = make_train_step(strategy)

    x, y = class_pattern_images(args.train_examples,
                                (args.image_size, args.image_size, 3),
                                args.num_classes, seed=args.seed, noise=0.3)
    loader = per_process_loader(x, y, args.batch_size, shuffle=True,
                                seed=args.seed, device=device)

    step_i, t0, logged = 0, time.perf_counter(), 0
    epoch = 0
    while step_i < args.steps:
        loader.set_epoch(epoch)
        for batch in iter(loader):
            if step_i >= args.steps:
                break
            batch = strategy.shard_batch(batch)
            state, metrics = train_step(state, batch)
            step_i += 1
            if step_i % args.log_interval == 0 or step_i == args.steps:
                loss = float(metrics["loss"])   # waits for the card
                dt = time.perf_counter() - t0
                done = step_i - logged
                sps = args.batch_size * done / dt
                print(f"step {step_i}/{args.steps} "
                      f"loss {loss:.4f} "
                      f"acc {float(metrics['accuracy']):.4f} "
                      f"| {sps:,.0f} samples/sec "
                      f"({sps / n_chips:,.0f}/chip, {n_chips} chips) "
                      f"| {dt / done * 1e3:.1f} ms/step", flush=True)
                t0, logged = time.perf_counter(), step_i
        epoch += 1

    # sanity eval on the training pool's first global batch (synthetic
    # data is learnable), each process its stripe, the sums synced
    eval_step = make_eval_step(strategy)
    rows = args.batch_size // n_chips
    lo = process_index() * rows
    em = eval_step(state, strategy.shard_batch(
        {"image": x[lo:lo + rows], "label": y[lo:lo + rows]}))
    print(f"final: train-pool acc "
          f"{float(em['correct_sum']) / float(em['count']):.4f}", flush=True)


if __name__ == "__main__":
    main()
