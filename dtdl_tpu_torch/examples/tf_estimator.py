#!/usr/bin/env python
"""MNIST with the Estimator API, the TF1 entry point, the twin of
examples/tf_estimator.py: ``model_fn`` / ``input_fn`` / ``RunConfig`` /
``train_and_evaluate``, then ``predict`` on five examples.  Flag
spellings follow TF1 (underscores: --model_dir, --train_steps), both
spellings accepted.

    python -m dtdl_tpu_torch.examples.tf_estimator --train_steps 600 --model_dir ./est
    # resumable by construction: rerun the same command to continue

``--platform cpu`` runs on the CPU.
"""

import itertools

import torch

from dtdl_tpu_torch.examples.common import (bootstrap, mnist_arrays,
                                            per_process_loader)
from dtdl_tpu_torch.models import MnistCNN
from dtdl_tpu_torch.parallel import choose_strategy
from dtdl_tpu_torch.train import (Estimator, EstimatorSpec, EvalSpec,
                                  ModeKeys, RunConfig, TrainSpec,
                                  train_and_evaluate)
from dtdl_tpu_torch.train.optim import adam
from dtdl_tpu_torch.utils.config import (add_data_flags, add_topology_flags,
                                         flag, make_parser)


def make_model_fn(device):
    def model_fn(mode, params):
        """Per-mode spec: the same CNN for all modes; the optimizer only
        for TRAIN."""
        model = MnistCNN(dtype=torch.bfloat16 if params.get("bf16")
                         else torch.float32, device=device, seed=None)
        tx = adam(params.get("learning_rate", 1e-3)) \
            if mode == ModeKeys.TRAIN else None
        return EstimatorSpec(mode=mode, model=model, tx=tx)
    return model_fn


def main(argv=None):
    parser = make_parser("dtdl_tpu_torch: TF1 Estimator-style MNIST")
    flag(parser, "--model_dir", default="./estimator_model")
    flag(parser, "--train_steps", type=int, default=600)
    flag(parser, "--eval_steps", type=int, default=0,
         help="eval batches per evaluation (0 = full test set)")
    flag(parser, "--batch_size", type=int, default=128)
    flag(parser, "--learning_rate", type=float, default=1e-3)
    flag(parser, "--save_checkpoints_steps", type=int, default=200)
    flag(parser, "--strategy", default="single",
         choices=["single", "dp", "ddp", "auto"])
    add_data_flags(parser, dataset="mnist")
    add_topology_flags(parser)
    args = parser.parse_args(argv)
    device = bootstrap(args)

    (x, y), (vx, vy) = mnist_arrays(args)

    def train_input_fn():
        return per_process_loader(x, y, args.batch_size, shuffle=True,
                                  seed=0, device=device)

    def eval_input_fn():
        return per_process_loader(vx, vy, args.batch_size, shuffle=False,
                                  seed=0, drop_last=False, device=device)

    estimator = Estimator(
        make_model_fn(device), model_dir=args.model_dir,
        config=RunConfig(save_checkpoints_steps=args.save_checkpoints_steps,
                         log_step_count_steps=100),
        params={"learning_rate": args.learning_rate},
        strategy=choose_strategy(args.strategy), device=device)
    result = train_and_evaluate(
        estimator,
        TrainSpec(train_input_fn, max_steps=args.train_steps),
        EvalSpec(eval_input_fn, steps=args.eval_steps or None))
    print("final eval:", {k: round(float(v), 4) for k, v in result.items()},
          flush=True)

    # predict a few examples (TF1's predict generator shape)
    preds = list(itertools.islice(estimator.predict(eval_input_fn), 5))
    print("predictions:", [p["class_ids"] for p in preds],
          "labels:", list(vy[:5]), flush=True)


if __name__ == "__main__":
    main()
