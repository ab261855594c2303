#!/usr/bin/env python
"""MNIST CNN under single-host data parallelism, fit() API — the twin of
examples/mnist_mirror_strategy.py.

``MirroredStrategy`` becomes a ``DataParallel`` strategy over the local
mesh; model build and compile happen against the strategy object.  A
port process drives one card, so the local mesh is one replica; more
cards are more processes (mnist_multi_worker_strategy).

    python -m dtdl_tpu_torch.examples.mnist_mirror_strategy --batch_size 64 --epochs 2
"""

from dtdl_tpu_torch.examples.common import add_device_flags, bootstrap
from dtdl_tpu_torch.examples.mnist_single import add_tf2_flags, run
from dtdl_tpu_torch.parallel import data_parallel_local
from dtdl_tpu_torch.utils.config import add_data_flags, make_parser


def main(argv=None):
    parser = make_parser(
        "dtdl_tpu_torch: Keras-style MNIST CNN (MirroredStrategy)")
    add_tf2_flags(parser)
    add_data_flags(parser, dataset="mnist")
    add_device_flags(parser)
    args = parser.parse_args(argv)
    device = bootstrap(args)
    strategy = data_parallel_local()
    print(f"Mirrored DP over {strategy.num_replicas} local device(s)",
          flush=True)
    run(args, strategy, device)


if __name__ == "__main__":
    main()
