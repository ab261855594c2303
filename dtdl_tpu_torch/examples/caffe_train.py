#!/usr/bin/env python
"""``caffe train``, the Caffe entry point, the twin of
examples/caffe_train.py: a solver prototxt names a net prototxt and the
optimization schedule (:class:`~dtdl_tpu_torch.train.solver.Solver`).

    python -m dtdl_tpu_torch.examples.caffe_train --solver examples/caffe/lenet_solver.prototxt
    # resume from the latest snapshot:
    python -m dtdl_tpu_torch.examples.caffe_train --solver ... --snapshot latest
    # caffe's -gpu all: data parallel over the launcher's world
    python -m dtdl_tpu_torch.launch.local --nproc 2 -- \\
        -m dtdl_tpu_torch.examples.caffe_train --solver ... --gpu all

A port process drives one card, so ``--gpu N`` (or a list of N cards)
needs a world of N processes and raises otherwise.  ``--platform cpu``
runs on the CPU.
"""

from dtdl_tpu_torch.examples.common import (bootstrap, mnist_arrays,
                                            per_process_loader)
from dtdl_tpu_torch.examples.data_parallel import check_device_count
from dtdl_tpu_torch.parallel import choose_strategy
from dtdl_tpu_torch.runtime import process_count
from dtdl_tpu_torch.train.solver import Solver
from dtdl_tpu_torch.utils.config import (add_data_flags, add_topology_flags,
                                         flag, make_parser)
from dtdl_tpu_torch.utils.random import seed_everything


def main(argv=None):
    parser = make_parser("dtdl_tpu_torch: caffe-style solver training")
    flag(parser, "--solver", required=True,
         help="solver prototxt (SolverParameter text format)")
    flag(parser, "--snapshot", default="",
         help="resume: 'latest' or a snapshot iteration number")
    flag(parser, "--gpu", default="",
         help="'' = single device; 'all' or a count = data parallel over "
              "the world's processes, one card each (caffe's -gpu flag)")
    flag(parser, "--out", default="",
         help="override snapshot/output directory")
    flag(parser, "--max-iter", type=int, default=0,
         help="override the solver's max_iter (0 = use prototxt value)")
    flag(parser, "-b", "--batch-size", "--batchsize", type=int, default=64,
         help="GLOBAL batch size (a data-layer concern in caffe)")
    add_data_flags(parser, dataset="mnist")
    add_topology_flags(parser)
    args = parser.parse_args(argv)
    device = bootstrap(args)

    seed_everything(0)   # the Solver seeds from the prototxt's random_seed
    if not args.gpu:
        strategy = choose_strategy("single")
    elif args.gpu == "all":
        strategy = choose_strategy("ddp")
    else:
        # caffe's -gpu 0,1 / count form
        n = len(args.gpu.split(",")) if "," in args.gpu else int(args.gpu)
        check_device_count(n, "caffe_train")
        if 0 < n < process_count():
            # the Solver's snapshots meet at barriers of the whole world,
            # which ranks outside a sub-mesh would never reach
            raise ValueError(
                f"--gpu {args.gpu}: {n} of this world's {process_count()} "
                f"processes; the Solver trains over the whole world, so "
                f"launch {n}: python -m dtdl_tpu_torch.launch.local --nproc "
                f"{n} -- -m dtdl_tpu_torch.examples.caffe_train --gpu all")
        strategy = choose_strategy("ddp")

    (x, y), (vx, vy) = mnist_arrays(args)
    train_loader = per_process_loader(x, y, args.batch_size, shuffle=True,
                                      seed=0, device=device)
    test_loader = per_process_loader(vx, vy, args.batch_size, shuffle=False,
                                     seed=0, drop_last=False, device=device)

    solver = Solver(args.solver, train_loader, test_loader,
                    strategy=strategy, out=args.out or None,
                    overrides={"max_iter": args.max_iter} if args.max_iter
                    else None, device=device)
    if args.snapshot:
        ok = solver.restore(None if args.snapshot == "latest"
                            else int(args.snapshot))
        print(f"resume: {'ok' if ok else 'no snapshot found'} "
              f"(iter {solver.iteration})", flush=True)
    final = solver.solve()
    print("final:", {k: round(v, 4) for k, v in final.items()}, flush=True)
    if solver.test_loader is not None:
        print("test:", {k: round(v, 4) for k, v in solver.test().items()},
              flush=True)
    return solver


if __name__ == "__main__":
    main()
