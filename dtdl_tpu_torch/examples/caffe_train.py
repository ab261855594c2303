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
trains data parallel over the first N processes of the world, as the JAX
script trains over the first N chips: above the world's count it raises;
below it the other processes sit the run out (they leave once the
sub-mesh's groups are made, and the Solver's snapshots meet at barriers
of the sub-mesh's processes only).  ``--platform cpu`` runs on the CPU.
"""

from dtdl_tpu_torch.examples.common import (bootstrap, mnist_arrays,
                                            per_process_loader)
from dtdl_tpu_torch.examples.data_parallel import device_mesh
from dtdl_tpu_torch.parallel import choose_strategy
from dtdl_tpu_torch.runtime import process_count, process_index
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
              "the world's processes, or its first N, one card each "
              "(caffe's -gpu flag)")
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
    (x, y), (vx, vy) = mnist_arrays(args)
    mesh = None
    if not args.gpu:
        strategy = choose_strategy("single")
    elif args.gpu == "all":
        strategy = choose_strategy("ddp")
    else:
        # caffe's -gpu 0,1 / count form: the first n processes
        n = len(args.gpu.split(",")) if "," in args.gpu else int(args.gpu)
        mesh = device_mesh(n, "caffe_train")
        if mesh is None:
            print(f"process {process_index()} sits out: --gpu {args.gpu} "
                  f"trains over the first {n} of {process_count()}",
                  flush=True)
            return None
        strategy = choose_strategy("ddp", mesh=mesh)

    train_loader = per_process_loader(x, y, args.batch_size, shuffle=True,
                                      seed=0, device=device, mesh=mesh)
    test_loader = per_process_loader(vx, vy, args.batch_size, shuffle=False,
                                     seed=0, drop_last=False, device=device,
                                     mesh=mesh)

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
