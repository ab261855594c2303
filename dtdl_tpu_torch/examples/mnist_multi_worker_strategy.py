#!/usr/bin/env python
"""MNIST CNN across multiple workers, fit() API — the twin of
examples/mnist_multi_worker_strategy.py.

``MultiWorkerMirroredStrategy`` + TF_CONFIG become a world ``DataParallel``
strategy over the ``torch.distributed`` rendezvous.  The reference's
cluster flags are kept: ``--worker_hosts h1:p,h2:p --task_index i``
derive the coordinator (first host) and process id; ``--job_name Ps`` is
accepted and routed to collective data parallelism.

    python -m dtdl_tpu_torch.launch.local --nproc 2 -- \\
        -m dtdl_tpu_torch.examples.mnist_multi_worker_strategy --epochs 2
"""

from dtdl_tpu_torch.examples.common import add_device_flags, bootstrap
from dtdl_tpu_torch.examples.mnist_single import add_tf2_flags, run
from dtdl_tpu_torch.parallel import distributed_data_parallel
from dtdl_tpu_torch.runtime import is_leader
from dtdl_tpu_torch.utils.config import add_data_flags, flag, make_parser


def main(argv=None):
    parser = make_parser(
        "dtdl_tpu_torch: Keras-style MNIST CNN (multi-worker collective DP)")
    add_tf2_flags(parser)
    add_data_flags(parser, dataset="mnist")
    add_device_flags(parser)
    flag(parser, "--worker_hosts", "-wh", type=str, default="",
         help="Comma-separated list of hostname:port pairs")
    flag(parser, "--job_name", "-j", type=str, default="worker",
         help="Ps or worker (Ps is routed to collective DP)")
    flag(parser, "--task_index", "-i", type=int, default=0)
    # also accept the generic topology spelling used by the launcher
    flag(parser, "--coordinator", type=str, default="")
    flag(parser, "--num-processes", type=int, default=0)
    flag(parser, "--process-id", type=int, default=-1)
    args = parser.parse_args(argv)

    if args.job_name.lower() == "ps":
        print("parameter-server mode is not supported; continuing with "
              "collective data parallelism (the reference rejects PS "
              "outright)", flush=True)
    if args.worker_hosts:
        hosts = args.worker_hosts.split(",")
        args.coordinator = hosts[0]
        args.num_processes = len(hosts)
        args.process_id = args.task_index
    else:
        args.num_processes = args.num_processes or 1
        args.process_id = max(args.process_id, 0)
    device = bootstrap(args)
    strategy = distributed_data_parallel()
    if is_leader():
        print(f"MultiWorker DP over {strategy.num_replicas} replicas",
              flush=True)
    run(args, strategy, device)


if __name__ == "__main__":
    main()
