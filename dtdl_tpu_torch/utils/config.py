"""Shared CLI flag library, the port's copy of dtdl_tpu/utils/config.py.

The reference repeats an argparse block in every script with inconsistent
spellings across tracks (``--batch-size``, ``--batch_size``,
``-b/--batchsize``).  ``flag()`` registers dash and underscore spellings
as aliases of one destination, and the ``add_*_flags`` helpers give every
example the same surface: the same argv parses into the same
``Namespace`` as under the JAX module.  The topology section (coordinator
/ process count / mesh shape) replaces the reference's
rank/world-size/TF_CONFIG trio; in the port the coordinator is the
``torch.distributed`` rendezvous address.
"""

from __future__ import annotations

import argparse


def _spellings(name: str) -> list[str]:
    """Both '--a-b' and '--a_b' spellings for a long flag."""
    out = [name]
    if name.startswith("--"):
        body = name[2:]
        for alt in ("--" + body.replace("-", "_"), "--" + body.replace("_", "-")):
            if alt not in out and alt != name:
                out.append(alt)
    return out


def flag(parser: argparse.ArgumentParser, *names: str, **kwargs):
    """add_argument accepting both dash and underscore spellings."""
    expanded: list[str] = []
    for n in names:
        for s in _spellings(n):
            if s not in expanded:
                expanded.append(s)
    return parser.add_argument(*expanded, **kwargs)


def make_parser(description: str) -> argparse.ArgumentParser:
    return argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )


def add_train_flags(parser, batch_size=64, lr=0.1, epochs=20, momentum=0.9,
                    weight_decay=1e-4, seed=0):
    flag(parser, "-b", "--batch-size", "--batchsize", type=int,
         default=batch_size, help="GLOBAL batch size (split across replicas)")
    flag(parser, "--lr", "--learning-rate", type=float, default=lr)
    flag(parser, "-e", "--epochs", "--epoch", type=int, default=epochs)
    flag(parser, "--momentum", type=float, default=momentum)
    flag(parser, "--weight-decay", "--wd", type=float, default=weight_decay)
    flag(parser, "--seed", type=int, default=seed,
         help="root RNG seed (actually applied, unlike the reference)")
    flag(parser, "--log-interval", type=int, default=20,
         help="print metrics every N steps")


def add_data_flags(parser, dataset="mnist"):
    flag(parser, "--dataset", type=str, default=dataset,
         choices=["mnist", "cifar10", "synthetic", "synthetic_lm"])
    flag(parser, "--dataset-dir", "--dataset_dir", type=str, default="./datasets",
         help="root containing mnist/*.gz or cifar-10 batches; synthetic "
              "data is generated deterministically when files are absent")
    flag(parser, "--download", action=argparse.BooleanOptionalAction,
         default=True,
         help="fetch missing datasets (checksum-verified; the reference's "
              "download=True); --no-download or DTDL_OFFLINE=1 disables")
    # no "-j" short alias: the TF2 multi-worker example uses -j for
    # --job_name (reference tensorflow2/mnist_multi_worker_strategy.py flags)
    flag(parser, "--num-workers", type=int, default=0,
         help="native C++ pipeline worker threads for the train loader "
              "(0 = pure-Python loader; the reference's DataLoader "
              "num_workers)")
    flag(parser, "--limit-train", type=int, default=0,
         help="truncate the train set to N examples (0 = full); for smoke "
              "tests and demos")
    flag(parser, "--limit-test", type=int, default=0,
         help="truncate the test set to N examples (0 = full)")


def add_ckpt_flags(parser, out="./result"):
    flag(parser, "-o", "--out", "--model-dir", "--model_dir", type=str,
         default=out, help="output / checkpoint directory")
    flag(parser, "-r", "--resume", type=str, default="",
         help="path to a trainer snapshot to resume from")
    flag(parser, "--save-model", action=argparse.BooleanOptionalAction,
         default=True, help="save final weights (--no-save-model to skip)")


def add_topology_flags(parser):
    """Replaces --rank/--world-size/--init-method and TF_CONFIG."""
    flag(parser, "--coordinator", "--init-method", type=str, default="",
         help="coordinator address host:port for multi-process rendezvous "
              "(empty = single process)")
    flag(parser, "--num-processes", "--world-size", type=int, default=1)
    flag(parser, "--process-id", "--rank", type=int, default=0)
    flag(parser, "--mesh-shape", type=str, default="",
         help="comma-separated mesh shape, e.g. '8' or '4,2' "
              "(empty = all devices on the data axis)")
    flag(parser, "--mesh-axes", type=str, default="data",
         help="comma-separated mesh axis names matching --mesh-shape")
    # vestigial parameter-server surface, kept for parity with the reference
    # (tensorflow2/mnist_multi_worker_strategy.py:129-134 parses Ps but rejects
    # it at :15-16); we accept the flag and route PS to collective DP.
    flag(parser, "--job-name", type=str, default="worker",
         help="'worker' (PS mode is routed to collective data parallelism)")
    flag(parser, "--task-index", type=int, default=0)
    flag(parser, "--platform", type=str, default="",
         help="'cpu' runs on the CPU (gloo); the default is the CUDA card "
              "(nccl)")
    flag(parser, "--fake-devices", type=int, default=0,
         help="a JAX dry-run option; a port process drives one device, so "
              "more replicas are more processes (launch.local --nproc)")


def parse_mesh_shape(args) -> tuple[tuple[int, ...], tuple[str, ...]] | None:
    if not getattr(args, "mesh_shape", ""):
        return None
    shape = tuple(int(x) for x in args.mesh_shape.split(","))
    axes = tuple(args.mesh_axes.split(","))
    if len(axes) != len(shape):
        raise ValueError(
            f"--mesh-axes {axes} does not match --mesh-shape {shape}")
    return shape, axes
