"""Shared plumbing for the port's example scripts, the twin of
examples/common.py: rendezvous and banner, the mesh from the flags,
per-process CIFAR-10 loaders, the MNIST arrays and the reference's SGD +
StepLR.

Every script runs on the card unless ``--platform cpu`` asks for the
CPU; the collective backend follows (nccl, gloo), and
``--dist-backend gloo`` takes gloo on the card by name.
"""

from __future__ import annotations

from dtdl_tpu_torch.data.datasets import (CIFAR10_MEAN, CIFAR10_STD,
                                          load_dataset)
from dtdl_tpu_torch.data.loader import (DataLoader, cifar10_train_transform,
                                        normalize_transform)
from dtdl_tpu_torch.data.sharding import ShardedSampler
from dtdl_tpu_torch.runtime import (build_mesh, initialize, is_leader,
                                    process_count, process_index)
from dtdl_tpu_torch.runtime.topology import banner
from dtdl_tpu_torch.train.optim import exponential_decay, sgd
from dtdl_tpu_torch.utils.config import parse_mesh_shape


def bootstrap(args):
    """Rendezvous (if multi-process) and print the leader banner; returns
    the device every entry point of the script takes (``None``: the card
    this process was bound to; ``"cpu"``)."""
    platform = getattr(args, "platform", "")
    if platform not in ("", "cpu", "gpu", "cuda"):
        raise SystemExit(f"--platform {platform!r}: the port runs on the "
                         f"card (default) or the CPU ('cpu')")
    if getattr(args, "fake_devices", 0) > 1:
        raise SystemExit("--fake-devices: a port process drives one device; "
                         "run more processes instead (python -m "
                         "dtdl_tpu_torch.launch.local --nproc N -- ...)")
    device = "cpu" if platform == "cpu" else None
    backend = getattr(args, "dist_backend", "") or None
    initialize(getattr(args, "coordinator", ""),
               getattr(args, "num_processes", 1),
               getattr(args, "process_id", 0), device=device,
               backend=backend)
    if is_leader():
        print(banner(device), flush=True)
    return device


def build_mesh_from_args(args):
    spec = parse_mesh_shape(args)
    if spec is None:
        return build_mesh()
    shape, axes = spec
    return build_mesh(shape, axes)


def _host_batch_and_sampler(n_examples: int, global_batch: int, *,
                            shuffle: bool, seed: int):
    """(per-process batch, this process's ShardedSampler) — the one place
    the global-batch split and dataset partition are decided."""
    nproc = process_count()
    if global_batch % nproc:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{nproc} processes")
    sampler = ShardedSampler(n_examples, nproc, process_index(),
                             shuffle=shuffle, seed=seed)
    return global_batch // nproc, sampler


def per_process_loader(images, labels, global_batch: int, *, shuffle: bool,
                       seed: int, transform=None, drop_last: bool = True,
                       device=None):
    """Loader feeding this process's stripe of the global batch."""
    batch, sampler = _host_batch_and_sampler(
        len(labels), global_batch, shuffle=shuffle, seed=seed)
    return DataLoader({"image": images, "label": labels}, batch,
                      sampler=sampler, drop_last=drop_last,
                      transform=transform, device=device)


def _limit(args, train, test):
    (xtr, ytr), (xte, yte) = train, test
    for name in ("limit_train", "limit_test"):
        if getattr(args, name, 0) < 0:
            raise ValueError(f"--{name.replace('_', '-')} must be >= 0")
    if getattr(args, "limit_train", 0):
        xtr, ytr = xtr[: args.limit_train], ytr[: args.limit_train]
    if getattr(args, "limit_test", 0):
        xte, yte = xte[: args.limit_test], yte[: args.limit_test]
    return (xtr, ytr), (xte, yte)


def cifar_loaders(args, seed: int, device=None):
    """CIFAR-10 train/val loaders with the reference's augmentation
    (RandomCrop(32, pad 4) + flip + normalize), each process on its
    stripe.  ``--num-workers > 0`` (the native C++ loader) is ROADMAP
    queue A13."""
    if getattr(args, "num_workers", 0) > 0:
        raise NotImplementedError(
            "--num-workers > 0 (the native C++ loader) is ROADMAP queue A13 "
            "(operations)")
    (xtr, ytr), (xte, yte) = _limit(
        args, *load_dataset("cifar10", args.dataset_dir,
                            download=getattr(args, "download", True)))
    train = per_process_loader(
        xtr, ytr, args.batch_size, shuffle=True, seed=seed,
        transform=cifar10_train_transform(CIFAR10_MEAN, CIFAR10_STD),
        device=device)
    val = per_process_loader(
        xte, yte, args.batch_size, shuffle=False, seed=seed,
        transform=normalize_transform(CIFAR10_MEAN, CIFAR10_STD),
        drop_last=False, device=device)
    return train, val


def mnist_arrays(args, flatten: bool = False):
    return _limit(args, *load_dataset("mnist", args.dataset_dir,
                                      flatten=flatten))


def add_device_flags(parser):
    """``--platform cpu`` and ``--dist-backend`` for the scripts whose
    reference flag surface has no topology section."""
    from dtdl_tpu_torch.utils.config import flag
    flag(parser, "--platform", type=str, default="",
         help="'cpu' runs on the CPU (gloo); the default is the CUDA card "
              "(nccl)")
    flag(parser, "--dist-backend", default="", choices=["", "nccl", "gloo"],
         help="collective backend; empty follows the device")


def device_kind(device) -> str:
    """The device's name for a banner."""
    import torch
    return "cpu" if device == "cpu" else torch.cuda.get_device_name()


def sgd_steplr(lr: float, momentum: float, weight_decay: float,
               steps_per_epoch: int, step_epochs: int = 2,
               gamma: float = 0.1):
    """SGD + StepLR(step=2 epochs, gamma=0.1) — the reference DDP
    optimizer, as optax's chain(add_decayed_weights, sgd(schedule))."""
    schedule = exponential_decay(lr, step_epochs * steps_per_epoch, gamma,
                                 staircase=True)
    return sgd(schedule, momentum=momentum,
               weight_decay=weight_decay), schedule
