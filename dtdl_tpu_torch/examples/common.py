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
    """Rendezvous (if multi-process: the flags, or else a multi-task SLURM
    step's environment) and print the leader banner; returns
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
    topo = {"coordinator": getattr(args, "coordinator", ""),
            "num_processes": getattr(args, "num_processes", 1),
            "process_id": getattr(args, "process_id", 0)}
    if not topo["coordinator"]:
        # inside a multi-task SLURM step every script joins its world
        # with no flags
        from dtdl_tpu_torch.launch.slurm import maybe_slurm
        topo = maybe_slurm() or topo
    initialize(**topo, device=device, backend=backend)
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
                            shuffle: bool, seed: int, mesh=None):
    """(per-process batch, this process's ShardedSampler) — the one place
    the global-batch split and dataset partition are decided: over the
    world, or over ``mesh``'s processes."""
    nproc = process_count() if mesh is None else mesh.size
    index = process_index() if mesh is None else mesh.axis_index(
        mesh.axis_names)
    if global_batch % nproc:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{nproc} processes")
    sampler = ShardedSampler(n_examples, nproc, index,
                             shuffle=shuffle, seed=seed)
    return global_batch // nproc, sampler


def per_process_loader(images, labels, global_batch: int, *, shuffle: bool,
                       seed: int, transform=None, drop_last: bool = True,
                       device=None, mesh=None):
    """Loader feeding this process's stripe of the global batch (over the
    world, or over ``mesh``'s processes)."""
    batch, sampler = _host_batch_and_sampler(
        len(labels), global_batch, shuffle=shuffle, seed=seed, mesh=mesh)
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


def cifar_loaders(args, seed: int, device=None, mesh=None):
    """CIFAR-10 train/val loaders with the reference's augmentation
    (RandomCrop(32, pad 4) + flip + normalize), each process (of the
    world, or of ``mesh``) on its stripe.

    ``--num-workers N`` (N > 0) takes the train pipeline through the
    native C++ loader (augment, normalize and batch on N threads, the
    role of the reference DataLoader's ``num_workers`` processes) over
    the same :class:`ShardedSampler`, so the loader never changes which
    examples a process trains on."""
    (xtr, ytr), (xte, yte) = _limit(
        args, *load_dataset("cifar10", args.dataset_dir,
                            download=getattr(args, "download", True),
                            keep_train=getattr(args, "limit_train", 0) or None,
                            keep_test=getattr(args, "limit_test", 0) or None))
    workers = getattr(args, "num_workers", 0)
    if workers > 0:
        from dtdl_tpu_torch.data.native_loader import NativeDataLoader
        batch, sampler = _host_batch_and_sampler(
            len(ytr), args.batch_size, shuffle=True, seed=seed, mesh=mesh)
        train = NativeDataLoader.or_python(
            xtr, ytr, batch, seed=seed, augment=True,
            mean=CIFAR10_MEAN, std=CIFAR10_STD, n_threads=workers,
            sampler=sampler, device=device)
        if is_leader():
            print(f"train loader: {type(train).__name__} "
                  f"({workers} workers)", flush=True)
    else:
        train = per_process_loader(
            xtr, ytr, args.batch_size, shuffle=True, seed=seed,
            transform=cifar10_train_transform(CIFAR10_MEAN, CIFAR10_STD),
            device=device, mesh=mesh)
    val = per_process_loader(
        xte, yte, args.batch_size, shuffle=False, seed=seed,
        transform=normalize_transform(CIFAR10_MEAN, CIFAR10_STD),
        drop_last=False, device=device, mesh=mesh)
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


def demo_adapters(model, lora: str, rank: int) -> list:
    """The adapter paths of ``--lora`` (comma-separated); a path that does
    not exist yet gets a random demo adapter saved there (normal, std
    0.02, from a seed that is a stable digest of the path), as the JAX
    serving examples do."""
    import hashlib
    import os

    import numpy as np

    from dtdl_tpu_torch.ckpt.checkpoint import save_weights
    from dtdl_tpu_torch.serve.tenant import adapter_template
    paths = [p for p in lora.split(",") if p]
    for p in paths:
        if os.path.exists(p):
            continue
        seed = int.from_bytes(hashlib.blake2b(p.encode(),
                                              digest_size=4).digest(),
                              "little")
        rng = np.random.default_rng(seed)
        tpl = adapter_template(model, rank)
        save_weights(p, {b: {"attn": {n: rng.normal(0, 0.02, a.shape)
                                         .astype(np.float32)
                                         for n, a in sub["attn"].items()}}
                         for b, sub in tpl.items()})
        print(f"  --lora: saved demo adapter to {p}")
    return paths


def json_schema_dfa(model, path: str, ap):
    """``(dfa, eos)`` for ``--json-schema``: the schema file compiled over
    the byte vocabulary (token i is ``chr(i)``), EOS the last token."""
    import json

    from dtdl_tpu_torch.serve.tenant import byte_vocab, compile_json_schema
    vocab = model.cfg.vocab_size
    if vocab < 128:
        ap.error("--json-schema needs a vocab covering ASCII (>= 128); "
                 f"this model has {vocab}")
    with open(path) as f:
        schema = json.load(f)
    eos = vocab - 1
    return compile_json_schema(schema, byte_vocab(vocab), eos_id=eos), eos


def json_report(reqs, eos: int) -> tuple[int, int]:
    """``(complete, cut)`` over constrained requests with the byte
    vocabulary: how many ended in EOS with a body that parses as JSON,
    and how many finished cleanly without EOS (the token budget ran out
    mid-structure)."""
    import json
    complete = cut = 0
    for r in reqs:
        if r.error is not None:
            continue
        if not r.tokens or r.tokens[-1] != eos:
            cut += 1
            continue
        try:
            json.loads("".join(chr(t) for t in r.tokens[:-1]))
        except ValueError:
            continue
        complete += 1
    return complete, cut
