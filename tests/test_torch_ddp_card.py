"""Data-parallel training on the card: an NCCL world of one process and
two gloo processes sharing one card.

These need the card: they carry the ``cuda`` marker and skip, with the
reason, where no CUDA device is visible.  On the card: ``python -m
pytest tests/test_torch_ddp_card.py -m cuda``.  Each test spawns its
ranks through ``dtdl_tpu_torch.launch.local``, running this file as
``__main__`` (the worker below).

1. NCCL, world 1: the ``small`` LM in bf16 (f32 weights, K1-K3 on the
   path), three adamw steps under ``DataParallel`` from the same seed and
   batches as three single-device steps: every parameter bitwise equal
   (the mean-allreduce of one replica and the loss scale change nothing).
2. gloo, two ranks on one card, f32, TF32 off: the MLP, three sgd steps
   with momentum on each rank's half of the global batch, against the
   single-device step on the global batch within rtol 1e-4, atol 1e-5
   (``tests/test_torch_ddp.py``'s tolerance), and the two ranks'
   parameters bitwise equal.
"""

import argparse
import json
import os
import socket
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from dtdl_tpu_torch.bridge import flatten, state_dict_to_flax  # noqa: E402
from dtdl_tpu_torch.launch.local import launch_local  # noqa: E402

pytestmark = pytest.mark.cuda

STEPS = 3


def _train(kind, strategy, batches, rank):
    from dtdl_tpu_torch.models import MLP, transformer_lm
    from dtdl_tpu_torch.train.optim import adamw, sgd
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_lm_train_step, make_train_step
    if kind == "lm":
        model = transformer_lm("small", max_seq=256, seed=0)
        tx, make = adamw(3e-4), make_lm_train_step
    else:
        model = MLP(seed=0)
        tx, make = sgd(0.1, momentum=0.9), make_train_step
    state = init_state(model, None, tx)
    if strategy is not None:
        state = strategy.replicate(state)
    step = make(strategy)
    for batch in batches:
        if strategy is not None and strategy.num_replicas > 1:
            n = len(next(iter(batch.values()))) // strategy.num_replicas
            batch = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
        state, _ = step(state, batch)
    return flatten(state_dict_to_flax(model))


def worker(argv) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", required=True)
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dtdl_tpu_torch.parallel import DataParallel
    from dtdl_tpu_torch.parallel.collectives import tree_digest
    from dtdl_tpu_torch.runtime import build_mesh, initialize, process_index
    initialize(a.coordinator, a.num_processes, a.process_id,
               backend="nccl" if a.mode == "nccl" else "gloo", timeout_s=120)
    rank = process_index()
    dp = DataParallel(build_mesh())
    rng = np.random.default_rng(0)
    out = {"rank": rank}
    if a.mode == "nccl":
        batches = [{"tokens": rng.integers(0, 8192, (4, 257))}
                   for _ in range(STEPS)]
        got = _train("lm", dp, batches, rank)
        want = _train("lm", None, batches, rank)
        out["differ"] = [k for k in want if not np.array_equal(got[k],
                                                               want[k])]
    else:
        batches = [{"image": rng.normal(size=(64, 784)).astype(np.float32),
                    "label": rng.integers(0, 10, 64)} for _ in range(STEPS)]
        got = _train("mlp", dp, batches, rank)
        out["digest"] = tree_digest(got)
        if rank == 0:
            want = _train("mlp", None, batches, rank)
            out["worst"] = max(float((np.abs(got[k] - want[k])
                                      - 1e-4 * np.abs(want[k])).max())
                               for k in want)
    print("card_result " + json.dumps(out), flush=True)


if __name__ == "__main__":
    worker(sys.argv[1:])
    sys.exit(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: data-parallel training on the card")
    return torch.device("cuda")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(mode, nproc, capfd):
    rc = launch_local([os.path.abspath(__file__), "--mode", mode],
                      nproc=nproc, port=_free_port(), timeout=600,
                      env_extra={"PYTHONPATH": REPO})
    out = capfd.readouterr().out
    assert rc == 0, out[-4000:]
    return [json.loads(line.split("card_result ", 1)[1])
            for line in out.splitlines() if "card_result " in line]


def test_nccl_world1_step_is_bitwise_the_single_device_step(cuda, capfd):
    (r,) = _launch("nccl", 1, capfd)
    assert r["differ"] == []


def test_two_gloo_ranks_on_one_card_match_the_global_batch(cuda, capfd):
    res = _launch("gloo", 2, capfd)
    assert sorted(r["rank"] for r in res) == [0, 1]
    assert res[0]["digest"] == res[1]["digest"]
    worst = next(r["worst"] for r in res if r["rank"] == 0)
    assert worst <= 1e-5
