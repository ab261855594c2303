"""Snapshot and resume on the card: the ``tiny`` LM (f32 weights, flash
attention, so K1, K2 and K3 run every step) under a ``Trainer``, 5
iterations uninterrupted against 2, a snapshot, and a fresh
``Trainer`` + ``Checkpointer`` that resumes mid-epoch and runs to 5:
params, Adam moments and step bitwise equal (K1-K3 use no atomics).  A
step issued right after ``save()`` does not change the snapshot (the
copy to pinned host memory is ordered before it on the stream).

These need the card: they carry the ``cuda`` marker and skip, with the
reason, where no CUDA device is visible.  On the card: ``python -m
pytest tests/test_torch_resume_card.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from dtdl_tpu_torch import kernels
from dtdl_tpu_torch.bridge import flatten
from dtdl_tpu_torch.ckpt import Checkpointer
from dtdl_tpu_torch.data.loader import DataLoader
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.parallel import SingleDevice
from dtdl_tpu_torch.train import Trainer, init_state, snapshot
from dtdl_tpu_torch.train.optim import adamw
from dtdl_tpu_torch.train.state import state_to_tree
from dtdl_tpu_torch.train.step import make_lm_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: snapshot and resume on the card")
    return torch.device("cuda")


def trainer(out, stop, snap=None):
    tokens = np.random.default_rng(4).integers(0, 256, (12, 129)).astype(
        np.int32)
    model = transformer_lm("tiny", max_seq=128, seed=3,
                           dtype=torch.bfloat16)
    tr = Trainer(init_state(model, None, adamw(3e-3)), make_lm_train_step(),
                 DataLoader({"tokens": tokens}, 4, seed=1), SingleDevice(),
                 stop_trigger=(stop, "iteration"), out=str(out))
    if snap:
        tr.extend(snapshot(), trigger=(snap, "iteration"))
    return tr


def same(a, b):
    fa, fb = flatten(state_to_tree(a)), flatten(state_to_tree(b))
    assert fa.keys() == fb.keys()
    return [k for k in fa if not (torch.equal(fa[k], fb[k])
                                  if isinstance(fa[k], torch.Tensor)
                                  else fa[k] == fb[k])]


def test_tiny_lm_resume_on_the_card_is_bitwise(cuda, tmp_path):
    kernels.reset_launches()
    ref = trainer(tmp_path / "a", 5)
    ref.run()
    n_layers = ref.state.model.cfg.n_layers
    assert kernels.LAUNCHES["flash_fwd"] == 5 * n_layers
    assert kernels.LAUNCHES["flash_bwd_dkv"] == 5 * n_layers
    trainer(tmp_path / "b", 2, snap=2).run()
    resumed = trainer(tmp_path / "b", 5)
    assert resumed.resume() and resumed._skip_batches == 2
    resumed.run()
    assert same(ref.state, resumed.state) == []


def test_a_step_after_save_does_not_change_the_snapshot(cuda, tmp_path):
    tr = trainer(tmp_path / "c", 1)
    tr.run()
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten(state_to_tree(tr.state)).items()}
    ck = Checkpointer(str(tmp_path / "hazard"))
    ck.save(1, tr.state)
    batch = {"tokens": torch.randint(0, 256, (4, 129), device=cuda)}
    make_lm_train_step()(tr.state, batch)      # at once, before the write
    ck.wait_until_finished()
    fresh = trainer(tmp_path / "d", 1)
    got, step = Checkpointer(str(tmp_path / "hazard")).restore(fresh.state)
    assert step == 1
    for k, v in flatten(state_to_tree(got)).items():
        assert (torch.equal(v.cpu(), want[k].cpu())
                if isinstance(v, torch.Tensor) else v == want[k]), k
