"""The serve_lm twin and the Caffe Solver's step on the card.

(1) ``python -m dtdl_tpu_torch.examples.serve_lm`` (its ``main``) serves
the ``small`` LM in f32 on the paged arena: every paged attend launches
the paged-attention kernel (K4), and the greedy tokens equal those of the
same requests through an engine that attends through the plain version
(``paged_kernel=False``).  (2) Three LeNet Solver steps (SGD, momentum,
weight decay, iter_size 1) on the card from the same weights and batches
as on the CPU, TF32 off: losses within 1e-5 relative, parameters within
1e-5.

These need the card: they carry the ``cuda`` marker and skip, with the
reason, where no CUDA device is visible.  On the card: ``python -m
pytest tests/test_torch_faces_card.py -m cuda``.
"""

import os

import numpy as np
import pytest
import torch

from dtdl_tpu_torch import bridge, kernels
from dtdl_tpu_torch.models import transformer_lm
from dtdl_tpu_torch.models.netspec import build_net
from dtdl_tpu_torch.serve import InferenceEngine, Request, Scheduler
from dtdl_tpu_torch.train.solver import make_optimizer
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_train_step
from dtdl_tpu_torch.utils import prototxt

pytestmark = pytest.mark.cuda

LENET = os.path.join(os.path.dirname(__file__), "..", "examples", "caffe",
                     "lenet_train_test.prototxt")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the serve_lm twin through the "
                    "paged-attention kernel, the Solver step on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_serve_lm_twin_through_k4_is_greedy_identical(cuda):
    from dtdl_tpu_torch.examples import serve_lm
    kernels.reset_launches()
    reqs, summary, _ = serve_lm.main([
        "--model-size", "small", "--page-size", "16", "--n-slots", "4",
        "--n-requests", "6", "--max-new-tokens", "12",
        "--shared-prefix", "48"])
    assert kernels.LAUNCHES["paged_attention"] > 0
    assert summary["requests_finished"] == 6
    model = transformer_lm("small", attn_impl="dense", dtype=torch.float32,
                           seed=0)
    eng = InferenceEngine(model, n_slots=4, page_size=16,
                          paged_kernel=False)
    plain = [Request(list(r.prompt), r.max_new_tokens) for r in reqs]
    Scheduler(eng, harvest_lag=4).run(plain)
    assert [r.tokens for r in reqs] == [r.tokens for r in plain]


def test_solver_lenet_step_on_the_card_matches_the_cpu(cuda):
    sp = prototxt.parse('base_lr: 0.01 lr_policy: "inv" gamma: 0.05 '
                        'power: 0.75 momentum: 0.9 weight_decay: 0.0005 '
                        'type: "SGD"')
    cpu_net = build_net(LENET, input_shape=(28, 28, 1), device="cpu", seed=3)
    card_net = bridge.load_flax_params(
        build_net(LENET, input_shape=(28, 28, 1), device=cuda, seed=None),
        bridge.state_dict_to_flax(cpu_net), device=cuda)
    rng = np.random.default_rng(0)
    batches = [{"image": rng.uniform(size=(16, 28, 28, 1)).astype(
        np.float32), "label": rng.integers(0, 10, 16).astype(np.int32)}
        for _ in range(3)]
    step = make_train_step()
    runs = []
    for net, dev in ((cpu_net, "cpu"), (card_net, cuda)):
        state = init_state(net, None, make_optimizer(sp), device=dev)
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        runs.append((losses, bridge.flatten(bridge.state_dict_to_flax(net))))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5)
    for k, v in runs[0][1].items():
        np.testing.assert_allclose(runs[1][1][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)
