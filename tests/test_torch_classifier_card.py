"""The classifier path on the card against the same path on the CPU.

These need the card: they carry the ``cuda`` marker and skip, with the
reason, where no CUDA device is visible.  On the card: ``python -m
pytest tests/test_torch_classifier_card.py -m cuda``.

One f32 SGD step (lr 0.1, momentum 0.9, weight decay 5e-4) of a small
PyramidNet and a small ResNet from the same bridged weights and batch,
TF32 off.  Tolerances: loss within 1e-5 relative, accuracy equal, every
BatchNorm statistic within 1e-5 of its BN's scale, eval logits within
1e-5 of the largest; the parameters, whose f32 gradients differ by
cuDNN's choice of convolution algorithm and may switch at a ReLU input
within rounding of 0 (see ``chip_smoke.py`` STEP_SHARE), at least 97% of
the elements within 1e-6 + 1e-4 of their tensor's largest update and
every element within 2e-2 of it.  A bf16 step stays finite
and keeps every activation channels_last on the card.
"""

import numpy as np
import pytest
import torch

from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.models import PyramidNet, ResNet
from dtdl_tpu_torch.models.layers import Conv
from dtdl_tpu_torch.train.optim import sgd
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_train_step

CASES = {
    "pyramidnet": (lambda dev, **kw: PyramidNet(num_layers=3, alpha=48,
                                                device=dev, seed=None, **kw),
                   (8, 32, 32, 3)),
    "resnet": (lambda dev, **kw: ResNet(stage_sizes=(1, 1, 1, 1),
                                        device=dev, seed=None, **kw),
               (4, 64, 64, 3)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the classifier path on the card")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def one_step(make, params, stats, batch, dev):
    model = bridge.load_flax_params(make(dev), params, stats, device=dev)
    state = init_state(model, None, sgd(0.1, momentum=0.9,
                                        weight_decay=5e-4), device=dev)
    state, metrics = make_train_step()(state, batch)
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(batch["image"]).to(dev)).cpu()
    return ({k: float(v) for k, v in metrics.items()},
            bridge.flatten(bridge.state_dict_to_flax(model)),
            bridge.flatten(bridge.state_dict_to_flax(model, "batch_stats")),
            logits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_step_on_the_card_matches_the_cpu(cuda, name):
    make, shape = CASES[name]
    src = make("cpu").init_weights(5)
    params = bridge.state_dict_to_flax(src)
    stats = bridge.state_dict_to_flax(src, "batch_stats")
    rng = np.random.default_rng(5)
    batch = {"image": rng.normal(size=shape).astype(np.float32),
             "label": rng.integers(0, 10, shape[0]).astype(np.int32)}
    (cm, cp, cs, cl) = one_step(make, params, stats, batch, cuda)
    (pm, pp, ps, pl) = one_step(make, params, stats, batch, "cpu")
    assert abs(cm["loss"] - pm["loss"]) <= 1e-5 * abs(pm["loss"])
    assert cm["accuracy"] == pm["accuracy"]
    assert float((cl - pl).abs().max()) <= 1e-5 * float(pl.abs().max())
    for path, w in ps.items():
        var = ps[path.rsplit("/", 1)[0] + "/var"]
        scale = (np.abs(var).max() if path.endswith("var")
                 else max(np.abs(w).max(), np.sqrt(var).max()))
        assert np.abs(cs[path] - w).max() <= 1e-5 * scale, path
    before = bridge.flatten(params)
    shares = np.concatenate([
        ((np.abs(cp[p] - w) - 1e-6) / max(np.abs(w - before[p]).max(),
                                          1e-30)).ravel()
        for p, w in pp.items()])
    assert (shares > 1e-4).sum() <= 0.03 * shares.size
    assert shares.max() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_step_on_the_card_stays_channels_last(cuda, name):
    make, shape = CASES[name]
    model = make(cuda, dtype=torch.bfloat16)
    seen = []
    for m in model.modules():
        if isinstance(m, Conv):
            m.register_forward_pre_hook(lambda mod, args: seen.append(
                args[0].is_contiguous(memory_format=torch.channels_last)))
    state = init_state(model, 1, sgd(0.1, momentum=0.9), device=cuda)
    rng = np.random.default_rng(1)
    batch = {"image": rng.normal(size=shape).astype(np.float32),
             "label": rng.integers(0, 10, shape[0]).astype(np.int32)}
    for _ in range(2):
        state, metrics = make_train_step()(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert seen and all(seen)
