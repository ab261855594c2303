"""The port's classifiers against the JAX package's, on the CPU.

One flax variable tree (params and, with BatchNorm, batch_stats) per
model is bridged into the port (:mod:`dtdl_tpu_torch.bridge`); the same
numpy NHWC batch then goes through the JAX ``model.apply`` and the port's
forward: ``MLP``, ``MnistCNN``, ``PyramidNet(num_layers=3, alpha=12)``
(also with ``channel_align=8``, and at 20x20, where the stages go 20 -> 10
-> 5 -> 3 through the shortcut's odd-size pad-then-pool) and
``ResNet(stage_sizes=(1, 1, 1, 1))`` (plain, and the ``s2d_stem`` tree
whose stem path is ``SpaceToDepthStem_0``).

Tolerances, f32: logits within 1e-5 of the largest |logit| in eval mode
and 3e-5 in train mode, where BatchNorm divides by the spread of a small
batch (the runs here stay below 8e-6).  The statistics after a train-mode
forward within 1e-5 of each BatchNorm's scale, which is max|var| for
``var`` and max(|mean|, sqrt(var)) for ``mean``: a BN fed by a BN sees a
batch mean that is 0 up to rounding (~1e-9 here), which no relative
bound can hold.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dtdl_tpu import models as jmodels
from dtdl_tpu_torch import bridge, models
from dtdl_tpu_torch.models.layers import Conv, Dense
from dtdl_tpu_torch.models.norm import BatchNorm

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

EVAL_TOL, TRAIN_TOL, STATS_TOL = 1e-5, 3e-5, 1e-5

# name -> (JAX model, port model (no weights), NHWC input shape)
CASES = {
    "mlp": (lambda: jmodels.MLP(n_units=32),
            lambda: models.MLP(n_units=32, device="cpu", seed=None),
            (4, 784)),
    "cnn": (lambda: jmodels.MnistCNN(),
            lambda: models.MnistCNN(device="cpu", seed=None),
            (4, 28, 28, 1)),
    "pyramidnet": (lambda: jmodels.PyramidNet(num_layers=3, alpha=12),
                   lambda: models.PyramidNet(num_layers=3, alpha=12,
                                             device="cpu", seed=None),
                   (4, 32, 32, 3)),
    "pyramidnet_20x20": (lambda: jmodels.PyramidNet(num_layers=3, alpha=12),
                         lambda: models.PyramidNet(num_layers=3, alpha=12,
                                                   device="cpu", seed=None),
                         (4, 20, 20, 3)),
    "pyramidnet_align8": (
        lambda: jmodels.PyramidNet(num_layers=3, alpha=12, channel_align=8),
        lambda: models.PyramidNet(num_layers=3, alpha=12, channel_align=8,
                                  device="cpu", seed=None),
        (4, 20, 20, 3)),
    "resnet": (lambda: jmodels.ResNet(stage_sizes=(1, 1, 1, 1),
                                      num_classes=10),
               lambda: models.ResNet(stage_sizes=(1, 1, 1, 1),
                                     num_classes=10, device="cpu", seed=None),
               (2, 64, 64, 3)),
    "resnet_s2d": (lambda: jmodels.ResNet(stage_sizes=(1, 1, 1, 1),
                                          num_classes=10, s2d_stem=True),
                   lambda: models.ResNet(stage_sizes=(1, 1, 1, 1),
                                         num_classes=10, s2d_stem=True,
                                         device="cpu", seed=None),
                   (2, 64, 64, 3)),
}


def random_tree(tm, seed: int = 1, spread: float = 1.0) -> dict:
    """Flax variables for ``tm``'s JAX twin, made on the port's side:
    seeded weights, and every BatchNorm's scale, bias, mean and var drawn
    at random about flax's init (scale and var in 1 ± spread/2, bias and
    mean ~ 0.2·spread·N(0, 1)), so a swapped or misplaced leaf changes
    the logits, as flax trees through the bridge.  (A JAX init would compile for seconds
    per model; the flax names and shapes of the JAX init are pinned by
    ``test_pyramidnet110_and_resnet50_trees_bridge_at_full_size``.)"""
    tm.init_weights(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, BatchNorm):
                n = m.scale.numel()
                m.scale.copy_(1 + spread * (torch.rand(n, generator=gen)
                                            - 0.5))
                m.bias.copy_(0.2 * spread * torch.randn(n, generator=gen))
                m.mean.copy_(0.2 * spread * torch.randn(n, generator=gen))
                m.var.copy_(1 + spread * (torch.rand(n, generator=gen)
                                          - 0.5))
    v = {"params": bridge.state_dict_to_flax(tm)}
    stats = bridge.state_dict_to_flax(tm, "batch_stats")
    if stats is not None:
        v["batch_stats"] = stats
    return v


def bridged(name, seed=1):
    """(JAX model, its variables, the port model with them loaded, an
    input batch)."""
    make_j, make_t, shape = CASES[name]
    v = random_tree(make_t(), seed)
    tm = bridge.load_flax_params(make_t(), v["params"], v.get("batch_stats"),
                                 device="cpu")
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return make_j(), v, tm, x


def stats_err(got: dict, want: dict) -> float:
    """Worst |got - want| over the BN statistics, in units of each BN's
    scale (max|var|; max(|mean|, sqrt(var)) for the mean)."""
    got, want = bridge.flatten(got), bridge.flatten(want)
    assert set(got) == set(want)
    worst = 0.0
    for path, w in want.items():
        bn = path.rsplit("/", 1)[0]
        var = want[f"{bn}/var"]
        scale = (np.abs(var).max() if path.endswith("var")
                 else max(np.abs(w).max(), np.sqrt(var).max()))
        worst = max(worst, np.abs(got[path] - w).max() / scale)
    return worst


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_forward_matches_jax(name):
    jm, v, tm, x = bridged(name)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= EVAL_TOL * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_forward_and_batch_stats_match_jax(name):
    """Train mode: BatchNorm normalizes by the batch and updates mean and
    var as flax does (biased variance, momentum 0.9)."""
    jm, v, tm, x = bridged(name)
    mutable = ["batch_stats"] if "batch_stats" in v else []
    want, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=mutable))(v, jnp.asarray(x))
    want = np.asarray(want)
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert np.abs(got.numpy() - want).max() <= TRAIN_TOL * np.abs(want).max()
    if mutable:
        got_stats = bridge.state_dict_to_flax(tm, "batch_stats")
        assert stats_err(got_stats, jax.device_get(upd["batch_stats"])) \
            <= STATS_TOL
        # and they moved: momentum 0.9 toward the batch's statistics
        assert stats_err(got_stats, v["batch_stats"]) > 100 * STATS_TOL
    else:
        assert bridge.state_dict_to_flax(tm, "batch_stats") is None


@pytest.mark.parametrize("name", ["cnn", "pyramidnet_20x20", "resnet"])
def test_every_conv_input_is_channels_last(name):
    """The activations stay channels_last through the shortcut's pads and
    pool, BN, ReLU and the residual add: no conv sees another layout, in
    either mode and in the backward."""
    _, _, tm, x = bridged(name)
    formats = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: formats.append(
            args[0].is_contiguous(memory_format=torch.channels_last)))
        for m in tm.modules() if isinstance(m, Conv)]
    grads = []
    hooks += [m.register_full_backward_hook(
        lambda mod, gin, gout: grads.append(
            gout[0].is_contiguous(memory_format=torch.channels_last)))
        for m in tm.modules() if isinstance(m, Conv)]
    n_convs = len(hooks) // 2
    for train in (False, True):
        tm.train(train)
        tm(torch.from_numpy(x).requires_grad_()).sum().backward()
    for h in hooks:
        h.remove()
    assert len(formats) == 2 * n_convs and all(formats)
    assert len(grads) == 2 * n_convs and all(grads)
    # the weights, and their grads, are channels_last too
    assert all(m.weight.is_contiguous(memory_format=torch.channels_last)
               for m in tm.modules() if isinstance(m, Conv))


def test_cnn_flattens_in_nhwc_order():
    """MnistCNN flattens (h, w, c) before Dense_0, as the JAX model: the
    bridged fc1 rows are Dense_0's kernel as it stands (transposed, not
    permuted), and an NCHW flatten would feed them permuted."""
    jm, v, tm, x = bridged("cnn")
    kernel = v["params"]["Dense_0"]["kernel"]
    assert np.array_equal(tm.fc1.weight.detach().numpy(), kernel.T)
    feats = {}
    tm.fc1.register_forward_pre_hook(
        lambda mod, args: feats.setdefault("x", args[0]))
    tm.eval()
    with torch.no_grad():
        tm(torch.from_numpy(x))
    _, inter = jax.jit(lambda v, x: jm.apply(
        v, x, capture_intermediates=True, mutable=["intermediates"]))(
            v, jnp.asarray(x))
    conv3 = np.asarray(inter["intermediates"]["Conv_2"]["__call__"][0])
    want = np.maximum(conv3, 0).reshape(len(x), -1)     # NHWC flatten
    np.testing.assert_allclose(feats["x"].numpy(), want, atol=1e-5)
    nchw = np.maximum(conv3, 0).transpose(0, 3, 1, 2).reshape(len(x), -1)
    assert np.abs(nchw - want).max() > 0.1


def test_pyramidnet110_and_resnet50_trees_bridge_at_full_size():
    """Every flax name and shape of the full-size models (from the JAX
    package's abstract init, nothing computed) maps onto the port's,
    and back: PyramidNet-110's 51 blocks of widths 16, 21, ... 271, and
    ResNet-50 with either stem path."""
    for jm, tm, shape in (
            (jmodels.pyramidnet(), models.pyramidnet(device="cpu",
                                                     seed=None),
             (1, 32, 32, 3)),
            (jmodels.resnet50(s2d_stem=True),
             models.resnet50(s2d_stem=True, device="cpu", seed=None),
             (1, 224, 224, 3))):
        abstract = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros(shape), train=False))
        tree = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                            abstract)
        state = bridge.flax_to_state_dict(tm, tree["params"],
                                          tree["batch_stats"])
        assert set(state) == set(tm.state_dict())
        for coll in ("params", "batch_stats"):
            back = jax.tree.map(np.shape, bridge.state_dict_to_flax(tm, coll))
            assert back == jax.tree.map(np.shape, tree[coll])
    pn = models.pyramidnet(device="cpu", seed=None)
    widths = [b.conv1.weight.shape[0] for b in pn.blocks]
    assert len(widths) == 51
    assert widths[:3] == [21, 26, 31] and widths[-1] == 271
    assert pn.stem.weight.shape[0] == 16
    assert pn.fc.weight.shape == (10, 271)


def test_s2d_stem_bridges_either_path():
    """The s2d and the plain JAX stems compute the same function; the
    port loads either tree onto its stem and computes the same logits."""
    _, v, tm, x = bridged("resnet_s2d")
    assert "SpaceToDepthStem_0" in v["params"]
    plain = dict(v["params"])
    plain["Conv_0"] = plain.pop("SpaceToDepthStem_0")
    other = bridge.load_flax_params(
        models.ResNet(stage_sizes=(1, 1, 1, 1), num_classes=10,
                      device="cpu", seed=None),
        plain, v["batch_stats"], device="cpu")
    tm.eval()
    other.eval()
    with torch.no_grad():
        assert torch.equal(tm(torch.from_numpy(x)),
                           other(torch.from_numpy(x)))
    assert "Conv_0" in bridge.state_dict_to_flax(other)
    assert "SpaceToDepthStem_0" in bridge.state_dict_to_flax(tm)


def test_bridge_round_trip_and_errors():
    _, v, tm, _ = bridged("pyramidnet")
    back = bridge.flatten(bridge.state_dict_to_flax(tm))
    for path, arr in bridge.flatten(v["params"]).items():
        assert np.array_equal(back[path], arr), path
    params = v["params"]
    with pytest.raises(bridge.BridgeError, match="batch_stats"):
        bridge.flax_to_state_dict(tm, params)
    missing = {k: val for k, val in params.items() if k != "Dense_0"}
    with pytest.raises(bridge.BridgeError, match="Dense_0/bias"):
        bridge.flax_to_state_dict(tm, missing, v["batch_stats"])
    extra = {**params, "Dense_1": params["Dense_0"]}
    with pytest.raises(bridge.BridgeError, match="Dense_1"):
        bridge.flax_to_state_dict(tm, extra, v["batch_stats"])
    block = dict(params["ResidualBlock_0"])
    block["Conv_0"] = {"kernel": block["Conv_0"]["kernel"][:, :, :, :-1]}
    with pytest.raises(bridge.BridgeError,
                       match="ResidualBlock_0/Conv_0/kernel: flax shape"):
        bridge.flax_to_state_dict(tm, {**params, "ResidualBlock_0": block},
                                  v["batch_stats"])
    stats = dict(v["batch_stats"])
    stats.pop("BatchNorm_1")
    with pytest.raises(bridge.BridgeError, match="BatchNorm_1/mean"):
        bridge.flax_to_state_dict(tm, params, stats)
    mlp = models.MLP(n_units=32, device="cpu")
    with pytest.raises(bridge.BridgeError, match="has a leaf"):
        bridge.flax_to_state_dict(mlp, bridge.state_dict_to_flax(mlp),
                                  v["batch_stats"])


def test_init_draws_flax_distributions():
    """Seeded init draws what flax draws: conv_init kernels
    (variance_scaling(2, fan_out, truncated_normal): variance 2 / (out·
    kh·kw)), lecun-normal Dense and MnistCNN kernels (variance 1 /
    fan-in), each truncated at 2 of the underlying normal's std, zero
    biases; BatchNorm at scale 1 (0 for ResNet's last of a block), mean
    0, var 1; the same seed gives the same weights."""
    for tm in (models.ResNet(stage_sizes=(1, 1, 1, 1), device="cpu", seed=3),
               models.MnistCNN(device="cpu", seed=3)):
        for m in tm.modules():
            if isinstance(m, (Conv, Dense)):
                w = m.weight.detach()
                cout, cin = w.shape[:2]
                rf = w[0, 0].numel()
                var = (2.0 / (cout * rf) if isinstance(m, Conv)
                       and m.init == "conv" else 1.0 / (cin * rf))
                if w.numel() >= 4096:
                    assert abs(w.var().item() / var - 1) < 0.1
                assert w.abs().max() <= 2 * var ** 0.5 / 0.8796256610342398
                assert m.bias is None or not m.bias.any()
            elif isinstance(m, BatchNorm):
                assert (m.scale == m.scale_init).all() and not m.bias.any()
                assert not m.mean.any() and (m.var == 1).all()
    resnet = models.ResNet(stage_sizes=(1, 1, 1, 1), device="cpu", seed=3)
    assert not resnet.blocks[0].bn3.scale.any()
    assert resnet.blocks[0].conv1.init == "conv"
    again = models.ResNet(stage_sizes=(1, 1, 1, 1), device="cpu", seed=3)
    for a, b in zip(resnet.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_registry():
    assert models.input_spec("pyramidnet") == ((32, 32, 3), "cifar10")
    for name in ("mlp", "mnist_cnn", "pyramidnet", "resnet50",
                 "transformer_lm"):
        assert models.input_spec(name) == jmodels.input_spec(name)
    m = models.get_model("mnist_cnn", device="cpu")
    assert isinstance(m, models.MnistCNN) and m.device.type == "cpu"
    assert isinstance(models.get_model("pyramidnet", device="cpu",
                                       seed=None), models.PyramidNet)
    with pytest.raises(ValueError, match="unknown model"):
        models.get_model("vgg16", device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        models.input_spec("vgg16")
