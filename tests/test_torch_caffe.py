"""The port's Caffe face (``dtdl_tpu_torch.utils.prototxt``,
``models.netspec``, ``train.solver``, ``obs.goodput.netspec_flops``)
against the JAX package's, on the CPU.

The JAX side runs in float64 (``jax.enable_x64``, its nets built with
``dtype=float64`` and their params cast to f64, as
``tests/test_torch_classifier_train.py`` explains); the port in f32 from
the same weights (the JAX init, bridged) on the same seeded batches.

Tolerances (port f32 against JAX f64): prototxt trees and errors equal;
lr policies within 1e-6 relative; pool geometry equal; net outputs
within 1e-5; netspec FLOPs equal.  The Solver on LeNet with each of the
six solver types: the per-iteration losses within 1e-5 relative, the
final parameters within 1e-5, the accuracies equal, over 20 iterations
with the port's net in float64 (its logits f32, as both packages' nets
return them) and over 5 iterations with the port in f32.  An
``iter_size: 2`` run snapshotted between two mini-steps and restored is
bitwise the uninterrupted run.

Why the f32 trajectory is shorter, measured on this LeNet: an f32 run
(either package's) parts from the f64 one where a max-pool window holds
two values within f32 rounding of each other (a relative gap of 6.5e-6
on the first batch) or a ReLU input lies within it of 0: the gradient
goes to another element, a change of 1e-4 in one weight's gradient,
which momentum carries on; after 20 iterations the f32 port's losses
lay 1.2e-3 (relative) from JAX's in f64 and in f32 alike, while the
port in f64 stayed within 1.1e-7.  The adaptive types (Adam, AdaGrad,
RMSProp, AdaDelta) scale each update by 1 / (sqrt(v) + delta): for
gradients near delta the step depends on the last bits of the f32
logits both nets return, so the solver here sets ``delta: 1e-4``
(Caffe's default 1e-8 put a 1e-4 difference into one weight after one
Adam step even with both nets in f64), and the f32 comparison of those
types holds their parameters within 5 steps' size only (see
``test_solver_types_in_f32_match_jax_on_lenet``).  The
update rules themselves are held to optax exactly in f64 in
``tests/test_torch_optim.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtdl_tpu.data import DataLoader as JaxLoader
from dtdl_tpu.models import netspec as jnetspec
from dtdl_tpu.obs.goodput import netspec_flops as jax_flops
from dtdl_tpu.parallel import SingleDevice as JaxSingle
from dtdl_tpu.train.solver import Solver as JaxSolver
from dtdl_tpu.train.solver import lr_schedule as jax_schedule
from dtdl_tpu.train.state import TrainState as JaxState
from dtdl_tpu.utils import prototxt as jproto
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.ckpt import Checkpointer
from dtdl_tpu_torch.data.loader import DataLoader
from dtdl_tpu_torch.data.synthetic import class_pattern_images
from dtdl_tpu_torch.metrics.report import Reporter
from dtdl_tpu_torch.models import netspec
from dtdl_tpu_torch.obs.goodput import netspec_flops
from dtdl_tpu_torch.train.solver import Solver, lr_schedule, make_optimizer
from dtdl_tpu_torch.train.state import init_state, state_to_tree
from dtdl_tpu_torch.train.step import make_train_step
from dtdl_tpu_torch.utils import prototxt

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples", "caffe")
LENET = os.path.join(EXAMPLES, "lenet_train_test.prototxt")


@pytest.fixture
def x64():
    with jax.enable_x64():
        yield


def to_plain(x):
    """A parsed Message tree as plain dicts and lists."""
    if isinstance(x, dict):
        return {k: to_plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_plain(v) for v in x]
    return x


# ---- prototxt ---------------------------------------------------------------

TEXTS = [
    'net: "lenet.prototxt"   # comment\nbase_lr: 0.01 max_iter: 10000 '
    'test_initialization: false type: "SGD"',
    'layer { name: "a" type: "Convolution" convolution_param { num_output: '
    '20 kernel_size: 5 } } layer { name: "b" type: "Pooling" pooling_param '
    '{ pool: MAX kernel_size: 2 stride: 2 } } stepvalue: 100 stepvalue: 200',
    "param: { lr_mult: 1 } include { phase: TRAIN } s: 'x\\ty' f: -1.5e-3",
]


@pytest.mark.parametrize("text", TEXTS + [open(LENET).read(), open(
    os.path.join(EXAMPLES, "lenet_solver.prototxt")).read()],
    ids=["scalars", "nested", "quoting", "lenet net", "lenet solver"])
def test_prototxt_parses_as_jax(text):
    got, want = prototxt.parse(text), jproto.parse(text)
    assert to_plain(got) == to_plain(want)
    layers = got.getlist("layer")
    assert [lyr.get_scalar("name") for lyr in layers] == \
        [lyr.get_scalar("name") for lyr in want.getlist("layer")]


@pytest.mark.parametrize("bad", ["layer {", "}", "name:", "42", "a: { b: }",
                                 'prefix: "unterminated', "a { b: 1 } }"])
def test_prototxt_errors_as_jax(bad):
    with pytest.raises(ValueError) as want:
        jproto.parse(bad)
    with pytest.raises(ValueError) as got:
        prototxt.parse(bad)
    assert str(got.value) == str(want.value)


# ---- lr policies --------------------------------------------------------------

POLICIES = [
    'base_lr: 0.1 lr_policy: "fixed"',
    'base_lr: 0.1 lr_policy: "step" gamma: 0.5 stepsize: 100',
    'base_lr: 0.1 lr_policy: "exp" gamma: 0.99',
    'base_lr: 0.01 lr_policy: "inv" gamma: 0.0001 power: 0.75',
    'base_lr: 0.1 lr_policy: "multistep" gamma: 0.1 stepvalue: 10 '
    'stepvalue: 20',
    'base_lr: 0.1 lr_policy: "multistep" gamma: 0.5 max_iter: 30',
    'base_lr: 0.1 lr_policy: "poly" power: 1.5 max_iter: 100',
    'base_lr: 0.2 lr_policy: "sigmoid" gamma: 0.1 stepsize: 50',
]


@pytest.mark.parametrize("text", POLICIES, ids=[
    "fixed", "step", "exp", "inv", "multistep", "multistep-max_iter", "poly",
    "sigmoid"])
def test_lr_policies_match_jax(text, x64):
    got, want = lr_schedule(prototxt.parse(text)), \
        jax_schedule(jproto.parse(text))
    its = [0, 1, 9, 10, 15, 20, 25, 30, 50, 99, 100, 250, 1000]
    np.testing.assert_allclose([got(i) for i in its],
                               [float(want(jnp.asarray(i))) for i in its],
                               rtol=1e-6)
    with pytest.raises(ValueError, match="unknown lr_policy"):
        lr_schedule(prototxt.parse('lr_policy: "cosine"'))


# ---- nets ---------------------------------------------------------------------

@pytest.mark.parametrize("H,k,s,p", [(32, 3, 2, 0), (28, 2, 2, 0),
                                     (6, 3, 2, 1), (5, 3, 3, 1), (7, 4, 3, 2),
                                     (9, 3, 2, 1)])
def test_caffe_pool_geometry_equal(H, k, s, p):
    assert netspec._caffe_pool_pad(H, k, s, p) == \
        jnetspec._caffe_pool_pad(H, k, s, p)


POOL_NET = '''
  layer {{ name: "d" type: "Input" top: "data" }}
  layer {{ name: "pool" type: "Pooling" bottom: "data" top: "pool"
          pooling_param {{ pool: {pool} kernel_size: {k} stride: {s}
                           pad: {p} }} }}
'''


@pytest.mark.parametrize("pool", ["MAX", "AVE"])
@pytest.mark.parametrize("H,W,k,s,p", [(6, 6, 3, 2, 0), (32, 32, 3, 2, 0),
                                       (5, 7, 3, 3, 1), (9, 6, 3, 2, 1)])
def test_caffe_pooling_matches_jax(pool, H, W, k, s, p, x64):
    text = POOL_NET.format(pool=pool, k=k, s=s, p=p)
    x = np.random.default_rng(0).normal(size=(2, H, W, 3))
    jn = jnetspec.build_net(text, dtype=jnp.float64)
    want = np.asarray(jn.apply({}, jnp.asarray(x)))
    tn = netspec.build_net(text, input_shape=(H, W, 3), device="cpu")
    got = tn.eval()(torch.from_numpy(x.astype(np.float32))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_lrn_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 4, 7)).astype(np.float32)
    for size in (3, 4, 5):
        want = np.asarray(jnetspec._lrn(jnp.asarray(x), size, 0.1, 0.75, 2.0))
        got = netspec._lrn(torch.from_numpy(x).permute(0, 3, 1, 2), size,
                           0.1, 0.75, 2.0).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


MIX_NET = '''
  layer { name: "d" type: "Input" top: "data" }
  layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
          convolution_param { num_output: 8 kernel_size: 3 pad: 2 group: 2
                              dilation: 2 } }
  layer { name: "norm" type: "LRN" bottom: "conv" top: "norm"
          lrn_param { local_size: 3 alpha: 0.1 beta: 0.75 k: 2.0 } }
  layer { name: "pool" type: "Pooling" bottom: "norm" top: "pool"
          pooling_param { pool: AVE kernel_size: 3 stride: 2 pad: 1 } }
  layer { name: "c2" type: "Convolution" bottom: "pool" top: "c2"
          convolution_param { num_output: 6 kernel_h: 3 kernel_w: 2
                              stride_h: 2 stride_w: 1 bias_term: false } }
  layer { name: "relu" type: "ReLU" bottom: "c2" top: "c2"
          relu_param { negative_slope: 0.1 } }
  layer { name: "flat" type: "Flatten" bottom: "c2" top: "flat" }
  layer { name: "ip" type: "InnerProduct" bottom: "flat" top: "ip"
          inner_product_param { num_output: 10 } }
  layer { name: "drop" type: "Dropout" bottom: "ip" top: "ip"
          include { phase: TRAIN } }
  layer { name: "s" type: "Sigmoid" bottom: "ip" top: "sig" }
  layer { name: "t" type: "TanH" bottom: "sig" top: "out" }
'''


@pytest.mark.parametrize("name,text,shape", [
    ("lenet", open(LENET).read(), (28, 28, 1)),
    ("mixed", MIX_NET, (11, 9, 4)),
], ids=["lenet", "mixed"])
def test_bridged_net_test_phase_matches_jax(name, text, shape, x64):
    tn = netspec.build_net(text, input_shape=shape, device="cpu", seed=3)
    params = bridge.state_dict_to_flax(tn)
    jn = jnetspec.build_net(text, dtype=jnp.float64)
    x = np.random.default_rng(1).uniform(size=(3,) + shape)
    v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    want = np.asarray(jn.apply({"params": v}, jnp.asarray(x), train=False))
    got = tn.eval()(torch.from_numpy(x.astype(np.float32))).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the JAX init's tree has the port's leaves and shapes
    jv = jnetspec.build_net(text).init(jax.random.PRNGKey(0),
                                       jnp.zeros((1,) + shape))["params"]
    assert {k: np.shape(a) for k, a in bridge.flatten(jv).items()} == \
        {k: a.shape for k, a in bridge.flatten(params).items()}


def test_net_refusals_as_jax():
    with pytest.raises(ValueError, match="no layers"):
        netspec.build_net('name: "empty"', input_shape=(4,), device="cpu")
    text = '''layer { name: "d" type: "Input" top: "data" }
              layer { name: "x" type: "Deconvolution" bottom: "data" }'''
    with pytest.raises(NotImplementedError, match="Deconvolution.*x"):
        netspec.build_net(text, input_shape=(4, 4, 1), device="cpu")
    bad = '''layer { name: "d" type: "Input" top: "data" }
      layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
              inner_product_param { num_output: 4
                weight_filler { type: "bilinear" } } }'''
    with pytest.raises(NotImplementedError, match="filler"):
        jnetspec.build_net(bad).init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))
    with pytest.raises(NotImplementedError, match="filler"):
        netspec.build_net(bad, input_shape=(8,), device="cpu")


def test_fillers_by_their_statistics():
    """The bounds of tests/test_caffe.py's filler tests, on the port."""
    net = netspec.build_net('''
      layer { name: "d" type: "Input" top: "data" }
      layer { name: "ip1" type: "InnerProduct" bottom: "data" top: "ip1"
              inner_product_param { num_output: 300
                weight_filler { type: "gaussian" mean: 0.5 std: 0.01 }
                bias_filler { type: "constant" value: 0.25 } } }
      layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
              inner_product_param { num_output: 40
                weight_filler { type: "xavier" } } }
      layer { name: "ip3" type: "InnerProduct" bottom: "ip2" top: "ip3"
              inner_product_param { num_output: 16
                weight_filler { type: "positive_unitball" } } }
    ''', input_shape=(200,), device="cpu", seed=0)
    p = bridge.state_dict_to_flax(net)
    w1, b1 = p["ip1"]["kernel"], p["ip1"]["bias"]
    np.testing.assert_array_equal(b1, np.full_like(b1, 0.25))
    assert abs(w1.mean() - 0.5) < 0.005 and abs(w1.std() - 0.01) < 0.005
    w2, bound = p["ip2"]["kernel"], np.sqrt(3.0 / 300)
    assert np.abs(w2).max() <= bound + 1e-6
    assert np.abs(w2).max() > 0.8 * bound
    np.testing.assert_allclose(p["ip3"]["kernel"].sum(axis=0), 1.0,
                               rtol=1e-5)
    net = netspec.build_net('''
      layer { name: "d" type: "Input" top: "data" }
      layer { name: "c1" type: "Convolution" bottom: "data" top: "c1"
              convolution_param { num_output: 64 kernel_size: 3
                weight_filler { type: "msra" }
                bias_filler { type: "uniform" min: -0.5 max: -0.25 } } }
    ''', input_shape=(8, 8, 16), device="cpu", seed=1)
    p = bridge.state_dict_to_flax(net)["c1"]
    assert (p["bias"] >= -0.5).all() and (p["bias"] <= -0.25).all()
    assert abs(p["kernel"].std() - np.sqrt(2.0 / (3 * 3 * 16))) < 0.02


def test_netspec_flops_match_jax():
    for text, shape in ((open(LENET).read(), (28, 28, 1)),
                        (MIX_NET, (11, 9, 4))):
        for phase in ("TRAIN", "TEST"):
            for backward in (False, True):
                want = jax_flops(jnetspec.parse_net(jproto.parse(text)),
                                 shape, phase, backward)
                got = netspec_flops(netspec.parse_net(prototxt.parse(text)),
                                    shape, phase, backward)
                assert got == want
    assert netspec_flops(LENET, (28, 28, 1)) == jax_flops(LENET, (28, 28, 1))


# ---- the Solver ----------------------------------------------------------------

BATCH, N_TRAIN, N_TEST = 16, 96, 40


class ListSink:
    def __init__(self):
        self.rows = []

    def write(self, payload):
        self.rows.append(dict(payload))

    def close(self):
        pass


# base_lr by type where LeNet trains stably on this data (0.01 for the
# others): at 0.01, RMSProp's f32 loss reached 9804 by iteration 5 and
# AdaDelta's at 1.0 reached 1927, and a diverging run amplifies every
# rounding difference
BASE_LR = {"Adam": 0.0003, "RMSProp": 0.001, "AdaDelta": 0.1}
ADAPTIVE = ("Adam", "AdaGrad", "RMSProp", "AdaDelta")


def solver_file(tmp_path, kind, extra="", max_iter=20):
    (tmp_path / "net.prototxt").write_text(open(LENET).read())
    path = tmp_path / f"{kind}.prototxt"
    path.write_text(f'''
      net: "net.prototxt" type: "{kind}" base_lr: {BASE_LR.get(kind, 0.01)}
      lr_policy: "inv"
      gamma: 0.05 power: 0.75 momentum: 0.9 weight_decay: 0.0005
      delta: 0.0001 max_iter: {max_iter} display: 1 test_iter: 2
      test_interval: {max(max_iter // 2, 1)} random_seed: 1
      snapshot_prefix: "{tmp_path}/snap" {extra}
    ''')
    return str(path)


def data():
    x, y = class_pattern_images(N_TRAIN + N_TEST, (28, 28, 1), 10, seed=0,
                                noise=0.3)
    return (x[:N_TRAIN], y[:N_TRAIN]), (x[N_TRAIN:], y[N_TRAIN:])


@pytest.fixture
def torch64():
    """The port's tensors in float64 (its net then made in f64)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield torch.float64
    torch.set_default_dtype(old)


def solver_pair(tmp_path, kind, extra="", max_iter=20, dtype=torch.float32):
    path = solver_file(tmp_path, kind, extra, max_iter)
    (x, y), (vx, vy) = data()
    js = JaxSolver(path, JaxLoader({"image": x, "label": y}, BATCH, seed=0),
                   JaxLoader({"image": vx, "label": vy}, BATCH, seed=0,
                             drop_last=False),
                   strategy=JaxSingle(), dtype=jnp.float64,
                   out=str(tmp_path / "jax"))
    p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                       jax.device_get(js.state.params))
    js.state = JaxState.create(apply_fn=js.net.apply, params=p64, tx=js.tx)
    ts = Solver(path, DataLoader({"image": x, "label": y}, BATCH, seed=0,
                                 device="cpu"),
                DataLoader({"image": vx, "label": vy}, BATCH, seed=0,
                           drop_last=False, device="cpu"),
                out=str(tmp_path / "port"), device="cpu", dtype=dtype)
    bridge.load_flax_params(ts.net, jax.device_get(js.state.params),
                            device="cpu")
    for s in (js, ts):
        s.sink = ListSink()
        s.reporter = Reporter([s.sink])
    return js, ts


KINDS = ["SGD", "Nesterov", "Adam", "AdaGrad", "RMSProp", "AdaDelta"]


def compare_runs(js, ts, share=1.0, rest_bound=1e-5):
    """Losses within 1e-5 relative, accuracies equal, and at least
    ``share`` of each parameter's elements within 1e-5 of JAX's (the
    rest within ``rest_bound``)."""
    jrows, trows = js.sink.rows, ts.sink.rows
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    for key in ("loss", "test_loss"):
        np.testing.assert_allclose([r[key] for r in trows if key in r],
                                   [r[key] for r in jrows if key in r],
                                   rtol=1e-5, err_msg=key)
    for key in ("accuracy", "test_accuracy"):
        assert [r[key] for r in trows if key in r] == \
            [r[key] for r in jrows if key in r], key
    want = bridge.flatten(jax.device_get(js.state.params))
    got = bridge.flatten(bridge.state_dict_to_flax(ts.net))
    for path in want:
        err = np.abs(got[path] - want[path])
        assert (err <= 1e-5).mean() >= share, (path, (err > 1e-5).sum())
        assert err.max() <= rest_bound, (path, err.max())


@pytest.mark.parametrize("kind", KINDS)
def test_solver_types_match_jax_on_lenet(kind, tmp_path, x64, torch64):
    js, ts = solver_pair(tmp_path, kind, dtype=torch64)
    js.solve()
    ts.solve()
    assert ts.iteration == js.iteration == 20
    compare_runs(js, ts)


@pytest.mark.parametrize("kind", KINDS)
def test_solver_types_in_f32_match_jax_on_lenet(kind, tmp_path, x64):
    """In f32 an adaptive type's per-element step divides by a root of
    the squared gradients, which carries f32 rounding in the small ones
    into the weights: over 5 iterations Adam, RMSProp and AdaDelta moved
    2-109 elements of conv1's 500 and conv2's 25000 weights past 1e-5
    (at least 97.2% of each parameter within it, the largest error
    4.2e-5), while their conv weights moved 6e-4 to 7.5e-3 (median).
    So for the adaptive types: 95% of each parameter within 1e-5 and
    all of it within 1e-4, a sixth of Adam's median move; the losses
    and the others as in f64."""
    js, ts = solver_pair(tmp_path, kind, max_iter=5)
    js.solve()
    ts.solve()
    assert ts.iteration == js.iteration == 5
    if kind in ADAPTIVE:
        compare_runs(js, ts, 0.95, 1e-4)
    else:
        compare_runs(js, ts)


def test_solver_iter_size_and_resume_match_jax(tmp_path, x64, torch64):
    """iter_size 2 (MultiSteps): 20 updates over 40 batches; then a
    fresh port Solver restores the final snapshot and agrees."""
    js, ts = solver_pair(tmp_path, "SGD", "iter_size: 2 snapshot: 10",
                         dtype=torch64)
    js.solve()
    ts.solve()
    assert ts.iteration == 20 and ts.state.step == int(js.state.step) == 40
    np.testing.assert_allclose([r["loss"] for r in ts.sink.rows
                                if "loss" in r],
                               [r["loss"] for r in js.sink.rows
                                if "loss" in r], rtol=1e-5)
    want = bridge.flatten(jax.device_get(js.state.params))
    got = bridge.flatten(bridge.state_dict_to_flax(ts.net))
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-5)
    _, again = solver_pair(tmp_path, "SGD", "iter_size: 2 snapshot: 10",
                           dtype=torch64)
    assert again.restore() and again.iteration == 20
    assert again.solve() == {}     # at max_iter: nothing left to do


def test_explicit_zero_momentum_is_kept():
    p = [torch.nn.Parameter(torch.ones(4))]
    opt = make_optimizer(prototxt.parse(
        'base_lr: 0.1 momentum: 0.0 type: "Adam"')).init(p)
    assert opt.param_groups[0]["betas"][0] == 0.0
    opt = make_optimizer(prototxt.parse('base_lr: 0.1 type: "Adam"')).init(p)
    assert opt.param_groups[0]["betas"][0] == 0.9
    with pytest.raises(ValueError, match="unknown solver type"):
        make_optimizer(prototxt.parse('type: "LBFGS"'))


def test_iter_size_snapshot_between_mini_steps_resumes_exactly(tmp_path):
    """An iter_size 2 state saved after an odd number of mini-steps (the
    accumulator half full) and restored into a fresh state continues
    bitwise as the uninterrupted one."""
    sp = prototxt.parse('base_lr: 0.05 lr_policy: "step" gamma: 0.5 '
                        'stepsize: 2 momentum: 0.9 weight_decay: 0.01 '
                        'iter_size: 2 type: "SGD"')
    (x, y), _ = data()
    batches = [{"image": x[i:i + BATCH], "label": y[i:i + BATCH]}
               for i in range(0, N_TRAIN, BATCH)]

    def fresh():
        net = netspec.build_net(LENET, input_shape=(28, 28, 1), device="cpu",
                                seed=4)
        return init_state(net, None, make_optimizer(sp), device="cpu")

    step = make_train_step()
    a = fresh()
    for b in batches:
        a, _ = step(a, b)
    b_state = fresh()
    for b in batches[:3]:
        b_state, _ = step(b_state, b)
    assert b_state.optimizer.mini_step == 1
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(3, b_state, wait=True)
    c, at = ck.restore(fresh())
    assert at == 3 and c.optimizer.mini_step == 1
    for b in batches[3:]:
        c, _ = step(c, b)
    fa, fc = bridge.flatten(state_to_tree(a)), bridge.flatten(state_to_tree(c))
    assert fa.keys() == fc.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fc[k]), k
        else:
            assert fa[k] == fc[k], k


def test_split_train_test_nets_share_weights(tmp_path):
    (tmp_path / "train.prototxt").write_text(open(LENET).read())
    (tmp_path / "test.prototxt").write_text(open(LENET).read())
    (tmp_path / "s.prototxt").write_text(f'''
      train_net: "train.prototxt" test_net: "test.prototxt" base_lr: 0.01
      max_iter: 2 random_seed: 3 snapshot_prefix: "{tmp_path}/p"''')
    (x, y), (vx, vy) = data()
    s = Solver(str(tmp_path / "s.prototxt"),
               DataLoader({"image": x, "label": y}, BATCH, device="cpu"),
               DataLoader({"image": vx, "label": vy}, BATCH, device="cpu",
                          drop_last=False), device="cpu")
    assert s.test_net is not s.net
    assert s.test_net.layers["ip2"].weight is s.net.layers["ip2"].weight
    s.solve()
    assert set(s.test()) == {"test_loss", "test_accuracy"}
    with pytest.raises(NotImplementedError, match="A13"):
        Solver(str(tmp_path / "s.prototxt"),
               DataLoader({"image": x, "label": y}, BATCH, device="cpu"),
               device="cpu", observer=object())
