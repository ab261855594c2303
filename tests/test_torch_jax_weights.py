"""The JAX package's weights files in the port, and the port's in JAX,
on the CPU.

Both packages now write the flax msgpack blob of the nested tree JAX
saves (``state.params``, or an adapter tree) with its manifest, so:

* a ``tiny`` LM saved by JAX's ``save_weights`` loads into the port: its
  last-position logits within atol 1e-5 (f32) of JAX's ``model.apply``,
  and ``serve_lm --restore`` (the port's twin, ``main(argv)``) gives the
  greedy tokens of JAX's scheduler over the same weights file and
  requests (through ``CopyingJaxEngine``, ROADMAP C1);
* the port's file of the same tree is byte for byte JAX's, and JAX's
  ``load_weights`` reads the port's files bitwise: the LM's, the
  ``train_lm`` twin's ``lm_final.msgpack``, and a classifier's
  ``state.params`` (PyramidNet with BatchNorm: the params only, as the
  JAX examples save them), which the port also reads bitwise from JAX;
* a JAX-written LoRA adapter loads into the port's bank bitwise and
  serves the tokens JAX serves with it; the Keras face's
  ``Model.load_weights`` and the elastic workers' restore read
  JAX-written files too;
* the port's ``Checkpointer`` restores the latest epoch weights of a
  directory JAX's wrote (``weights_epoch_NNNN.msgpack``), and a weights
  file the port wrote before it wrote msgpack (``torch.save`` of the
  flat dict, with its manifest) still loads.
"""

import hashlib
import io
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtdl_tpu.ckpt import Checkpointer as JaxCheckpointer
from dtdl_tpu.ckpt import load_weights as jax_load
from dtdl_tpu.ckpt import save_weights as jax_save
from dtdl_tpu.models import transformer as jtr
from dtdl_tpu.serve import Request as JaxRequest
from dtdl_tpu.serve import Scheduler as JaxScheduler
from dtdl_tpu.serve import adapter_template as jax_template
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.ckpt import Checkpointer, load_weights, save_weights
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.serve import (InferenceEngine, Request, Scheduler,
                                  adapter_template)
from dtdl_tpu_torch.train.state import params_tree
from test_torch_chunked import CopyingJaxEngine, jax_pair
from test_torch_classifier import random_tree
from test_torch_classifier_train import MODELS

torch.set_num_threads(1)

LOGIT_ATOL = 1e-5


def _jax_tiny(seed):
    """The JAX serve_lm script's model (``tiny``, dense, f32) and its
    params from ``seed``."""
    jm = jtr.transformer_lm("tiny", attn_impl="dense", dtype=jnp.float32)
    return jm, fnn.unbox(jm.init(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 8), jnp.int32))["params"])


def _flat_np(tree):
    return {k: np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor)
                          else v) for k, v in bridge.flatten(tree).items()}


def _assert_bitwise(got, want):
    g, w = _flat_np(got), _flat_np(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """A JAX ``save_weights`` of the tiny LM from seed 7 (serve_lm's own
    init is seed 0, so a served token shows the file was read)."""
    jm, params = _jax_tiny(7)
    path = str(tmp_path_factory.mktemp("jax_lm") / "lm_final.msgpack")
    jax_save(path, params)
    return jm, jax.device_get(params), path


def test_jax_lm_file_loads_into_the_port(jax_file):
    jm, params, path = jax_file
    tm = transformer_lm("tiny", attn_impl="dense", device="cpu", seed=0,
                        dtype=torch.float32)
    got = load_weights(path, bridge.state_dict_to_flax(tm))
    _assert_bitwise(got, params)
    bridge.load_flax_params(tm, got, device="cpu")
    tokens = np.random.default_rng(0).integers(0, 256, (2, 24))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    with torch.no_grad():
        logits = tm(torch.from_numpy(tokens)).float().numpy()
    np.testing.assert_allclose(logits[:, -1], want[:, -1], atol=LOGIT_ATOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serve_lm_restore_serves_jaxs_tokens(jax_file, paged):
    """``serve_lm --restore`` of the JAX file: every request's greedy
    tokens those of JAX's scheduler (as its serve_lm builds it) over the
    same file."""
    from dtdl_tpu_torch.examples import serve_lm
    jm, _, path = jax_file
    geo = ["--page-size", "16"] if paged else []
    reqs, _, _ = serve_lm.main(["--platform", "cpu", "--restore", path,
                                "--n-requests", "6", "--max-new-tokens",
                                "8", *geo])
    like = _jax_tiny(0)[1]
    jparams = jax_load(path, like)
    jeng = CopyingJaxEngine(jm, jparams, n_slots=4,
                            page_size=16 if paged else 0)
    jreqs = [JaxRequest(list(r.prompt), 8) for r in reqs]
    JaxScheduler(jeng, seed=0, harvest_lag=4).run(jreqs)
    assert all(r.error is None and len(r.tokens) == 8 for r in reqs)
    assert [r.tokens for r in reqs] == [j.tokens for j in jreqs]


def test_serve_lm_restore_refuses_another_model_size(jax_file):
    from dtdl_tpu_torch.examples import serve_lm
    with pytest.raises(ValueError, match="does not match the model"):
        serve_lm.main(["--platform", "cpu", "--restore", jax_file[2],
                       "--model-size", "small"])


def test_port_lm_file_is_jaxs_bytes_and_loads_in_jax(jax_file, tmp_path):
    _, params, path = jax_file
    tm = transformer_lm("tiny", attn_impl="dense", device="cpu", seed=3,
                        dtype=torch.float32)
    own = bridge.state_dict_to_flax(tm)
    port = str(tmp_path / "port.msgpack")
    save_weights(port, own)
    back = jax_load(port, jax.tree.map(jnp.asarray, params))
    _assert_bitwise(back, own)
    # the same tree written by each package: the same bytes
    save_weights(port, jax.tree.map(np.asarray, params))
    with open(port, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()


def test_train_lm_twin_file_loads_in_jax(tmp_path):
    """The ``train_lm`` twin's ``lm_final.msgpack`` read by JAX's
    ``load_weights`` into the JAX model's params: the port's trained
    params, bitwise."""
    from dtdl_tpu_torch.examples import train_lm
    out = str(tmp_path / "out")
    train_lm.main(["--platform", "cpu", "--model-size", "tiny",
                   "--seq-len", "16", "--batch-size", "64", "--epochs", "1",
                   "--log-interval", "16", "--out", out])
    assert sorted(os.listdir(out)) == ["lm_final.msgpack",
                                       "lm_final.msgpack.manifest.json"]
    path = os.path.join(out, "lm_final.msgpack")
    jm = jtr.transformer_lm("tiny", max_seq=16)
    like = fnn.unbox(jm.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 16), jnp.int32))["params"])
    back = jax_load(path, like)
    tm = transformer_lm("tiny", device="cpu", seed=0, max_seq=16)
    _assert_bitwise(back, load_weights(path, bridge.state_dict_to_flax(tm)))


def test_classifier_params_both_ways(tmp_path):
    """PyramidNet (BatchNorm): JAX's ``save_weights(state.params)`` read
    by the port bitwise, and the port's ``state_dict_to_flax`` file read
    by JAX's ``load_weights`` bitwise."""
    tm = MODELS["pyramidnet"][1]()
    v = random_tree(tm, spread=0.25)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                           v["params"])
    jpath = str(tmp_path / "jax" / "pyramidnet_final.msgpack")
    jax_save(jpath, jparams)
    got = load_weights(jpath, params_tree(tm))
    _assert_bitwise(got, jax.device_get(jparams))
    bridge.load_flax_params(tm, got, v["batch_stats"], device="cpu")
    ppath = str(tmp_path / "port" / "pyramidnet_final.msgpack")
    save_weights(ppath, bridge.state_dict_to_flax(tm))
    _assert_bitwise(jax_load(ppath, jparams), jax.device_get(jparams))
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()


def test_jax_lora_adapter_serves_in_the_port(tmp_path):
    """A JAX-written adapter (``adapter_template`` of the JAX params,
    normal(0, 0.3) factors): the port's bank holds it bitwise, and a
    request under it and a base request get JAX's tokens."""
    cfg = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
               max_seq=48)
    jm, params, tm = jax_pair(**cfg)
    rng = np.random.default_rng(5)
    tree = jax.tree.map(lambda a: rng.normal(0, 0.3, a.shape).astype(
        np.float32), jax_template(params, rank=2))
    path = str(tmp_path / "adapter.msgpack")
    jax_save(path, tree)
    _assert_bitwise(load_weights(path, adapter_template(tm, 2)), tree)
    prompts = [[5, 9, 12, 5, 9], [40, 41, 42]]
    jeng = CopyingJaxEngine(jm, params, n_slots=2, buckets=(8, 16, 48),
                            lora_rank=2, lora_adapters=2)
    jreqs = [JaxRequest(list(prompts[0]), 6, adapter=path),
             JaxRequest(list(prompts[1]), 6)]
    JaxScheduler(jeng, harvest_lag=2).run(jreqs)
    eng = InferenceEngine(tm, n_slots=2, buckets=(8, 16, 48), device="cpu",
                          lora_rank=2, lora_adapters=2)
    reqs = [Request(list(prompts[0]), 6, adapter=path),
            Request(list(prompts[1]), 6)]
    Scheduler(eng, harvest_lag=2, device="cpu").run(reqs)
    assert all(r.error is None for r in reqs)
    assert [r.tokens for r in reqs] == [j.tokens for j in jreqs]


def test_checkpointer_restores_jaxs_latest_epoch(tmp_path):
    jck = JaxCheckpointer(str(tmp_path), keep=3)
    trees = {e: {"Dense_0": {"kernel": np.full((3, 2), e, np.float32),
                             "bias": np.arange(2, dtype=np.float32) + e}}
             for e in range(4)}
    for e, tree in trees.items():
        jck.save_weights_epoch(e, jax.tree.map(jnp.asarray, tree))
    # (JAX's gc leaves a deleted epoch's manifest behind; the port's
    # removes it)
    assert sorted(p for p in os.listdir(tmp_path) if p.endswith(
        ".msgpack")) == [f"weights_epoch_{e:04d}.msgpack" for e in (1, 2, 3)]
    like = {"Dense_0": {"kernel": torch.zeros(3, 2), "bias": torch.zeros(2)}}
    ck = Checkpointer(str(tmp_path), keep=3)
    got, epoch = ck.latest_weights(like)
    assert epoch == 3
    _assert_bitwise(got, trees[3])
    # the port's next epoch joins the JAX timeline under the same names
    ck.save_weights_epoch(4, got)
    assert ck._list(ck._WEIGHT_RE) == [2, 3, 4]
    back, epoch = jck.latest_weights(jax.tree.map(jnp.asarray, trees[0]))
    assert epoch == 4
    _assert_bitwise(back, trees[3])


def test_the_ports_old_torch_save_file_still_loads(tmp_path):
    """The format the port wrote before msgpack: ``torch.save`` of the
    flat {flax path: tensor} dict, its manifest beside it."""
    tm = transformer_lm("tiny", device="cpu", seed=4, dtype=torch.float32)
    flat = {k: torch.from_numpy(v) for k, v in bridge.flatten(
        bridge.state_dict_to_flax(tm)).items()}
    buf = io.BytesIO()
    torch.save(flat, buf)
    blob = buf.getvalue()
    path = str(tmp_path / "lm_final.pt")
    with open(path, "wb") as f:
        f.write(blob)
    with open(path + ".manifest.json", "w") as f:
        json.dump({"bytes": len(blob),
                   "sha256": hashlib.sha256(blob).hexdigest()}, f)
    fresh = transformer_lm("tiny", device="cpu", seed=9, dtype=torch.float32)
    got = load_weights(path, bridge.state_dict_to_flax(fresh))
    _assert_bitwise(got, flat)
    flat_like = bridge.flatten(params_tree(fresh))
    assert load_weights(path, flat_like).keys() == flat_like.keys()


def test_keras_model_loads_a_jax_file(tmp_path):
    """``Model.load_weights`` (the Keras face, ``train/fit.py``) of the
    JAX package's ``save_weights`` of an MLP's params: the module's
    parameters bitwise."""
    from dtdl_tpu_torch.train import Model
    from test_torch_fit import model_pair
    v = random_tree(MODELS["mlp"][1](), seed=6)
    path = str(tmp_path / "final.msgpack")
    jax_save(path, jax.tree.map(lambda a: np.asarray(a, np.float32),
                                v["params"]))
    _, model = model_pair("mlp", "sgd")
    assert isinstance(model, Model)
    model._ensure_state()
    model.load_weights(path)
    _assert_bitwise(bridge.state_dict_to_flax(model.module),
                    jax.tree.map(lambda a: np.asarray(a, np.float32),
                                 v["params"]))


def test_elastic_workers_restore_a_jax_written_snapshot(tmp_path):
    """The elastic workers' restore (``resil/elastic.py``) from a
    committed snapshot JAX's ``save_weights`` wrote: the same bytes as the
    port's file of that state, and the survivors' final parameters
    equal to those restored from the port's file."""
    from dtdl_tpu_torch.parallel.kvstore import HostKVStore
    from dtdl_tpu_torch.resil import run_workers
    from test_torch_elastic import mk_workers, problem
    state = {"params": {k: v.cpu().numpy() + np.float32(0.25) for k, v in
                        problem()["init_fn"]()["params"].items()}}
    finals = []
    for name, save in (("jax", jax_save), ("port", save_weights)):
        path = str(tmp_path / name / "elastic_000004.msgpack")
        save(path, state)
        store = HostKVStore()
        store.set("ckpt/committed", {"step": 4, "path": path})
        ws = mk_workers(store, [0, 1])
        run_workers(ws, timeout_s=60)
        assert all(w.done and w.error is None for w in ws)
        assert all(info["step"] == 4 for w in ws
                   for n, _, info in w.events if n == "restore")
        finals.append(ws[0].state["params"])
    with open(tmp_path / "jax" / "elastic_000004.msgpack", "rb") as a, \
            open(tmp_path / "port" / "elastic_000004.msgpack", "rb") as b:
        assert a.read() == b.read()
    assert finals[0].keys() == finals[1].keys()
    for k in finals[0]:
        assert torch.equal(finals[0][k], finals[1][k]), k
