"""The port's flax msgpack codec (``dtdl_tpu_torch.ckpt.flax_msgpack``)
against ``flax.serialization`` on the CPU.

* **Bytes**: for trees of every leaf kind (each dtype the JAX package's
  weights and adapters hold, 0-d and empty arrays, numpy scalars, Python
  scalars, complex, ``None``, strings past every header size, nested
  dicts in any key order), the port's ``msgpack_serialize`` gives the
  bytes of flax's, from numpy leaves and from torch tensors alike.
* **Decoding**: the port decodes flax's bytes to the same arrays bitwise
  (bf16 and fp8 by their bits), and flax decodes the port's.
* **Chunking**: with ``MAX_CHUNK_SIZE`` lowered in both modules inside
  the test, an array above it is chunked the same way and decodes back,
  both ways.
* **Failures**: a truncated or bit-flipped blob is a
  ``CheckpointCorruptError`` from ``load_weights`` (with or without its
  manifest), a leaf of another shape or dtype a ``ValueError`` naming
  it, and a malformed blob a ``ValueError`` from the codec.

Everything is exact.
"""

import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization as fs

from dtdl_tpu_torch.ckpt import (CheckpointCorruptError, load_weights,
                                 save_weights)
from dtdl_tpu_torch.ckpt import flax_msgpack as fm

# every dtype the JAX package's weights, quantized weights and adapters hold
DTYPES = ["float32", "bfloat16", "float16", "int8", "int32", "uint8", "bool",
          "float8_e4m3fn", "float8_e5m2", "float64", "int64", "complex64"]


def _np_dtype(name):
    return np.dtype(getattr(ml_dtypes, name, name))


def _array(name, shape, seed=0):
    rng = np.random.default_rng(seed)
    if name == "bool":
        return rng.random(shape) > 0.5
    dt = _np_dtype(name)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return rng.integers(max(info.min, -100), min(info.max, 100), shape,
                            dtype=np.int64).astype(dt)
    if dt.kind == "c":
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
                ).astype(dt)
    return rng.normal(size=shape).astype(np.float32).astype(dt)


def _to_torch(x):
    """A numpy leaf as the port's tensor (bf16/fp8 through their bits)."""
    name = x.dtype.name
    if name in ("bfloat16",) or name.startswith("float8"):
        bits = x.view(np.uint16 if name == "bfloat16" else np.uint8)
        return torch.from_numpy(bits.copy()).view(getattr(torch, name))
    return torch.from_numpy(np.array(x))


def _bits(x):
    """An array (numpy or tensor) as (dtype name, shape, raw bytes)."""
    if isinstance(x, torch.Tensor):
        return (fm.dtype_name(x.dtype), tuple(x.shape),
                x.contiguous().reshape(-1).view(torch.uint8).numpy()
                .tobytes())
    x = np.asarray(x)
    return x.dtype.name, x.shape, x.tobytes()


def mixed_tree():
    """Every leaf kind, keys deliberately unsorted."""
    tree = {"params": {name: {"w": _array(name, (3, 5), i),
                              "zero_d": _array(name, (), i + 50),
                              "empty": _array(name, (0, 4), i)}
                       for i, name in enumerate(DTYPES)}}
    tree.update({
        "z_scalars": {"np_f32": np.float32(1.25), "np_i8": np.int8(-3),
                      "np_f64": np.float64(2.5), "np_bool": np.bool_(True),
                      "np_c128": np.complex128(1 - 2j)},
        "a_python": {"int_small": 7, "neg_fix": -5, "i8": -100,
                     "i16": -30000, "i32": -70000, "i64": -(1 << 40),
                     "u8": 200, "u16": 60000, "u32": 1 << 31,
                     "u64": 1 << 63, "float": 0.1, "true": True,
                     "false": False, "none": None, "complex": 3 + 4j,
                     "bytes": b"\x00\x01\xff" * 100},
        "m_strings": {"fix": "ab", "s8": "x" * 40, "s16": "y" * 300,
                      "s32": "z" * 70000, "utf8": "héllo wörld"},
        "wide": {f"k{i}": np.int32(i) for i in range(20)},
        "big_map": {f"{i:05d}": i for i in range(70000)},
        "long": _array("float32", (20000,)),
        "huge_ext": _array("uint8", (70000,)),
    })
    return tree


def test_serialize_gives_flaxs_bytes():
    tree = mixed_tree()
    assert fm.msgpack_serialize(tree) == fs.msgpack_serialize(tree)


def test_torch_leaves_give_the_same_bytes():
    tree = {"block_0": {name: {"kernel": _array(name, (4, 2, 3), i)}
                        for i, name in enumerate(DTYPES)},
            "embed": _array("float32", (16, 8))}
    as_torch = jax.tree.map(_to_torch, tree)
    assert fm.msgpack_serialize(as_torch) == fs.msgpack_serialize(tree)


def test_key_order_does_not_change_the_bytes():
    a = {"b": {"y": np.ones(2, np.float32), "x": 1}, "a": np.zeros(3)}
    b = {"a": np.zeros(3), "b": {"x": 1, "y": np.ones(2, np.float32)}}
    assert fm.msgpack_serialize(a) == fm.msgpack_serialize(b) \
        == fs.msgpack_serialize(a)


def _assert_same(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, torch.Tensor)) or (
            isinstance(want, np.generic) and isinstance(got, torch.Tensor)):
        assert _bits(got) == _bits(want), path
    elif isinstance(want, np.generic):
        assert type(got) is type(want) and _bits(got) == _bits(want), path
    else:
        assert type(got) is type(want) and got == want, path


def test_port_decodes_flaxs_bytes_bitwise():
    tree = mixed_tree()
    blob = fs.msgpack_serialize(tree)
    got = fm.msgpack_restore(blob)
    _assert_same(got, fs.msgpack_restore(blob))
    # views of the blob where aligned, and one copy where not
    assert isinstance(got["params"]["float32"]["w"], torch.Tensor)
    # and re-encoding gives the blob again
    assert fm.msgpack_serialize(got) == blob


def test_flax_decodes_the_ports_bytes_bitwise():
    tree = mixed_tree()
    back = fs.msgpack_restore(fm.msgpack_serialize(jax.tree.map(
        lambda x: _to_torch(x) if isinstance(x, np.ndarray) else x, tree)))
    _assert_same(back, fs.msgpack_restore(fs.msgpack_serialize(tree)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_chunked_arrays_both_ways(monkeypatch, dtype):
    """``MAX_CHUNK_SIZE`` lowered to 64 bytes in both modules: a 100-byte
    or larger array is chunked the same way; each side decodes the
    other's chunks to the whole array."""
    from flax import serialization
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", 64)
    big = _array(dtype, (10, 7))
    tree = {"a": {"big": big, "small": _array(dtype, (3,))},
            "top": _array(dtype, (130,))}
    blob = fs.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    assert fm.msgpack_serialize(tree) == blob
    assert fm.msgpack_serialize(jax.tree.map(_to_torch, tree)) == blob
    got = fm.msgpack_restore(blob)
    _assert_same(got, tree)
    _assert_same(fs.msgpack_restore(fm.msgpack_serialize(got)), tree)


@pytest.fixture()
def saved(tmp_path):
    like = {"block_0": {"attn": {"q": {"kernel": torch.zeros(4, 2, 3)}}},
            "embed": torch.zeros(16, 4, dtype=torch.bfloat16)}
    tree = {"block_0": {"attn": {"q": {"kernel": torch.randn(4, 2, 3)}}},
            "embed": torch.randn(16, 4).to(torch.bfloat16)}
    path = str(tmp_path / "w.msgpack")
    save_weights(path, tree)
    return path, tree, like


@pytest.mark.parametrize("manifest", [True, False])
@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_damaged_blob_is_a_corrupt_error(saved, damage, manifest):
    path, _, like = saved
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    if damage == "truncate":
        blob = blob[: len(blob) - 37]
    else:
        blob[3] ^= 0xff              # a map header byte: unparseable
    with open(path, "wb") as f:
        f.write(blob)
    if not manifest:
        os.remove(path + ".manifest.json")
    with pytest.raises(CheckpointCorruptError) as e:
        load_weights(path, like)
    assert e.value.path == path and e.value.nbytes == len(blob)


def test_shape_or_dtype_mismatch_is_a_value_error(saved):
    path, tree, like = saved
    got = load_weights(path, like)
    _assert_same(got, tree)
    wrong = {**like, "embed": torch.zeros(16, 5, dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match=r"embed: checkpoint \(16, 4\)"):
        load_weights(path, wrong)
    wrong = {**like, "embed": torch.zeros(16, 4)}
    with pytest.raises(ValueError, match="embed: checkpoint dtype bfloat16"):
        load_weights(path, wrong)


@pytest.mark.parametrize("blob,match", [
    (b"\x81\xa1a", "truncated"),
    (b"\xc0\xc0", "trailing"),
    (b"\xc1", "format byte"),
    (b"\xd4\x09\x00", "ext type 9"),
    (fs.msgpack_serialize({"a": np.zeros(2, ml_dtypes.int4)}),
     "dtype 'int4'"),
])
def test_malformed_blobs_raise(blob, match):
    with pytest.raises(ValueError, match=match):
        fm.msgpack_restore(blob)
