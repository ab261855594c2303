"""The port stands alone, runs on the card unless asked otherwise, and
never falls back quietly.

* No module of ``dtdl_tpu_torch`` (nor ``chip_smoke.py``) imports jax,
  flax, optax or anything of ``dtdl_tpu``: an AST scan of every import.
* With no CUDA device, the entry points given no device raise
  :class:`NoCudaDeviceError`; ``device="cpu"`` is the only way onto the
  CPU.
* The kernel wrappers take the plain version only for CPU tensors: no
  ``try`` around a launch, another device raises, and a CPU call counts
  no launch.  A missing nvcc raises a named build error.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import dtdl_tpu_torch
from dtdl_tpu_torch import bridge, kernels
from dtdl_tpu_torch.device import NoCudaDeviceError, resolve_device
from dtdl_tpu_torch.models.transformer import generate, transformer_lm
from dtdl_tpu_torch.ops.attention import flash_bwd, flash_fwd, rope_rotate
from dtdl_tpu_torch.ops.paged_attention import kv_splits, paged_attention
from dtdl_tpu_torch.serve.draft import ModelDraft
from dtdl_tpu_torch.serve.engine import InferenceEngine
from dtdl_tpu_torch.serve.scheduler import Scheduler

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dtdl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dtdl_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    assert PKG / "serve" / "draft.py" in files
    for name in ("__init__.py", "core.py", "layers.py"):
        assert PKG / "quant" / name in files
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_kernel_wrappers_have_no_fallback_path():
    """No try/except anywhere a kernel is launched or built."""
    for rel in ("ops/attention.py", "ops/paged_attention.py",
                "kernels/__init__.py"):
        tree = ast.parse((PKG / rel).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], rel


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_run_without_a_card(no_cuda):
    with pytest.raises(NoCudaDeviceError):
        resolve_device()
    with pytest.raises(NoCudaDeviceError):
        resolve_device("cuda")
    with pytest.raises(NoCudaDeviceError):
        transformer_lm("tiny")
    model = transformer_lm("tiny", device="cpu", dtype=torch.float32)
    with pytest.raises(NoCudaDeviceError):
        InferenceEngine(model, n_slots=2, page_size=16)
    engine = InferenceEngine(model, n_slots=2, page_size=16, device="cpu")
    with pytest.raises(NoCudaDeviceError):
        Scheduler(engine)
    Scheduler(engine, device="cpu")
    with pytest.raises(NoCudaDeviceError):
        bridge.load_flax_params(model, bridge.state_dict_to_flax(model))
    bridge.load_flax_params(model, bridge.state_dict_to_flax(model),
                            device="cpu")
    # generate and the model draft run where the model was put by name
    assert generate(model, np.zeros((1, 3), np.int32), 2).device.type == "cpu"
    assert ModelDraft(model).propose(np.arange(4), 2).size == 2
    assert dtdl_tpu_torch.NoCudaDeviceError is NoCudaDeviceError


def test_cpu_calls_take_the_plain_version_and_count_nothing():
    kernels.reset_launches()
    q = torch.randn(1, 1, 1, 16)
    pool = torch.randn(3, 1, 8, 16)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    paged_attention(q, pool, pool, table, torch.tensor([3]),
                    torch.tensor([True]), scale=0.25)
    x = torch.randn(2, 8, 16)
    _, lse = flash_fwd(x, x, x, None, scale=0.25, causal=True)
    flash_bwd(x, x, x, x, lse, lse, None, scale=0.25, causal=True)
    rope_rotate(x, x[0], x[0])
    assert kernels.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                "flash_bwd_dkv": 0, "rope_rows": 0,
                                "paged_attention": 0}


def test_other_devices_raise():
    q = torch.empty(1, 1, 1, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_attention(q, q, q, q, q, q, scale=1.0)
    x = torch.empty(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_fwd(x, x, x, None, scale=1.0, causal=True)
    lse = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_bwd(x, x, x, x, lse, lse, None, scale=1.0, causal=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        rope_rotate(x, x[0], x[0])


def test_build_without_nvcc_raises_by_name(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels, "_NVCC_FALLBACK", str(tmp_path / "nvcc"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(kernels.KernelBuildError, match="nvcc"):
        kernels.build()


def test_build_digest_tracks_the_sources(monkeypatch, tmp_path):
    """The library is rebuilt when a source changes: the digest covers
    every .cu/.cuh in csrc/ and the flags."""
    for src in kernels.CSRC.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = kernels.source_digest()
    with open(tmp_path / "attn_common.cuh", "a") as f:
        f.write("\n// changed\n")
    assert kernels.source_digest() != before
    assert {p.name for p in tmp_path.glob("*.cu")} == {
        "flash_bwd.cu", "flash_fwd.cu", "paged_attention.cu", "rope_rows.cu"}
    assert np.all([n in kernels.NVCC_FLAGS for n in
                   ("arch=compute_90a,code=sm_90a", "-O3")])


def test_kv_split_rule():
    """Decode on few (row, head) pairs splits the page walk so the blocks
    fill the card about four times over; a prefill with enough query tiles
    does not split; never more splits than pages."""
    assert kv_splits(8, 4, 1, 128, 132) == 17
    assert kv_splits(1, 4, 1024, 128, 132) == 1
    assert kv_splits(1, 1, 1, 3, 132) == 3
    assert kv_splits(64, 8, 1, 128, 132) == 1
